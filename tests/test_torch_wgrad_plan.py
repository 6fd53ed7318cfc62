"""The conv3x3 weight-gradient kernel's index algebra on the CPU.

csrc/conv3x3_wgrad.cu runs only on the card. Its geometry comes from the
planner in rangedet_tpu_torch/ops/conv3x3.py (row pitch Wp, chunk decode,
shifted A and G box coordinates, splits and their chunk ranges); here a
torch emulation of the kernel's tile loop is driven by that real plan: the
prologue's operands (a' at pitch Wp, its pad columns poisoned since the
tensor map's W extent is the true W and they must never be read; g'
transposed to (B, H, W, Cp) so the dx shift falls on an outer dimension),
TMA boxes with zero fill outside the extents and no unaligned innermost
coordinate, 9 taps x 64 x 64 f32 tiles, ragged channels masked at the
store, and the S partials summed in order.
It must equal the plain version within f32 round-off, and in one case the
JAX package's Pallas kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rangedet_tpu.ops import conv_pallas
from rangedet_tpu_torch.ops import conv3x3 as conv
from rangedet_tpu_torch.tools.profile_wgrad import STEP_SHAPES

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

BOX = conv.WGRAD_BOX_W
TILE = conv.WGRAD_TILE
# the same f32 products (bf16 x bf16 is exact in f32) summed in another
# order over at most a few thousand terms: max|a - b| <= 1e-5 max|b|
SUM_TOL = 1e-5


def tma_box(t, coords, extent):
    """A TMA tile load from t (B, H, d1, p0) seen as the 4-D map (d0, d1,
    H, B) whose innermost extent is d0 = extent <= p0: a 64 x 64 box
    (d1 rows of d0 columns) at coords (c0, c1, h, b), innermost first,
    zeros wherever a coordinate falls outside its extent. The innermost
    coordinate must start on 16 bytes (8 bf16)."""
    c0, c1, h, b = coords
    assert c0 % 8 == 0, "TMA faults on an unaligned innermost coordinate"
    B, H, d1, _ = t.shape
    out = torch.zeros(TILE, BOX, dtype=t.dtype)
    if not (0 <= h < H and 0 <= b < B):
        return out
    s0, e0 = max(c0, 0), min(c0 + BOX, extent)
    s1, e1 = max(c1, 0), min(c1 + TILE, d1)
    if s0 < e0 and s1 < e1:
        out[s1 - c1:e1 - c1, s0 - c0:e0 - c0] = t[b, h, s1:e1, s0:e0]
    return out


def operands(plan, x, gy, scale, bias, cot):
    """The prologue's outputs: a' at pitch Wp with NaN in the pad columns
    (the kernel writes 0 there; the tensor map's W extent is the true W,
    so they are never read), or x itself where the plan reads it in place;
    and g' transposed to (B, H, W, Cp) with NaN in the pad channels (read,
    but only into output channels that are masked at the store)."""
    a = x
    if plan.copy_a:
        a = F.pad(conv.ingest_plain(x, scale, bias).float(),
                  (0, plan.Wp - plan.W), value=float("nan")).bfloat16()
    else:
        assert scale is None and plan.W % 8 == 0 and plan.Wp == plan.W
    g = conv.cot_plain(gy, cot).float().permute(0, 1, 3, 2)
    g = F.pad(g, (0, plan.Cp - plan.Co), value=float("nan")).bfloat16()
    assert plan.Cp % TILE == 0 and plan.Co <= plan.Cp
    return a, g.contiguous()


def wgrad_emulated(plan, a, g):
    """The kernel's tile loop: per split, per (ci, co) tile, per chunk of
    the split's range, three A boxes (ci x pixels) and three G boxes
    (pixels x co) and 9 tile products; then the partials added in split
    order."""
    Ci, Co, W = plan.Ci, plan.Co, plan.W
    parts = torch.zeros(plan.splits, 9, Ci, Co)
    for s in range(plan.splits):
        lo, hi = plan.split_range(s)
        for ti in range(plan.ci_tiles):
            for to in range(plan.co_tiles):
                ci0, co0 = ti * TILE, to * TILE
                acc = torch.zeros(3, 3, TILE, TILE)
                for c in range(lo, hi):
                    A = [tma_box(a, plan.a_box(c, dy, ci0), W).float()
                         for dy in range(3)]
                    G = [tma_box(g, plan.g_box(c, dx, co0), plan.Cp).float()
                         for dx in range(3)]
                    for dy in range(3):
                        for dx in range(3):
                            acc[dy, dx] += A[dy] @ G[dx]
                nci, nco = min(TILE, Ci - ci0), min(TILE, Co - co0)
                parts[s, :, ci0:ci0 + nci, co0:co0 + nco] = \
                    acc.reshape(9, TILE, TILE)[:, :nci, :nco]
    dw = parts[0].clone()
    for s in range(1, plan.splits):
        dw += parts[s]
    return dw.reshape(3, 3, Ci, Co)


def inputs(seed, B, H, Ci, W, Co, ingest, cot):
    r = np.random.RandomState(seed)

    def bf(*shape):
        return torch.from_numpy(r.randn(*shape).astype(np.float32)).bfloat16()

    x, gy = bf(B, H, Ci, W), bf(B, H, Co, W)
    scale = bias = cots = None
    if ingest:
        scale = torch.from_numpy((1 + 0.3 * r.randn(Ci)).astype(np.float32))
        bias = torch.from_numpy((0.2 * r.randn(Ci)).astype(np.float32))
    if cot:
        cots = (bf(B, H, Co, W),
                torch.from_numpy((0.1 * r.randn(Co)).astype(np.float32)),
                torch.from_numpy((0.05 * r.randn(Co)).astype(np.float32)))
    return x, gy, scale, bias, cots


# (B, H, Ci, W, Co, ingest, cot, sms): W % 8 != 0 (70, 166), W not a
# multiple of 64 (70, 136, 166), ragged Ci (8, 24, 72: two ci tiles) and
# Co (40, 72), S >= 2 in every case, each ingest / cot combination
CASES = [
    (1, 3, 8, 70, 16, False, False, 5),
    (2, 2, 24, 128, 40, True, False, 3),
    (1, 3, 72, 136, 24, False, True, 7),
    (1, 2, 24, 166, 72, True, True, 4),
]


@pytest.mark.parametrize("B,H,Ci,W,Co,ingest,cot,sms", CASES)
def test_emulated_tile_loop_matches_plain(B, H, Ci, W, Co, ingest, cot,
                                          sms):
    x, gy, scale, bias, cots = inputs(1, B, H, Ci, W, Co, ingest, cot)
    plan = conv.plan_wgrad(B, H, Ci, W, Co, ingest, sms=sms)
    assert plan.splits >= 2
    got = wgrad_emulated(plan, *operands(plan, x, gy, scale, bias, cots))
    want = conv.conv3x3_wgrad_plain(x, gy, scale, bias, cots)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= SUM_TOL * want.abs().max()


def test_emulated_tile_loop_matches_the_pallas_kernel():
    B, H, Ci, W, Co = 1, 4, 24, 70, 40
    x, gy, scale, bias, cots = inputs(2, B, H, Ci, W, Co, True, True)
    plan = conv.plan_wgrad(B, H, Ci, W, Co, True, sms=3)
    got = wgrad_emulated(plan, *operands(plan, x, gy, scale, bias, cots))

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)

    want = conv_pallas._conv3x3_wgrad(
        j(x), j(gy), interpret=True, in_scale=j(scale), in_bias=j(bias),
        cot_adjust=tuple(j(t) for t in cots))
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    assert want.shape == got.shape
    assert (got - want).abs().max() <= SUM_TOL * want.abs().max()


@pytest.mark.parametrize("Ci,Co,W,ingest,cot,n", STEP_SHAPES)
def test_plan_of_the_step_shapes(Ci, Co, W, ingest, cot, n):
    """One wave on 132 SMs, the split ranges tile the chunks in order, the
    pitches are whole 16-byte units, and a' is copied where its rows are
    not (W = 166, 332) or it needs the ingest."""
    plan = conv.plan_wgrad(2, 64, Ci, W, Co, ingest)
    tiles = plan.ci_tiles * plan.co_tiles
    assert tiles * plan.splits <= 132 and plan.splits >= 1
    assert plan.splits * tiles > 132 // 2  # at least half the SMs busy
    ranges = [plan.split_range(s) for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.chunks
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges,
                                                           ranges[1:]))
    assert plan.Wp % 8 == 0 and plan.W <= plan.Wp < plan.W + 8
    assert plan.Cp % 64 == 0 and Co <= plan.Cp < Co + 64
    assert plan.copy_a == (ingest or W % 8 != 0)
    # the last chunk of a row reaches past W; its columns come from the
    # box's zero fill, not from the next row
    assert plan.chunk_origin(plan.nwc - 1)[2] + BOX >= W
    assert plan.chunk_origin(plan.chunks - 1) == (1, 63, (plan.nwc - 1) * BOX)
