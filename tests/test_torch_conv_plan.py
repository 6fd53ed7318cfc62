"""The conv3x3 forward/dgrad kernel's index algebra on the CPU.

csrc/conv3x3_bhcw.cu runs only on the card. Its geometry comes from the
planner in rangedet_tpu_torch/ops/conv3x3.py (plan_conv: a' width and
channel pitch, tiles, the K-step decode, box coordinates, scratch rows) and
its packed weight from pack_weight; here a torch emulation of the kernel is
driven by that real plan: the prologue's a' (ingest, transposed to
(B, H, Wq, Cp), phase-packed at stride 2, its pad channels poisoned since
the tensor maps' channel extent is the true count and they must never be
read), TMA boxes with zero fill outside the extents and no unaligned
innermost coordinate, the warpgroups' tiles of the block, the masked
epilogue (plain, stats, bwd) and the per-block sums added in row order.
It must equal the plain versions within one bf16 rounding and f32
round-off, and in two cases the JAX package's Pallas kernel in interpret
mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rangedet_tpu.ops import conv_pallas
from rangedet_tpu_torch.ops import conv3x3 as conv
from rangedet_tpu_torch.tools.profile_conv import (
    DGRAD_SHAPES,
    SERVE_SHAPES,
    TRAIN_SHAPES,
)

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

KB = conv.CONV_KB
# both accumulate in f32 and round once to bf16 (tests/test_torch_conv3x3.py)
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-2
# f32 sums of the same terms in another order: max|a - b| <= 1e-5 max|b|
SUM_TOL = 1e-5


def tma_box(t, coords, extent, rows):
    """A TMA tile load from t (d3, d2, d1, p0), seen as the 4-D map (d0,
    d1, d2, d3) whose innermost extent is d0 = extent <= p0: a box of
    ``rows`` d1 rows x 64 d0 columns at coords (c0, c1, c2, c3), innermost
    first, zeros wherever a coordinate falls outside its extent. The
    innermost coordinate must start on 16 bytes (8 bf16)."""
    c0, c1, c2, c3 = coords
    assert c0 % 8 == 0, "TMA faults on an unaligned innermost coordinate"
    D3, D2, D1, _ = t.shape
    out = torch.zeros(rows, KB, dtype=torch.float32)
    if not (0 <= c2 < D2 and 0 <= c3 < D3):
        return out
    s0, e0 = max(c0, 0), min(c0 + KB, extent)
    s1, e1 = max(c1, 0), min(c1 + rows, D1)
    if s0 < e0 and s1 < e1:
        out[s1 - c1:e1 - c1, s0 - c0:e0 - c0] = t[c3, c2, s1:e1, s0:e0]
    return out


def prologue(plan, x, scale, bias, cot):
    """ingest_t: a' (B, H, Wq, Cp) from x (B, H, Ci, W) with the ingest
    (affine or cot), phase-packed at stride 2; NaN in the pad channels."""
    a = conv.cot_plain(x, cot) if cot is not None else conv.ingest_plain(
        x, scale, bias)
    if plan.stride == 2:
        a = torch.cat([a[..., 0::2], a[..., 1::2]], dim=2)
    assert a.shape[2] == plan.Ce and a.shape[3] == plan.Wq
    a = F.pad(a.float().permute(0, 1, 3, 2), (0, plan.Cp - plan.Ce),
              value=float("nan"))
    assert plan.Cp % 8 == 0 and plan.Ce <= plan.Cp < plan.Ce + 8
    return a.bfloat16().contiguous()


def packed_weight(plan, w, flip):
    """pack_weight's (taps, Co, Cp) as the map (Ce, Co, taps, 1), with NaN
    in its pad channels (never read); with ``flip`` of flip_weight(w)."""
    wp = conv.pack_weight(w, plan, flip).float()
    assert tuple(wp.shape) == (plan.taps, plan.Co, plan.Cp)
    wp[..., plan.Ce:] = float("nan")
    return wp[None]


def conv_emulated(plan, x, w, scale=None, bias=None, cot=None, stats=False,
                  affine=None, flip=False):
    """The kernel: per tile (pixel tile, Co tile, b, h), per K-step, a
    weight box (bm x 64) and an activation box (bn x 64); each consumer
    warpgroup multiplies its part; then the masked epilogue and per-tile
    sums, and the rows of sums added in order."""
    a = prologue(plan, x, scale, bias, cot).float()
    wp = packed_weight(plan, w, flip)
    B, H, Co, Wq = plan.B, plan.H, plan.Co, plan.Wq
    y = torch.full((B, H, Co, Wq), float("nan"))
    part = torch.zeros(plan.part_rows, 2, Co)
    if affine is not None:
        xo, s, bb = (t.float() for t in affine)
    for tile in range(plan.ntiles):  # any order: no tile reads another
        wt, ct, bh = plan.tile_origin(tile)
        b, h = divmod(bh, H)
        u0, co0 = wt * plan.bn, ct * plan.bm
        acc = torch.zeros(plan.bm, plan.bn)
        for k in range(plan.ksteps):
            Wb = tma_box(wp, plan.w_box(k, co0), plan.Ce, plan.bm)
            Ab = tma_box(a, plan.a_box(k, b, h, u0), plan.Ce, plan.bn)
            for m0, n0, nw in plan.warpgroups():
                acc[m0:m0 + 64, n0:n0 + nw] += \
                    Wb[m0:m0 + 64] @ Ab[n0:n0 + nw].T
        nco = min(plan.bm, Co - co0)
        nu = min(plan.bn, Wq - u0)
        v = acc[:nco, :nu]
        cs = slice(co0, co0 + nco)
        us = slice(u0, u0 + nu)
        assert torch.isnan(y[b, h, cs, us]).all(), "each output once"
        if affine is not None:
            xv = xo[b, h, cs, us]
            z = xv * s[cs, None] + bb[cs, None]
            dz = torch.where(z > 0, v, torch.zeros_like(v))
            sums = ((dz * xv).sum(1), dz.sum(1))
            v = dz * s[cs, None]
        y[b, h, cs, us] = v.bfloat16().float()
        if stats:
            yv = y[b, h, cs, us]
            sums = (yv.sum(1), (yv * yv).sum(1))
        if stats or affine is not None:
            row = bh * plan.nwt + wt
            part[row, 0, cs], part[row, 1, cs] = sums
    assert not torch.isnan(y).any(), "every output written"
    y = y.bfloat16()
    if not (stats or affine is not None):
        return y
    tot = part[0].clone()
    for r in range(1, plan.part_rows):
        tot += part[r]
    return y, tot[0], tot[1]


def _bf(r, *shape, scale=1.0):
    return torch.from_numpy(
        (scale * r.randn(*shape)).astype(np.float32)).bfloat16()


def _f32(r, n, loc, scale):
    return torch.from_numpy((loc + scale * r.randn(n)).astype(np.float32))


def _close_bf16(got, want):
    err = (got.float() - want.float()).abs()
    assert (err <= BF16_RTOL * want.float().abs() + BF16_ATOL).all(), \
        err.max()


def _sums_close(got, want):
    g, w = got.double(), want.double()
    assert (g - w).abs().max() <= SUM_TOL * w.abs().max(), \
        ((g - w).abs().max(), w.abs().max())


# (B, H, Ci, W, Co, stride, ingest, stats): ragged Ci (8, 20: a poisoned
# pad, 72: two K-blocks), ragged W (70, 165, 166), ragged Co (16, 40, 72,
# 136), both tiles of Co > 64 (128 x 128 on rows < 512 pixels, 128 x 256
# on wider ones: 1040 at stride 2), stride 2 through the phase-packed
# operand, the deconvs' s*Co = 256 outputs
FWD_CASES = [
    (1, 3, 8, 70, 16, 1, False, False),
    (1, 3, 20, 166, 72, 1, True, True),
    (2, 2, 72, 165, 40, 1, True, False),
    (1, 3, 24, 164, 40, 2, True, True),
    (1, 2, 8, 1040, 136, 2, False, False),
    (1, 2, 16, 96, 256, 1, False, True),
]


@pytest.mark.parametrize("B,H,Ci,W,Co,stride,ingest,stats", FWD_CASES)
def test_emulated_forward_matches_plain(B, H, Ci, W, Co, stride, ingest,
                                        stats):
    r = np.random.RandomState(Ci + W)
    x = _bf(r, B, H, Ci, W)
    w = _bf(r, 3, 3, Ci, Co, scale=1 / (3 * Ci ** 0.5))
    scale = bias = None
    if ingest:
        scale, bias = _f32(r, Ci, 1.0, 0.3), _f32(r, Ci, 0.0, 0.2)
    plan = conv.plan_conv(B, H, Ci, W, Co, stride)
    got = conv_emulated(plan, x, w, scale, bias, stats=stats)
    want = conv.conv3x3_bhcw_plain(x, w, scale, bias, stride, stats)
    if not stats:
        _close_bf16(got, want)
        return
    _close_bf16(got[0], want[0])
    yd = got[0].double()  # the sums are of the stored bf16 y
    _sums_close(got[1], yd.sum((0, 1, 3)))
    _sums_close(got[2], (yd * yd).sum((0, 1, 3)))


# (B, H, Cgy, Cdx, W, cot, affine): every ingest / epilogue pair of the
# dgrad, ragged widths and channels as above
DGRAD_CASES = [
    (1, 3, 40, 24, 166, True, True),
    (2, 2, 72, 8, 70, True, False),
    (1, 3, 16, 136, 130, False, True),
    (1, 2, 24, 16, 64, False, False),
]


@pytest.mark.parametrize("B,H,Cg,Cx,W,cot,aff", DGRAD_CASES)
def test_emulated_dgrad_matches_plain(B, H, Cg, Cx, W, cot, aff):
    r = np.random.RandomState(Cg + Cx + W)
    gy = _bf(r, B, H, Cg, W)
    w = _bf(r, 3, 3, Cx, Cg, scale=1 / (3 * Cx ** 0.5))
    cots = affs = None
    if cot:
        cots = (_bf(r, B, H, Cg, W), _f32(r, Cg, 0, 0.1), _f32(r, Cg, 0, 0.05))
    if aff:
        affs = (_bf(r, B, H, Cx, W), _f32(r, Cx, 1, 0.3), _f32(r, Cx, 0, 0.2))
    plan = conv.plan_conv(B, H, Cg, W, Cx, 1)
    got = conv_emulated(plan, gy, w, cot=cots, affine=affs, flip=True)
    want = conv.conv3x3_dgrad_plain(gy, w, cots, affs)
    if not aff:
        _close_bf16(got, want)
        return
    _close_bf16(got[0], want[0])
    _sums_close(got[1], want[1])
    _sums_close(got[2], want[2])


@pytest.mark.parametrize("Cx,Cg", [(24, 40), (8, 72), (136, 16)])
def test_flipped_packing_is_the_packing_of_the_flipped_weight(Cx, Cg):
    w = _bf(np.random.RandomState(Cx), 3, 3, Cx, Cg)
    plan = conv.plan_conv(1, 2, Cg, 70, Cx, 1)
    assert torch.equal(conv.pack_weight(w, plan, flip=True),
                       conv.pack_weight(conv.flip_weight(w), plan))


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _np(t):
    return torch.from_numpy(np.array(t, dtype=np.float32))


def test_emulated_forward_matches_the_pallas_kernel():
    """BN ingest + stats. The sums are of each side's own stored bf16 y,
    which may lie one bf16 rounding (2^-8 |y|) apart, so they agree within
    2^-8 sum|y| (and 2^-7 sum y^2)."""
    B, H, Ci, W, Co = 1, 4, 24, 70, 40
    r = np.random.RandomState(3)
    x = _bf(r, B, H, Ci, W)
    w = _bf(r, 3, 3, Ci, Co, scale=1 / (3 * Ci ** 0.5))
    scale, bias = _f32(r, Ci, 1.0, 0.3), _f32(r, Ci, 0.0, 0.2)
    plan = conv.plan_conv(B, H, Ci, W, Co, 1)
    y, s1, s2 = conv_emulated(plan, x, w, scale, bias, stats=True)
    wy, ws1, ws2 = conv_pallas._conv3x3_fwd(
        _j(x), _j(w), interpret=True, in_scale=_j(scale), in_bias=_j(bias),
        stats=True)
    _close_bf16(y, _np(wy))
    yf = y.float()
    assert ((s1 - _np(ws1).reshape(-1)).abs()
            <= 2.0 ** -8 * yf.abs().sum((0, 1, 3)) + 1e-4).all()
    assert ((s2 - _np(ws2).reshape(-1)).abs()
            <= 2.0 ** -7 * (yf * yf).sum((0, 1, 3)) + 1e-4).all()


def test_emulated_dgrad_matches_the_pallas_kernel():
    """cot_adjust ingest + bwd_affine epilogue (conv_pallas.py:637-640)."""
    B, H, Cg, Cx, W = 1, 4, 40, 24, 70
    r = np.random.RandomState(4)
    gy = _bf(r, B, H, Cg, W)
    w = _bf(r, 3, 3, Cx, Cg, scale=1 / (3 * Cx ** 0.5))
    cots = (_bf(r, B, H, Cg, W), _f32(r, Cg, 0, 0.1), _f32(r, Cg, 0, 0.05))
    affs = (_bf(r, B, H, Cx, W), _f32(r, Cx, 1, 0.3), _f32(r, Cx, 0, 0.2))
    plan = conv.plan_conv(B, H, Cg, W, Cx, 1)
    dx, dscale, dbias = conv_emulated(plan, gy, w, cot=cots, affine=affs,
                                      flip=True)
    w_flip = jnp.transpose(_j(w)[::-1, ::-1], (0, 1, 3, 2))
    wdx, wds, wdb = conv_pallas._conv3x3_fwd(
        _j(gy), w_flip, interpret=True,
        bwd_affine=tuple(_j(t) for t in affs),
        cot_adjust=tuple(_j(t) for t in cots))
    _close_bf16(dx, _np(wdx))
    _sums_close(dscale, _np(wds).reshape(-1))
    _sums_close(dbias, _np(wdb).reshape(-1))


def _check_plan(plan, ingest_channels):
    """Invariants the kernel relies on."""
    assert plan.bm in (64, 128) and plan.bn in (128, 256)
    assert (plan.bm, plan.bn) != (64, 128)  # the three built tiles
    assert plan.Cp % 8 == 0 and plan.Ce <= plan.Cp < plan.Ce + 8
    assert plan.nwt * plan.bn >= plan.Wq > (plan.nwt - 1) * plan.bn
    assert plan.co_tiles * plan.bm >= plan.Co > (plan.co_tiles - 1) * plan.bm
    assert plan.part_rows == plan.B * plan.H * plan.nwt
    # the tiles decode to every (pixel tile, Co tile, row) once
    origins = {plan.tile_origin(t) for t in range(plan.ntiles)}
    assert len(origins) == plan.ntiles == (
        plan.nwt * plan.co_tiles * plan.B * plan.H)
    assert plan.tile_origin(plan.ntiles - 1) == (
        plan.nwt - 1, plan.co_tiles - 1, plan.B * plan.H - 1)
    assert plan.B * plan.H <= 65535
    # the K-steps visit each (tap, channel block) of the packed weight
    # once, dy-major, and every block of channels the weight holds
    seen = [plan.k_step(k) for k in range(plan.ksteps)]
    assert len(set(seen)) == plan.ksteps
    assert [s[0] for s in seen] == sorted(s[0] for s in seen)
    for dy in range(3):
        for dx in range(plan.dx0, 3):
            blocks = {cb for (a, b, cb, _) in seen if (a, b) == (dy, dx)}
            n = plan.kc2 if dx == 2 else plan.kc
            assert blocks == set(range(n))
    assert {t for *_, t in seen} == set(range(plan.taps))
    # channel blocks cover the channels the tap's weight is nonzero on
    assert plan.kc * KB >= plan.Ce and plan.kc2 * KB >= ingest_channels
    for k in range(plan.ksteps):
        assert plan.w_box(k, 0)[0] % 8 == 0
        assert plan.a_box(k, 0, 0, 0)[0] % 8 == 0
    # wgmma tiles: two warpgroups of 64 rows x a multiple of 128 pixels,
    # together exactly the block's tile
    cells = set()
    for m0, n0, nw in plan.warpgroups():
        assert nw % 128 == 0
        cells |= {(m0 + i, n0 + j) for i in (0, 63) for j in (0, nw - 1)}
    assert max(c[0] for c in cells) == plan.bm - 1
    assert max(c[1] for c in cells) == plan.bn - 1
    # the stage (weight box + activation box) and a ring of >= 4 fit
    stage = (plan.bm + plan.bn) * KB * 2
    assert min(6, 196608 // stage) >= 4


@pytest.mark.parametrize("shapes", ["serve", "train", "dgrad"])
def test_plan_of_the_step_shapes(shapes):
    """Every conv shape of the B=1 eval forward and of the B=2 train step
    (forward and dgrad, H = 64): the planner's invariants, the launches
    summing to the model's 77 / 77 / 76, and the tile it picks for the
    head towers' 128 -> 128 convs."""
    rows = {"serve": SERVE_SHAPES, "train": TRAIN_SHAPES,
            "dgrad": DGRAD_SHAPES}[shapes]
    assert sum(row[-1] for row in rows) == (76 if shapes == "dgrad" else 77)
    B = 1 if shapes == "serve" else 2
    for row in rows:
        Ci, Co, W = row[:3]
        stride = 1 if shapes == "dgrad" else row[3]
        plan = conv.plan_conv(B, 64, Ci, W, Co, stride)
        _check_plan(plan, Ci)
        if stride == 2:
            assert (plan.Ce, plan.Wq, plan.dx0) == (2 * Ci, W // 2, 1)
            # 6 of the 9 taps, the odd half of column dx=2 skipped: the
            # K-steps of the stride-1 conv on Ci channels
            assert plan.ksteps == 9 * -(-Ci // 64) and Ci % 64 == 0
        if Co == 128 and Ci == 128 and stride == 1:
            assert plan.bm == 128
            assert plan.bn == (256 if W >= 512 else 128)
