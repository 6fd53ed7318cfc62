"""The tensor-core Meta-Kernel kernels' index algebra and numerics on the CPU.

csrc/meta_block.cu (the forward kernel in its three modes: meta_stats,
meta_agg, the eval taps; and the block backward) runs only on the card.
Its geometry comes from the planner in rangedet_tpu_torch/ops/meta_block.py
(plan_meta: 64-pixel chunks, the backward's output chunks over rows -1 .. H
and columns -8 .. W, TMA box coordinates that start on 16 bytes, the tap
order, the blocks' chunk ranges and the order of the partials) and its f32
operands go to the tensor cores as split_bf16's exact three-term splits.
Here a torch emulation of the kernels' loops is driven by that real plan:
TMA boxes with zero fill outside the image, per tap the one-pixel shifts as
offsets into the boxes, every contraction as a sum of products of bf16
split terms accumulated in f32 (dW1 from six cross products, db1 from the
ones row), the forward's plain-order wt near bf16 rounding boundaries, the
stats' masked columns, the taps' stores clipped at W, the masked sources,
dfeat added in tap order per output chunk, per-block partials added in
block order. At C = 128 (Co = 128) the plan's channel groups as well:
meta_agg's blocks walk each chunk's two groups into one y, the other
kernels' blocks take one group each, and their partials are added per
group in block order. It must equal the plain versions at both widths the
kernels are built for (C = 64, Cm = 32, Co = 64 and C = 128, Cm = 32, Co =
128) and, in one case each, the JAX package's Pallas kernels in interpret
mode; and the three forward modes form one tap product a.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangedet_tpu.ops import meta_block_pallas as jmb
from rangedet_tpu.ops.meta_kernel_pallas import meta_kernel_fused
from rangedet_tpu_torch.ops import meta_block as mb
from rangedet_tpu_torch.ops import meta_kernel as mk

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

C, CM, CO = 64, 32, 64
# y and dfeat: both sides accumulate in f32 and round once to bf16
# (chip_smoke's gate): |got - ref| <= 2^-6 |ref| + 1e-3 max|ref|
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-3
# the taps against the Pallas kernel of meta_kernel_pallas.py, which rounds
# rel and h to bf16: tests/test_torch_meta_kernel.py's BF16_TOL (JAX's own
# bound between that kernel and the XLA form), |a - b| <= TAPS_TOL (1 +
# |b|); where the Pallas kernel's own roundings put it outside (at this
# file's coordinate and MLP scales), the emulation must be the nearer of
# the two to the f32 plain version, chip_smoke [7]'s rule
TAPS_TOL = 4e-2
# f32 sums: chip_smoke's F32_SUM_TOL. The tap product a = bf16(nb * wt) is
# rounded mid-way, so a wt summed in another f32 order moves a few a by one
# bf16 ulp, and the sums that see a (dA, ds9) move with them
SUM_TOL = 1e-3
SHAPES = [(1, 1, 70), (2, 3, 130), (1, 4, 257)]


def _inputs(seed, B, H, W, C=C, CO=CO):
    r = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return torch.from_numpy((scale * r.standard_normal(shape))
                                .astype(np.float32))

    return dict(
        feat=n(B, H, C, W).bfloat16(), cb=n(B, H, 3, W, scale=3.0).bfloat16(),
        w0=n(3, CM, scale=0.6), b0=n(CM, scale=0.1), w1=n(CM, C, scale=0.2),
        b1=n(C, scale=0.1), s9=1.0 + n(9 * C, scale=0.3),
        b9=n(9 * C, scale=0.2), agg=n(9 * C, CO, scale=1 / 24).bfloat16(),
        gy=n(B, H, CO, W).bfloat16(), c1=n(9 * C, scale=1e-3),
        c2=n(9 * C, scale=1e-4))


def _mlp(x):
    """The MLP weights as the kernels see them: bf16 values in f32."""
    return [x[k].bfloat16().float() for k in ("w0", "b0", "w1", "b1")]


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp(min=1e-30)).item()


def _bf16_ok(got, ref):
    err = (got.float() - ref).abs()
    return bool((err <= BF16_RTOL * ref.abs()
                 + BF16_ATOL * ref.abs().max()).all())


# ------------------------------------------------------------ emulation
def tma_box(t, W, b, col, row, rows, width):
    """A TMA box of t (B, H, X, pitch) whose W extent is W: rows row ..
    row+rows-1 of image b, all X, columns col .. col+width-1, zeros outside
    the image. The column must start on 16 bytes (8 bf16)."""
    assert col % 8 == 0, "TMA faults on an unaligned innermost coordinate"
    H, X = t.shape[1], t.shape[2]
    out = torch.zeros(rows, X, width)
    for i in range(rows):
        h = row + i
        if not 0 <= h < H:
            continue
        s0, e0 = max(col, 0), min(col + width, W)
        if s0 < e0:
            out[i, :, s0 - col:e0 - col] = t[b, h, :, s0:e0].float()
    return out


def split_mm(x, w):
    """x (f32) @ w (bf16 values) as the tensor cores take it: the three
    split terms of x, each product exact, summed in f32."""
    acc = None
    for t in mb.split_bf16(x):
        p = t.float() @ w
        acc = p if acc is None else acc + p
    return acc


def exact_wt(h1, w1, b1, nb):
    """meta_agg's wt: the tensor cores' sum, but the plain version's sum
    where nb * wt lies within the margin of a bf16 rounding boundary; and
    a = bf16(nb * wt)."""
    wt = split_mm(h1, w1) + b1
    mag = mb.split_bf16(h1)[0].float() @ w1.abs()
    p = nb * wt
    d = mb.NEAR_TIE * 1.01 * nb.abs() * mag + p.abs() * 2.0 ** -22
    near = (p - d).bfloat16() != (p + d).bfloat16()
    wt = torch.where(near, h1 @ w1 + b1, wt)
    return wt, (nb * wt).bfloat16().float()


def hidden(rel, w0, b0):
    h = w0[0] * rel[:, 0:1]
    h = h + w0[1] * rel[:, 1:2]
    h = h + w0[2] * rel[:, 2:3]
    return torch.relu(h + b0)


def _by_group(plan, parts, local):
    """The kernels' reduction of per-block partials: the sum over the
    blocks of each group, in block order, of the group's channels (the
    last axis of each ``local`` partial, GROUP wide), laid out at C; and
    over every block, in block order, of the others."""
    out = []
    for i in range(len(parts[0][1])):
        if i not in local:
            out.append(sum(p[i] for _, p in parts))
            continue
        out.append(torch.cat([
            sum(p[i] for g, p in parts if g == grp)
            for grp in range(plan.groups)], dim=-1))
    return out


def emulate_fwd(x, kind, blocks):
    """The forward kernel's loop in mode ``kind``: "agg" -> y (B, H, CO,
    W); "stats" -> (sum a, sum a^2), each (9C,); "taps" -> a (B, H, 9C, W).
    Also returns the tap products a the mode formed, (B, H, 9C, W). A
    block walks its units (chunk, channel group), taps inside; meta_agg's
    y adds the groups' products of a chunk in unit order."""
    feat, cb = x["feat"], x["cb"]
    B, H, C, W = feat.shape
    Co = x["agg"].shape[1]
    w0, b0, w1, b1 = _mlp(x)
    A = x["agg"].float().view(9, C, Co)
    plan = mb.plan_meta(kind, B, H, W, blocks, C)
    G = mb.GROUP
    fp = torch.zeros(B, H, C, plan.pitch, dtype=torch.bfloat16)
    fp[..., :W] = feat
    seen = torch.full((B, H, 9 * C, W), float("nan"))
    out = torch.full((B, H, Co, W), float("nan")) if kind == "agg" else seen
    parts = []
    m = torch.arange(mb.TQ)
    for blk in range(plan.blocks):
        part = torch.zeros(2, 9, G)
        units = plan.units(blk)
        for u, (ch, g) in enumerate(units):
            b, h, w0c = plan.chunk(ch)
            boxes = plan.boxes(ch)
            gs = slice(g * G, (g + 1) * G)
            fs = tma_box(fp[:, :, gs], W, b, *boxes["feat"])
            cs = tma_box(cb, W, b, *boxes["crd"])
            cen = cs[1][:, mb.HALO + m].T
            ok = w0c + m < W  # the chunk's columns inside the image
            if u == 0 or units[u - 1][0] != ch:
                y = torch.zeros(mb.TQ, Co)
            for t, (dy, dx) in enumerate(mb.TAPS):
                x0 = mb.HALO + m + dx - 1
                rel = cs[dy][:, x0].T - cen
                _, a = exact_wt(hidden(rel, w0, b0), w1[:, gs], b1[gs],
                                fs[dy][:, x0].T)
                sl = slice(t * C + g * G, t * C + (g + 1) * G)
                if kind == "agg":
                    z = a * x["s9"][sl] + x["b9"][sl]
                    y = y + split_mm(torch.relu(z), A[t][gs])
                elif kind == "stats":
                    part[0, t] += a[ok].sum(0)
                    part[1, t] += (a[ok] * a[ok]).sum(0)
                # the taps' TMA store writes the columns < W
                seen[b, h, sl, w0c + m[ok]] = a[ok].T
            if kind == "agg" and (u + 1 == len(units)
                                  or units[u + 1][0] != ch):
                out[b, h, :, w0c + m[ok]] = y[ok].T
        parts.append((plan.block_group(blk), (part,)))
    assert not seen.isnan().any() and not out.isnan().any()
    if kind == "stats":
        s, = _by_group(plan, parts, local={0})
        out = (s[0].reshape(-1), s[1].reshape(-1))
    return out, seen


def emulate_agg(x, blocks):
    return emulate_fwd(x, "agg", blocks)[0]


def emulate_bwd(x, mode, blocks):
    """The block backward: block i takes the channel group i % groups and
    its output chunks; each partial holds the group's rows of dA, ds9, db9
    and columns of dW1, db1, and a share of dW0, db0."""
    feat, cb = x["feat"], x["cb"]
    B, H, C, W = feat.shape
    Co = x["agg"].shape[1]
    G = mb.GROUP
    w0, b0, w1, b1 = _mlp(x)
    plan = mb.plan_meta("bwd", B, H, W, blocks, C)
    A = x["agg"].float().view(9, C, Co)
    e0, e1 = ((x["s9"], x["b9"]) if mode == "agg" else (x["c1"], x["c2"]))
    dfeat = torch.full((B, H, C, W), float("nan"))
    visits = torch.zeros(B, H, W, 9, plan.groups, dtype=torch.int64)
    m = torch.arange(mb.TQ)
    parts = []
    for blk in range(plan.blocks):
        begin, end = plan.block_range(blk)
        g = plan.block_group(blk)
        gsl = slice(g * G, (g + 1) * G)
        w1g, b1g, Ag = w1[:, gsl], b1[gsl], A[:, gsl]
        dA, ds9, db9 = (torch.zeros(9, Co, G), torch.zeros(9, G),
                        torch.zeros(9, G))
        dw0, db0 = torch.zeros(3, CM), torch.zeros(CM)
        dw1, db1 = torch.zeros(CM, G), torch.zeros(G)
        for ch in range(begin, end):
            b, hq, q0 = plan.chunk(ch)
            boxes = plan.boxes(ch)
            nb = tma_box(feat[:, :, gsl], W, b, *boxes["feat"])[0].T
            cs = tma_box(cb, W, b, *boxes["crd"])
            gs = tma_box(x["gy"], W, b, *boxes["gy"])
            q = q0 + m
            cq = cs[1][:, mb.HALO + m].T
            dfe = torch.zeros(mb.TQ, G)
            for t, (dy, dx) in enumerate(mb.TAPS):
                hs, srow, xs = hq - dy + 1, 2 - dy, mb.HALO + m + 1 - dx
                s = q + 1 - dx
                valid = (s >= 0) & (s < W) & (0 <= hs < H)
                if 0 <= hs < H:
                    visits[b, hs, s[valid], t, g] += 1
                rel = cq - cs[srow][:, xs].T
                h1 = hidden(rel, w0, b0)
                wt = split_mm(h1, w1g) + b1g
                a = (nb * wt).bfloat16().float()
                sl = slice(t * C + g * G, t * C + (g + 1) * G)
                if mode == "agg":
                    gys = gs[srow][:, xs].T  # (TQ, Co), bf16 values
                    dr = gys @ Ag[t].T
                    z = a * e0[sl] + e1[sl]
                    on = valid[:, None] & (z > 0)
                    dz = torch.where(on, dr, torch.zeros(()))
                    ds9[t] += (dz * a).sum(0)
                    db9[t] += dz.sum(0)
                    dA[t] += split_mm(torch.where(on, z, torch.zeros(())).T
                                      .contiguous(), gys).T
                    da = dz * e0[sl]
                else:
                    da = torch.where(valid[:, None], e0[sl] + e1[sl] * a,
                                     torch.zeros(()))
                dfe = dfe + da * wt
                dwt = da * nb
                dh = torch.where(h1 > 0, split_mm(dwt, w1g.T),
                                 torch.zeros(()))
                db0 += dh.sum(0)
                for j in range(3):
                    dw0[j] += (dh * rel[:, j:j + 1]).sum(0)
                # dW1^T = dwt^T [h1 | 1] from six cross products of splits
                ds, hsp = mb.split_bf16(dwt), mb.split_bf16(h1)
                for i, k in ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1)):
                    dw1 += (ds[i].float().T @ hsp[k].float()).T
                db1 += sum(d.float() for d in ds).sum(0)
            ok = (q >= 0) & (q < W)
            if 0 <= hq < H:
                dfeat[b, hq, gsl, q[ok]] = dfe[ok].T
        parts.append((g, (dA, ds9, db9, dw0, db0, dw1, db1)))
    # every (source, tap) pair of the image exactly once in each group,
    # every output once
    assert bool((visits == 1).all())
    assert not dfeat.isnan().any()
    dA, ds9, db9, dw0, db0, dw1, db1 = _by_group(plan, parts,
                                                 local={0, 1, 2, 5, 6})
    dA = dA.view(9, Co, C).transpose(1, 2)
    if mode == "agg":
        return (dfeat, dA.reshape(9 * C, Co), ds9.reshape(-1),
                db9.reshape(-1), dw0, db0, dw1, db1)
    return dfeat, dw0, db0, dw1, db1


# ----------------------------------------------------------------- tests
def test_split_reconstructs_f32_exactly():
    r = np.random.default_rng(0)
    x = r.standard_normal(4096).astype(np.float32) * np.float32(
        2.0) ** r.integers(-30, 30, 4096).astype(np.float32)
    # values at and next to bf16 rounding ties: a bf16 value plus half an
    # ulp, one f32 ulp either side of it
    base = torch.from_numpy(x).bfloat16().float()
    half = base.abs() * 2.0 ** -8
    ties = torch.cat([base + half, base - half])
    ties = torch.cat([ties, torch.nextafter(ties, ties + 1),
                      torch.nextafter(ties, ties - 1)])
    x = torch.cat([torch.from_numpy(x), ties, torch.tensor([0.0, -0.0])])
    terms = mb.split_bf16(x)
    assert all(t.dtype == torch.bfloat16 for t in terms)
    total = sum(t.double() for t in terms)
    assert torch.equal(total, x.double())
    # each term at most half an ulp of the one before
    for hi, lo in zip(terms, terms[1:]):
        assert bool((lo.double().abs() <= hi.double().abs() * 2.0 ** -8).all())


def test_split_products_sum_to_the_f32_product():
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.standard_normal((64, 96)).astype(np.float32))
    w = torch.from_numpy(r.standard_normal((96, 64)).astype(np.float32))
    w = w.bfloat16().float()
    exact = x.double() @ w.double()
    got = split_mm(x, w)
    # three f32 sums of 96 exact products, plus the two adds of the terms
    bound = 100 * 2.0 ** -24 * (x.double().abs() @ w.double().abs())
    assert bool(((got.double() - exact).abs() <= bound).all())


def test_exact_wt_takes_the_plain_sum_near_a_tie():
    r = np.random.default_rng(6)
    h1 = torch.from_numpy(r.standard_normal((4096, CM)).astype(np.float32))
    h1 = torch.relu(h1)
    w1 = torch.from_numpy((0.2 * r.standard_normal((CM, C))).astype(
        np.float32)).bfloat16().float()
    nb = torch.from_numpy(r.standard_normal((4096, C)).astype(
        np.float32)).bfloat16().float()
    b1 = torch.zeros(C)
    plain = h1 @ w1 + b1
    _, a = exact_wt(h1, w1, b1, nb)
    # the split sum alone rounds some a the other way (17 of 262144
    # here); with the margin every a is the plain version's
    a_tc = (nb * (split_mm(h1, w1) + b1)).bfloat16().float()
    a_plain = (nb * plain).bfloat16().float()
    assert bool((a_tc != a_plain).any())
    assert torch.equal(a, a_plain)


def test_plan_geometry():
    p = mb.plan_meta("bwd", 2, 64, 2656, 132)
    assert (p.nq, p.rows, p.chunks, p.pitch) == (42, 66, 2 * 66 * 42, 2656)
    assert p.chunk(0) == (0, -1, -8)
    assert p.chunk(p.chunks - 1) == (1, 64, 41 * 64 - 8)
    f = mb.plan_meta("agg", 1, 3, 70, 4)
    assert (f.nq, f.chunks, f.pitch) == (2, 6, 72)
    assert [f.block_range(i) for i in range(4)] == [(0, 1), (1, 3), (3, 4),
                                                    (4, 6)]
    for plan in (p, f):
        for ch in (0, 1, plan.chunks - 1):
            assert all(box[0] % 8 == 0 for box in plan.boxes(ch).values())
    # meta_stats and the taps walk meta_agg's chunks with its boxes
    for kind in ("stats", "taps"):
        k = mb.plan_meta(kind, 1, 3, 70, 4)
        assert (k.nq, k.chunks, k.pitch) == (f.nq, f.chunks, f.pitch)
        assert all(k.chunk(ch) == f.chunk(ch) and k.boxes(ch) == f.boxes(ch)
                   for ch in range(f.chunks))
    with pytest.raises(ValueError):
        mb.plan_meta("fwd", 1, 1, 8, 1)


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_meta_agg_matches_plain(shape):
    x = _inputs(2, *shape)
    got = emulate_agg(x, blocks=3)
    ref = mb.meta_agg_plain(x["feat"], x["cb"], *_mlp(x), x["s9"], x["b9"],
                            x["agg"], out_dtype=torch.float32)
    assert _bf16_ok(got.bfloat16(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_meta_stats_matches_plain(shape):
    x = _inputs(7, *shape)
    got, _ = emulate_fwd(x, "stats", blocks=3)
    ref = mb.meta_stats_plain(x["feat"], x["cb"], *_mlp(x))
    for g, r in zip(got, ref):
        assert _rel(g, r) <= SUM_TOL, _rel(g, r)


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_taps_match_plain(shape):
    x = _inputs(8, *shape)
    got, _ = emulate_fwd(x, "taps", blocks=3)
    ref = mk.meta_kernel_taps_plain(x["feat"].float(), x["cb"].float(),
                                    *_mlp(x))
    assert _bf16_ok(got.bfloat16(), ref)


def test_emulated_modes_form_one_tap_product():
    # the taps' output is meta_agg's a and meta_stats' a, bit for bit, at
    # other block counts
    x = _inputs(9, 1, 3, 70)
    taps, _ = emulate_fwd(x, "taps", blocks=2)
    for kind, blocks in (("agg", 3), ("stats", 5)):
        assert torch.equal(emulate_fwd(x, kind, blocks)[1], taps), kind


@pytest.mark.parametrize("mode", ["agg", "stats"])
@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_backward_matches_plain(shape, mode):
    x = _inputs(3, *shape)
    extras = ((x["s9"], x["b9"], x["agg"], x["gy"]) if mode == "agg"
              else (x["c1"], x["c2"]))
    got = emulate_bwd(x, mode, blocks=5)
    ref = mb.meta_bwd_plain(x["feat"], x["cb"], *_mlp(x), extras, mode,
                            out_dtype=torch.float32)
    assert len(got) == len(ref)
    assert _bf16_ok(got[0].bfloat16(), ref[0])
    for i, (g, r) in enumerate(zip(got[1:], ref[1:])):
        assert g.shape == r.shape
        assert _rel(g, r) <= SUM_TOL, (i, _rel(g, r))


def _jax(x, k):
    return jnp.asarray(x[k].float().numpy()).astype(
        jnp.bfloat16 if x[k].dtype == torch.bfloat16 else jnp.float32)


def test_emulated_meta_agg_matches_pallas():
    x = _inputs(4, 1, 3, 70)
    want = jmb.meta_agg_pallas(
        *(_jax(x, k) for k in ("feat", "cb")),
        *(jnp.asarray(w.numpy()) for w in _mlp(x)), _jax(x, "s9"),
        _jax(x, "b9"), _jax(x, "agg"), interpret=True)
    got = emulate_agg(x, blocks=2)
    assert _bf16_ok(got.bfloat16(),
                    torch.from_numpy(np.asarray(want, np.float32)))


def test_emulated_backward_matches_pallas():
    x = _inputs(5, 1, 3, 70)
    mlp = [jnp.asarray(w.numpy()) for w in _mlp(x)]
    out = jmb._bwd_call(_jax(x, "feat"), _jax(x, "cb"), *mlp,
                        tuple(_jax(x, k) for k in ("s9", "b9", "agg", "gy")),
                        "agg", True)
    dfeat, dA, ds9, db9 = (torch.from_numpy(np.asarray(o, np.float32))
                           for o in out[:4])
    want = (dfeat, dA, ds9[:, 0], db9[:, 0],
            *(torch.from_numpy(np.asarray(o, np.float32))
              for o in jmb._unpack_mlp(*out[-4:])))
    got = emulate_bwd(x, "agg", blocks=2)
    # the Pallas kernel rounds dfeat to bf16: one more rounding
    assert _bf16_ok(got[0].bfloat16(), want[0])
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        assert _rel(g, w) <= SUM_TOL, (i, _rel(g, w))


def test_emulated_meta_stats_matches_pallas():
    x = _inputs(10, 1, 3, 70)
    want = jmb.meta_stats_pallas(
        *(_jax(x, k) for k in ("feat", "cb")),
        *(jnp.asarray(w.numpy()) for w in _mlp(x)), interpret=True)
    got, _ = emulate_fwd(x, "stats", blocks=2)
    for g, w in zip(got, want):
        w = torch.from_numpy(np.asarray(w, np.float32))
        assert _rel(g, w) <= SUM_TOL, _rel(g, w)


def test_emulated_taps_match_pallas_nhwc():
    x = _inputs(11, 1, 3, 70)
    nhwc = [jnp.asarray(x[k].float().numpy().transpose(0, 1, 3, 2)).astype(
        jnp.bfloat16) for k in ("feat", "cb")]
    mlp = [jnp.asarray(w.numpy()).astype(jnp.bfloat16) for w in _mlp(x)]
    want = torch.from_numpy(np.asarray(
        meta_kernel_fused(*nhwc, *mlp, 32, True), np.float32)).permute(
            0, 1, 3, 2)
    got, _ = emulate_fwd(x, "taps", blocks=2)
    ref = mk.meta_kernel_taps_plain(x["feat"].float(), x["cb"].float(),
                                    *_mlp(x))
    outside = (got - want).abs() > TAPS_TOL * (1 + want.abs())
    nearer = (got - ref).abs() <= (want - ref).abs()
    assert not (outside & ~nearer).any()


# ------------------------------------------------- C = 128: channel groups
def test_plan_channel_groups():
    # meta_agg: every block walks both groups of each of its chunks; the
    # others: block i takes group i % 2 and the chunks of i // 2
    agg = mb.plan_meta("agg", 1, 3, 70, 3, C=128)
    assert (agg.groups, agg.grid_groups) == (2, 1)
    assert agg.units(0) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert agg.units(2) == [(4, 0), (4, 1), (5, 0), (5, 1)]
    for kind in ("stats", "taps", "bwd"):
        p = mb.plan_meta(kind, 1, 3, 70, 4, C=128)
        assert (p.groups, p.grid_groups) == (2, 2)
        assert [p.block_group(i) for i in range(4)] == [0, 1, 0, 1]
        assert p.block_range(0) == p.block_range(1)
        assert p.units(1) == [(ch, 1) for ch in range(*p.block_range(1))]
        # every chunk once in each group
        seen = sorted(u for i in range(4) for u in p.units(i))
        assert seen == sorted((ch, g) for ch in range(p.chunks)
                              for g in range(2))
        with pytest.raises(ValueError):
            mb.plan_meta(kind, 1, 3, 70, 3, C=128)
    # C = 64 is one group: the plan of the kernels before the groups
    p = mb.plan_meta("bwd", 2, 64, 2656, 132)
    assert p.groups == 1 and p.units(5) == [(ch, 0) for ch in
                                            range(*p.block_range(5))]


@pytest.mark.parametrize("kind", ["agg", "stats", "taps", "bwd_agg",
                                  "bwd_stats"])
def test_emulated_kernels_match_plain_at_c128(kind):
    x = _inputs(12, 1, 3, 70, C=128, CO=128)
    mlp = (x["feat"], x["cb"], *_mlp(x))
    if kind == "agg":
        got = emulate_agg(x, blocks=3)
        ref = mb.meta_agg_plain(*mlp, x["s9"], x["b9"], x["agg"],
                                out_dtype=torch.float32)
        assert got.shape == (1, 3, 128, 70) and _bf16_ok(got.bfloat16(), ref)
    elif kind == "stats":
        got, _ = emulate_fwd(x, "stats", blocks=4)
        for g, r in zip(got, mb.meta_stats_plain(*mlp)):
            assert g.shape == (9 * 128,) and _rel(g, r) <= SUM_TOL
    elif kind == "taps":
        got, _ = emulate_fwd(x, "taps", blocks=6)
        ref = mk.meta_kernel_taps_plain(x["feat"].float(), x["cb"].float(),
                                        *_mlp(x))
        assert _bf16_ok(got.bfloat16(), ref)
    else:
        mode = kind[4:]
        extras = ((x["s9"], x["b9"], x["agg"], x["gy"]) if mode == "agg"
                  else (x["c1"], x["c2"]))
        got = emulate_bwd(x, mode, blocks=4)
        ref = mb.meta_bwd_plain(*mlp, extras, mode, out_dtype=torch.float32)
        assert len(got) == len(ref)
        assert _bf16_ok(got[0].bfloat16(), ref[0])
        for i, (g, r) in enumerate(zip(got[1:], ref[1:])):
            assert g.shape == r.shape
            assert _rel(g, r) <= SUM_TOL, (i, _rel(g, r))


def test_emulated_modes_form_one_tap_product_at_c128():
    x = _inputs(13, 1, 2, 70, C=128, CO=128)
    taps, _ = emulate_fwd(x, "taps", blocks=2)
    for kind, blocks in (("agg", 3), ("stats", 4)):
        assert torch.equal(emulate_fwd(x, kind, blocks)[1], taps), kind
