"""The fused Meta-Kernel block of rangedet_tpu_torch against the JAX
package, on the CPU: the plain versions of kernels 3-5 (ops/meta_block.py)
against the Pallas kernels of rangedet_tpu/ops/meta_block_pallas.py in
interpret mode, BatchNormFold against JAX's, and the port's MetaBlock in its
fused training form against JAX's MetaBlock(use_pallas=True, layout="bhcw")
and against the port's materialized block. Shapes are those of
tests/test_meta_block_pallas.py (C=16, Cm=8, Co=24); inputs are numpy
seeds fed to both sides. On the CPU every wrapper takes its plain version;
the cuda-marked test and chip_smoke.py hold the kernels to them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangedet_tpu.models.dla_backbone import MetaBlock as JaxMetaBlock
from rangedet_tpu.models.layers import BatchNormFold as JaxBatchNormFold
from rangedet_tpu.ops import meta_block_pallas as jmb
from rangedet_tpu_torch.convert import from_flax
from rangedet_tpu_torch.models.dla_backbone import MetaBlock
from rangedet_tpu_torch.models.layers import BatchNormFold
from rangedet_tpu_torch.ops import meta_block as mb
from torch_parity import perturb

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

C, CM, CO = 16, 8, 24
# f32: the same math in another summation order; JAX's own bound for the
# fused block against the materialized one (test_meta_block_pallas.py)
F32_TOL = 1e-4
# bf16: the tap product and the outputs round to bf16 on both sides; where
# the f32 products before the rounding differ by an ulp, a rounds to the
# neighbouring bf16 value (2^-8 relative). JAX's bounds for its bf16 block
BF16_TOL = 5e-2
BF16_DFEAT_TOL = 1e-1
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want):
    """max|got - want| / max|want|, in f32."""
    got, want = (t.detach().float().numpy() if isinstance(t, torch.Tensor)
                 else np.asarray(t, np.float32) for t in (got, want))
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(seed, B, H, W):
    r = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * r.standard_normal(shape)).astype(np.float32)

    return dict(
        feat=n(B, H, C, W), cb=n(B, H, 3, W, scale=2.0),
        w0=n(3, CM, scale=3 ** -0.5), b0=n(CM, scale=0.1),
        w1=n(CM, C, scale=CM ** -0.5), b1=n(C, scale=0.1),
        s9=1.0 + n(9 * C, scale=0.3), b9=n(9 * C, scale=0.2),
        agg=n(9 * C, CO, scale=(9 * C) ** -0.5), gy=n(B, H, CO, W),
        c1=n(9 * C, scale=0.1), c2=n(9 * C, scale=0.05),
    )


def _sides(x, dt):
    """The same values for both: feat, cb, MLP weights and agg rounded to
    the compute dtype (as the JAX block casts them), vectors in f32."""
    jd, td = DT[dt]
    jx, tx = {}, {}
    for k, v in x.items():
        if k in ("s9", "b9", "c1", "c2"):
            jx[k], tx[k] = jnp.asarray(v), torch.from_numpy(v)
        else:
            jx[k] = jnp.asarray(v).astype(jd)
            tx[k] = torch.from_numpy(v).to(td)
    return jx, tx


def _mlp(d):
    return d["w0"], d["b0"], d["w1"], d["b1"]


CASES = [("f32", (2, 8, 40)), ("bf16", (1, 5, 17))]


@pytest.mark.parametrize("dt,shape", CASES)
def test_plain_stats_matches_pallas(dt, shape):
    jx, tx = _sides(_inputs(0, *shape), dt)
    want = jmb.meta_stats_pallas(jx["feat"], jx["cb"], *_mlp(jx),
                                 interpret=True)
    got = mb.meta_stats_plain(tx["feat"], tx["cb"], *_mlp(tx))
    tol = F32_TOL if dt == "f32" else BF16_TOL
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (9 * C,)
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("dt,shape", CASES)
def test_plain_agg_matches_pallas(dt, shape):
    jx, tx = _sides(_inputs(1, *shape), dt)
    want = jmb.meta_agg_pallas(jx["feat"], jx["cb"], *_mlp(jx), jx["s9"],
                               jx["b9"], jx["agg"], interpret=True)
    got = mb.meta_agg_plain(tx["feat"], tx["cb"], *_mlp(tx), tx["s9"],
                            tx["b9"], tx["agg"])
    assert got.dtype == DT[dt][1] and tuple(got.shape) == want.shape
    assert _rel(got, want) <= (F32_TOL if dt == "f32" else BF16_TOL)


@pytest.mark.parametrize("mode", ["agg", "stats"])
@pytest.mark.parametrize("dt,shape", CASES)
def test_plain_backward_matches_pallas(mode, dt, shape):
    jx, tx = _sides(_inputs(2, *shape), dt)
    keys = ("s9", "b9", "agg", "gy") if mode == "agg" else ("c1", "c2")
    out = jmb._bwd_call(jx["feat"], jx["cb"], *_mlp(jx),
                        tuple(jx[k] for k in keys), mode, True)
    mlp = jmb._unpack_mlp(*out[-4:])
    if mode == "agg":
        dfeat, dA, ds9, db9 = out[:4]
        want = (dfeat, dA, ds9[:, 0], db9[:, 0], *mlp)
    else:
        want = (out[0], *mlp)
    got = mb.meta_bwd_plain(tx["feat"], tx["cb"], *_mlp(tx),
                            tuple(tx[k] for k in keys), mode)
    assert len(got) == len(want)
    assert got[0].dtype == DT[dt][1]
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        tol = F32_TOL if dt == "f32" else (BF16_DFEAT_TOL if i == 0
                                           else BF16_TOL)
        assert _rel(g, w) <= tol, (i, _rel(g, w))


def test_batch_norm_fold_matches_jax():
    r = np.random.default_rng(3)
    s1 = r.standard_normal(40).astype(np.float32) * 50
    s2 = (r.random(40).astype(np.float32) + 1.0) * 400 + s1 ** 2 / 300
    s2[0] = s1[0] ** 2 / 300 - 1.0  # var < 0 before the clamp
    n = 300.0
    mod = JaxBatchNormFold(False)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(s1), jnp.asarray(s2), n)
    params, stats = perturb(v, seed=4)
    (scale, bias), upd = mod.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(s1),
        jnp.asarray(s2), n, mutable=["batch_stats"])
    bn = BatchNormFold(40)
    bn.load_state_dict(from_flax(params, stats))
    got = bn.train()(torch.from_numpy(s1), torch.from_numpy(s2), n)
    for g, w in zip(got, (scale, bias)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    for k, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6)
    # eval: the running statistics, nothing moves
    before = bn.running_mean.clone()
    inv, add = bn.eval()(torch.from_numpy(s1), torch.from_numpy(s2), n)
    jinv, jadd = JaxBatchNormFold(True).apply(
        {"params": params, "batch_stats": upd["batch_stats"]},
        jnp.asarray(s1), jnp.asarray(s2), n)
    assert torch.equal(bn.running_mean, before)
    np.testing.assert_allclose(inv.detach().numpy(), np.asarray(jinv),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(add.detach().numpy(), np.asarray(jadd),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- block
def _block_setup(seed, dt, B, H, W):
    jd, td = DT[dt]
    x = _inputs(seed, B, H, W)
    feat = x["feat"]
    coords = np.transpose(x["cb"], (0, 1, 3, 2)).copy()  # (B, H, W, 3)
    kw = dict(channel_list=(CM, C), features=CO, layout="bhcw", dtype=jd)
    v = jax.jit(JaxMetaBlock(use_pallas=False, **kw).init,
                static_argnums=3)(jax.random.PRNGKey(seed),
                                  jnp.asarray(feat).astype(jd),
                                  jnp.asarray(coords), True)
    params, stats = perturb(v, seed=seed)
    port = MetaBlock((CM, C), CO, td, use_pallas_meta=True)
    port.load_state_dict(from_flax(params, stats), strict=True)
    gy = np.random.default_rng(seed + 1).standard_normal(
        (B, H, CO, W)).astype(np.float32)
    return JaxMetaBlock(use_pallas=True, **kw), port, params, stats, \
        feat, coords, gy


def _jax_train(mod, params, stats, feat, coords, gy, jd):
    def loss(p, xx):
        y, upd = mod.apply({"params": p, "batch_stats": stats}, xx,
                           jnp.asarray(coords), True, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * gy), (y, upd)

    (_, (y, upd)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params,
                                             jnp.asarray(feat).astype(jd))
    return y, upd["batch_stats"], gp, gx


def _port_train(port, feat, coords, gy, td):
    x = torch.from_numpy(feat).to(td).requires_grad_(True)
    y = port.train()(x, torch.from_numpy(coords))
    (y.float() * torch.from_numpy(gy)).sum().backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    return y, x.grad, grads


def test_fused_block_matches_jax_in_training_f32():
    jmod, port, params, stats, feat, coords, gy = _block_setup(
        5, "f32", 1, 5, 40)
    y, bstats, gp, gx = _jax_train(jmod, params, stats, feat, coords, gy,
                                   jnp.float32)
    calls = []
    real = (mb.meta_stats, mb.meta_agg, mb.meta_bwd)
    mb.meta_stats = lambda *a: calls.append("stats") or real[0](*a)
    mb.meta_agg = lambda *a: calls.append("agg") or real[1](*a)
    mb.meta_bwd = lambda *a: calls.append(a[-1]) or real[2](*a)
    try:
        py, pgx, pgrads = _port_train(port, feat, coords, gy, torch.float32)
    finally:
        mb.meta_stats, mb.meta_agg, mb.meta_bwd = real
    # the fused chain ran: one pass each, the backward in both modes
    assert sorted(calls) == ["agg", "agg", "stats", "stats"]
    assert _rel(py.detach(), y) <= F32_TOL
    assert _rel(pgx, gx) <= F32_TOL
    want = from_flax(jax.tree_util.tree_map(np.asarray, gp), {})
    assert sorted(want) == sorted(pgrads)
    for n, w in want.items():
        assert _rel(pgrads[n], w) <= F32_TOL, n
    want_stats = from_flax({}, jax.tree_util.tree_map(np.asarray, bstats))
    sd = port.state_dict()
    for n, w in want_stats.items():
        assert _rel(sd[n], w) <= F32_TOL, n


def test_fused_block_matches_jax_in_training_bf16():
    jmod, port, params, stats, feat, coords, gy = _block_setup(
        6, "bf16", 1, 5, 17)
    y, _, _, gx = _jax_train(jmod, params, stats, feat, coords, gy,
                             jnp.bfloat16)
    py, pgx, _ = _port_train(port, feat, coords, gy, torch.bfloat16)
    assert py.dtype == torch.bfloat16 and pgx.dtype == torch.bfloat16
    assert _rel(py.detach(), y) <= BF16_TOL
    assert _rel(pgx, gx) <= BF16_DFEAT_TOL


def test_fused_block_eval_is_the_materialized_form():
    jmod, port, params, stats, feat, coords, _ = _block_setup(
        7, "f32", 2, 5, 17)
    want = jax.jit(lambda p, s, x, c: jmod.apply(
        {"params": p, "batch_stats": s}, x, c, False))(
        params, stats, jnp.asarray(feat), jnp.asarray(coords))
    called = []
    real = mb.meta_stats
    mb.meta_stats = lambda *a: called.append(1) or real(*a)
    try:
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(feat),
                              torch.from_numpy(coords))
    finally:
        mb.meta_stats = real
    assert not called
    assert _rel(got, want) <= F32_TOL


def test_fused_block_equals_the_materialized_block_in_the_port():
    # f32, no JAX: the two training forms of one block agree in output,
    # running statistics and every gradient
    x = _inputs(8, 2, 8, 40)
    coords = torch.from_numpy(np.transpose(x["cb"], (0, 1, 3, 2)).copy())
    gy = torch.from_numpy(x["gy"])
    outs = []
    for fused in (True, False):
        torch.manual_seed(0)
        blk = MetaBlock((CM, C), CO, torch.float32, use_pallas_meta=fused)
        blk.meta_kernel.init_from(torch.Generator().manual_seed(1))
        blk.meta_agg.init_from(torch.Generator().manual_seed(2))
        with torch.no_grad():
            for bn in (blk.meta_bn, blk.meta_agg.bn):
                bn.weight.uniform_(0.7, 1.3)
                bn.bias.normal_(0.0, 0.1)
        feat = torch.from_numpy(x["feat"]).requires_grad_(True)
        y = blk.train()(feat, coords)
        (y * gy).sum().backward()
        outs.append((y.detach(), feat.grad,
                     {n: p.grad for n, p in blk.named_parameters()},
                     {n: b.clone() for n, b in blk.named_buffers()}))
    (y1, g1, p1, b1), (y2, g2, p2, b2) = outs
    assert _rel(y1, y2) <= F32_TOL and _rel(g1, g2) <= F32_TOL
    for n in p2:
        assert _rel(p1[n], p2[n]) <= F32_TOL, n
    for n in b2:
        assert _rel(b1[n], b2[n]) <= F32_TOL, n


def test_kernel_route_refuses_other_devices():
    x = torch.empty((1, 2, C, 8), device="meta")
    cb = torch.empty((1, 2, 3, 8), device="meta")
    w = [torch.empty(s, device="meta") for s in ((3, CM), (CM,), (CM, C),
                                                  (C,))]
    with pytest.raises(ValueError, match="no meta_block kernel for device"):
        mb.meta_stats(x, cb, *w)


# ---------------------------------------------------------------- card
@pytest.mark.cuda
def test_meta_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # the recipe's widths; W = 70 is ragged (rows copied to a pitch of 72)
    for B, H, W in ((2, 8, 96), (1, 3, 70)):
        _check_meta_kernels(dev, g, B, H, W)


def _check_meta_kernels(dev, g, B, H, W, C_=64, Co=64):
    Cm = 32

    def rn(*s, scale=1.0):
        return scale * torch.randn(*s, device=dev, generator=g)

    feat, cb = rn(B, H, C_, W).bfloat16(), rn(B, H, 3, W, scale=3).bfloat16()
    mlp = (rn(3, Cm, scale=0.6), rn(Cm, scale=0.1), rn(Cm, C_, scale=0.2),
           rn(C_, scale=0.1))
    s9, b9 = 1 + rn(9 * C_, scale=0.3), rn(9 * C_, scale=0.2)
    agg = rn(9 * C_, Co, scale=1 / 24).bfloat16()
    gy = rn(B, H, Co, W).bfloat16()
    mb.reset_counts()
    for got, want in zip(mb.meta_stats(feat, cb, *mlp),
                         mb.meta_stats_plain(feat, cb, *mlp)):
        assert _rel(got.cpu(), want.cpu()) <= 1e-3
    y = mb.meta_agg(feat, cb, *mlp, s9, b9, agg)
    yp = mb.meta_agg_plain(feat, cb, *mlp, s9, b9, agg,
                           out_dtype=torch.float32)
    assert ((y.float() - yp).abs() <= 2 ** -6 * yp.abs()
            + 1e-3 * yp.abs().max()).all()
    for extras, mode in (((s9, b9, agg, gy), "agg"),
                         ((rn(9 * C_, scale=1e-3), rn(9 * C_, scale=1e-4)),
                          "stats")):
        got = mb.meta_bwd(feat, cb, *mlp, extras, mode)
        want = mb.meta_bwd_plain(feat, cb, *mlp, extras, mode,
                                 out_dtype=torch.float32)
        d, dp = got[0].float(), want[0]
        assert ((d - dp).abs() <= 2 ** -6 * dp.abs()
                + 1e-3 * dp.abs().max()).all()
        for a, b in zip(got[1:], want[1:]):
            assert _rel(a.cpu(), b.cpu()) <= 1e-3
        again = mb.meta_bwd(feat, cb, *mlp, extras, mode)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (mb.STATS_LAUNCHES, mb.AGG_LAUNCHES, mb.BWD_LAUNCHES) == (1, 1, 4)
