"""The Meta-Kernel's materialized taps of rangedet_tpu_torch (kernel 7,
ops/meta_kernel.py) against the JAX package, on the CPU: the plain version
against the Pallas kernel of rangedet_tpu/ops/meta_kernel_pallas.py in
interpret mode (as tests/test_meta_kernel.py runs it), MetaKernelTaps'
gradients against JAX's custom VJP, the port's MetaBlock in eval against
JAX's nhwc MetaBlock with use_pallas, and the whole eval step with
use_pallas_meta against JAX's nhwc step. Inputs are numpy seeds fed to both
sides. On the CPU the wrapper takes its plain version; the cuda-marked test
and chip_smoke.py hold the kernel to it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangedet_tpu.models.dla_backbone import MetaBlock as JaxMetaBlock
from rangedet_tpu.ops.meta_kernel_pallas import meta_kernel_fused
from rangedet_tpu_torch.convert import from_flax
from rangedet_tpu_torch.models.dla_backbone import MetaBlock
from rangedet_tpu_torch.models.meta_kernel import MetaKernel
from rangedet_tpu_torch.ops import meta_kernel as mk
from torch_parity import check_eval_step, perturb

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

C, CM, CO = 16, 8, 24
# f32: the same products in another summation order
F32_TOL = 1e-5
# bf16: JAX's own bound between this kernel and the XLA form
# (tests/test_meta_kernel.py); the two round h and w at other points
BF16_TOL = 4e-2
# f32 gradients: sums over up to B*H*W*9 terms in another order
GRAD_TOL = 1e-4
# the eval block, f32: BN and the 1x1 conv after the taps
BLOCK_TOL = 1e-4
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want):
    """max|got - want| / max|want|, in f32."""
    got, want = (t.detach().float().numpy() if isinstance(t, torch.Tensor)
                 else np.asarray(t, np.float32) for t in (got, want))
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(seed, B, H, W):
    """feat (B, H, W, C) and coords (B, H, W, 3) channels last, as the JAX
    kernel takes them, both standard normal as in tests/test_meta_kernel.py,
    and the MLP in the JAX layout."""
    r = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * r.standard_normal(shape)).astype(np.float32)

    return dict(feat=n(B, H, W, C), coords=n(B, H, W, 3),
                w0=n(3, CM, scale=3 ** -0.5), b0=n(CM, scale=0.1),
                w1=n(CM, C, scale=CM ** -0.5), b1=n(C, scale=0.1))


def _jax(x, jd):
    return [jnp.asarray(x[k]).astype(jd)
            for k in ("feat", "coords", "w0", "b0", "w1", "b1")]


def _port(x, td, requires_grad=False):
    """The same values in the port's layout: feat (B, H, C, W), cb
    (B, H, 3, W)."""
    feat = torch.from_numpy(x["feat"]).permute(0, 1, 3, 2).contiguous()
    cb = torch.from_numpy(x["coords"]).permute(0, 1, 3, 2).contiguous()
    out = [feat, cb] + [torch.from_numpy(x[k])
                        for k in ("w0", "b0", "w1", "b1")]
    return [t.to(td).requires_grad_(requires_grad) for t in out]


def _bhcw(a):
    return np.transpose(np.asarray(a, np.float32), (0, 1, 3, 2))


@pytest.mark.parametrize("dt,shape", [("f32", (2, 5, 37)),
                                      ("bf16", (2, 4, 45))])
def test_plain_taps_match_pallas(dt, shape):
    jd, td = DT[dt]
    x = _inputs(0, *shape)
    want = _bhcw(meta_kernel_fused(*_jax(x, jd), 32, True))
    got = mk.meta_kernel_taps(*_port(x, td))
    assert got.dtype == td
    assert tuple(got.shape) == (shape[0], shape[1], 9 * C, shape[2])
    tol = F32_TOL if dt == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_taps_vjp_matches_jax():
    x = _inputs(1, 2, 4, 37)
    gy = np.random.default_rng(2).standard_normal(
        (2, 4, 37, 9 * C)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: meta_kernel_fused(*a, 32, True),
                     *_jax(x, jnp.float32))
    want = vjp(jnp.asarray(gy))
    leaves = _port(x, torch.float32, requires_grad=True)
    out = mk.MetaKernelTaps.apply(*leaves)
    (out * torch.from_numpy(_bhcw(gy))).sum().backward()
    names = ("feat", "coords", "w0", "b0", "w1", "b1")
    for name, leaf, w in zip(names, leaves, want):
        w = np.asarray(w)
        if name in ("feat", "coords"):
            w = _bhcw(w)
        assert leaf.grad.shape == w.shape, name
        assert _rel(leaf.grad, w) <= GRAD_TOL, (name, _rel(leaf.grad, w))


def test_meta_block_eval_matches_jax_nhwc_pallas_block():
    B, H, W = 2, 5, 37
    x = _inputs(3, B, H, W)
    kw = dict(channel_list=(CM, C), features=CO, layout="nhwc",
              dtype=jnp.float32)
    feat, coords = jnp.asarray(x["feat"]), jnp.asarray(x["coords"])
    v = jax.jit(JaxMetaBlock(use_pallas=False, **kw).init,
                static_argnums=3)(jax.random.PRNGKey(3), feat, coords, False)
    params, stats = perturb(v, seed=3)
    want = jax.jit(lambda p, s, f, c: JaxMetaBlock(use_pallas=True, **kw)
                   .apply({"params": p, "batch_stats": s}, f, c, False))(
        params, stats, feat, coords)
    port = MetaBlock((CM, C), CO, torch.float32, use_pallas_meta=True)
    port.load_state_dict(from_flax(params, stats), strict=True)
    called = []
    real = mk.meta_kernel_taps
    mk.meta_kernel_taps = lambda *a: called.append(1) or real(*a)
    try:
        with torch.inference_mode():
            got = port.eval()(_port(x, torch.float32)[0],
                              torch.from_numpy(x["coords"]))
    finally:
        mk.meta_kernel_taps = real
    assert called == [1]  # the taps went through the kernel's wrapper
    assert _rel(got, _bhcw(want)) <= BLOCK_TOL


def test_meta_kernel_parameters_do_not_depend_on_the_switch():
    # use_pallas_meta selects the op, not the parameters, so convert.py
    # maps one tree onto both
    a, b = (MetaKernel((CM, C), torch.float32, use_pallas_meta=f)
            for f in (False, True))
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}
    b.load_state_dict(a.state_dict())
    feat = torch.randn(1, 3, C, 11)
    coords = torch.randn(1, 3, 11, 3)
    assert torch.equal(a(feat, coords), b(feat, coords))


def test_eval_step_with_the_taps_kernel_matches_jax_nhwc():
    check_eval_step("nhwc", use_pallas_meta=True)


def test_kernel_route_refuses_other_devices():
    x = torch.empty((1, 2, C, 8), device="meta")
    cb = torch.empty((1, 2, 3, 8), device="meta")
    w = [torch.empty(s, device="meta") for s in ((3, CM), (CM,), (CM, C),
                                                  (C,))]
    with pytest.raises(ValueError, match="no meta_kernel kernel for device"):
        mk.meta_kernel_taps(x, cb, *w)


# ---------------------------------------------------------------- card
@pytest.mark.cuda
def test_taps_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    mk.reset_counts()
    # the recipe's widths; W = 77 and 70 are ragged (rows copied to a pitch
    # of 80 and 72, the output written at that pitch and viewed)
    for B, H, W in ((2, 8, 77), (1, 3, 70)):
        _check_taps_kernel(dev, g, B, H, W)
    assert mk.LAUNCHES == 4


def _check_taps_kernel(dev, g, B, H, W, C_=64):
    Cm = 32

    def rn(*s, scale=1.0):
        return scale * torch.randn(*s, device=dev, generator=g)

    feat = torch.relu(rn(B, H, C_, W)).bfloat16()
    cb = rn(B, H, 3, W, scale=0.5).bfloat16()
    mlp = (rn(3, Cm, scale=0.6), rn(Cm, scale=0.1), rn(Cm, C_, scale=0.2),
           rn(C_, scale=0.1))
    y = mk.meta_kernel_taps(feat, cb, *mlp)
    ref = mk.meta_kernel_taps_plain(feat.float(), cb.float(),
                                    *(w.bfloat16().float() for w in mlp))
    # one rounding of the f32 product to bf16
    assert ((y.float() - ref).abs() <= 2 ** -6 * ref.abs()
            + 1e-3 * ref.abs().max()).all()
    assert torch.equal(y, mk.meta_kernel_taps(feat, cb, *mlp))
