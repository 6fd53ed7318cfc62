"""The port's conv3x3 (rangedet_tpu_torch/ops/conv3x3.py) against the JAX
package's Pallas kernel run in interpret mode, on the same numpy inputs.

On the CPU the wrapper takes the plain version, so these tests hold the
plain version (the kernel's reference on the card) to the Pallas kernel;
chip_smoke.py holds the CUDA kernel to the plain version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rangedet_tpu.models.layers import (
    conv3x3_stride2_phase,
    deconv_bhcw_phase_conv,
)
from rangedet_tpu.ops.conv_pallas import conv3x3_bhcw as pallas_conv
from rangedet_tpu.ops.conv_pallas import conv3x3_bnrelu_bhcw
from rangedet_tpu_torch.models.layers import deconv_bhcw
from rangedet_tpu_torch.ops import conv3x3
from rangedet_tpu_torch.ops.conv3x3 import conv3x3_bhcw, conv3x3_bhcw_plain

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

F32_ATOL = 1e-4  # tests/test_conv_pallas.py's tolerance for the f32 kernel
# bf16: both accumulate in f32 and round the output to bf16 once; the
# summation order differs, so a result may land one bf16 step (2^-8
# relative) away, and 2^-6 relative plus 1e-2 absolute bounds that
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-2


def _inputs(rng, B, H, Ci, W, Co, kw=3):
    x = rng.randn(B, H, Ci, W).astype(np.float32)
    w = (0.1 * rng.randn(3, kw, Ci, Co)).astype(np.float32)
    s = (1.0 + 0.3 * rng.randn(Ci)).astype(np.float32)
    b = (0.2 * rng.randn(Ci)).astype(np.float32)
    return x, w, s, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("W", [200, 165])  # 165: odd width, ragged edge
def test_conv_and_fused_ingest_match_pallas(rng, W):
    x, w, s, b = _inputs(rng, 2, 8, 16, W, 24)
    tx, tw, ts, tb = _t(x, w, s, b)
    want = pallas_conv(jnp.asarray(x), jnp.asarray(w), None, True)
    np.testing.assert_allclose(conv3x3_bhcw(tx, tw).numpy(),
                               np.asarray(want), atol=F32_ATOL)
    want = conv3x3_bnrelu_bhcw(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(s), jnp.asarray(b), None, True)
    got = conv3x3_bhcw(tx, tw, ts, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


def test_zero_padding_is_in_the_activated_domain(rng):
    # a negative scale with a large bias: relu(bias) at the border would
    # be far from 0, so a pad applied before the ingest moves every edge
    x, w, _, _ = _inputs(rng, 1, 4, 8, 32, 8)
    s = np.full(8, -1.0, np.float32)
    b = np.full(8, 5.0, np.float32)
    want = conv3x3_bnrelu_bhcw(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(s), jnp.asarray(b), None, True)
    got = conv3x3_bhcw(*_t(x, w, s, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("ingest", [False, True])
def test_stride2_matches_pallas_phase_conv(rng, ingest):
    x, w, s, b = _inputs(rng, 2, 8, 8, 64, 16)
    a = x
    if ingest:  # the JAX phase form ingests the same fold on both phases
        a = np.maximum(x * s[None, None, :, None] + b[None, None, :, None], 0)
    want = conv3x3_stride2_phase(jnp.asarray(a), jnp.asarray(w),
                                 interpret=True)
    tx, tw, ts, tb = _t(x, w, s, b)
    got = conv3x3_bhcw(tx, tw, ts if ingest else None,
                       tb if ingest else None, stride_w=2)
    assert got.shape == (2, 8, 16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("kw,s,W", [(8, 4, 32), (4, 2, 64)])
def test_deconv_phase_packing_matches_pallas(rng, kw, s, W):
    x, k, _, _ = _inputs(rng, 2, 8, 8, W, 8, kw=kw)
    want = deconv_bhcw_phase_conv(jnp.asarray(x), jnp.asarray(k), s,
                                  interpret=True)
    # the port's weight is nn.ConvTranspose2d's (Ci, Co, kh, kw), flipped
    wt = torch.from_numpy(k).permute(2, 3, 0, 1).flip(2, 3).contiguous()
    got = deconv_bhcw(torch.from_numpy(x), wt, s)
    assert got.shape == (2, 8, 8, W * s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    # and it is the reference's deconv: conv_transpose2d with pad (1, s/2)
    ref = F.conv_transpose2d(torch.from_numpy(x).permute(0, 2, 1, 3), wt,
                             stride=(1, s), padding=(1, (kw - s) // 2))
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 1, 3).numpy(),
                               atol=F32_ATOL)


def test_bf16_matches_pallas_within_one_rounding(rng):
    x, w, s, b = _inputs(rng, 1, 8, 16, 128, 16)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = conv3x3_bnrelu_bhcw(xb, wb, jnp.asarray(s), jnp.asarray(b),
                               None, True)
    tx, tw, ts, tb = _t(x, w, s, b)
    got = conv3x3_bhcw(tx.bfloat16(), tw.bfloat16(), ts, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


def test_wrapper_routes_cpu_to_plain_and_checks_inputs(rng):
    x, w, s, b = _t(*_inputs(rng, 1, 4, 8, 16, 8))
    before = conv3x3.LAUNCHES
    torch.testing.assert_close(conv3x3_bhcw(x, w, s, b),
                               conv3x3_bhcw_plain(x, w, s, b))
    assert conv3x3.LAUNCHES == before  # the plain version is no launch
    with pytest.raises(ValueError):
        conv3x3_bhcw(x, w[:, :, :4])  # Ci mismatch
    with pytest.raises(ValueError):
        conv3x3_bhcw(x[..., :15], w, stride_w=2)  # odd width at stride 2
    with pytest.raises(ValueError):
        conv3x3_bhcw(x, w, s, None)  # scale without bias
    with pytest.raises(ValueError):  # no kernel and no fallback elsewhere
        conv3x3_bhcw(x.to("meta"), w.to("meta"))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_and_counts_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    r = np.random.RandomState(0)
    x, w, s, b = [t.cuda() for t in _t(*_inputs(r, 2, 8, 24, 165, 40))]
    xb, wb = x.bfloat16(), w.bfloat16()
    for stride, sb in ((1, (None, None)), (1, (s, b)), (2, (s, b))):
        xs = xb if stride == 1 else xb[..., :164].contiguous()
        before = conv3x3.LAUNCHES
        y = conv3x3_bhcw(xs, wb, *sb, stride_w=stride)
        torch.cuda.synchronize()
        assert conv3x3.LAUNCHES == before + 1
        ref = conv3x3_bhcw_plain(xs, wb, *sb, stride_w=stride,
                                 out_dtype=torch.float32)
        err = (y.float() - ref).abs()
        assert (err <= 2.0 ** -6 * ref.abs() + 1e-3 * ref.abs().max()).all()
    # ragged geometry of the TMA + wgmma kernel: Ci = 8 and 72 (part of a
    # 64-channel box, two boxes), W = 70, 166 and 1040 (ragged pixel
    # tiles of 128 and 256), Co = 16, 72, 136 and 512 (ragged and many Co
    # tiles), stride 2 through the phase-packed operand; with the sums
    for (B, H, Ci, W, Co, stride, ingest) in [
            (1, 3, 8, 70, 16, 1, False), (1, 3, 72, 166, 72, 1, True),
            (1, 2, 128, 1040, 136, 2, True), (1, 3, 128, 130, 512, 1, False),
            (2, 4, 64, 166, 64, 2, False)]:
        xr = torch.randn(B, H, Ci, W, device="cuda").bfloat16()
        wr = (torch.randn(3, 3, Ci, Co, device="cuda") / (3 * Ci ** 0.5)
              ).bfloat16()
        sb = ((1 + 0.3 * torch.randn(Ci, device="cuda"),
               0.2 * torch.randn(Ci, device="cuda")) if ingest
              else (None, None))
        y, s1, s2 = conv3x3_bhcw(xr, wr, *sb, stride_w=stride, stats=True)
        ref = conv3x3_bhcw_plain(xr, wr, *sb, stride_w=stride,
                                 out_dtype=torch.float32)
        err = (y.float() - ref).abs()
        assert (err <= 2.0 ** -6 * ref.abs() + 1e-3 * ref.abs().max()
                ).all(), (B, Ci, W, Co, stride)
        yd = y.double()
        for got, want in ((s1, yd.sum((0, 1, 3))),
                          (s2, (yd * yd).sum((0, 1, 3)))):
            assert (got - want).abs().max() <= 1e-3 * want.abs().max()
        again = conv3x3_bhcw(xr, wr, *sb, stride_w=stride, stats=True)
        assert all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))
    with pytest.raises(TypeError):
        conv3x3_bhcw(x, w)  # f32 on the card: the kernel takes bf16
