"""The Meta-Kernel's weighted neighbourhood over (B, H, C, W), materialized:
(B, H, 9C, W), tap-major and channel-minor. Counterpart of
``rangedet_tpu/ops/meta_kernel_pallas.py`` (``meta_kernel_fused``); the
kernel is the "taps" mode of ``csrc/meta_block.cu``'s forward kernel.

Per pixel p and tap t = (dy, dx) of its 3x3 neighbourhood:
rel = coords[p + o_t] - coords[p] (zero padding, so a border tap's rel is
``-centre``); w = relu(rel @ w0 + b0) @ w1 + b1; out[p, tC:(t+1)C] =
feat[p + o_t] * w. Weights are in the JAX package's layout: w0 (3, Cm), b0
(Cm,), w1 (Cm, C), b1 (C,).

* ``meta_kernel_taps_plain`` is the XLA formulation (``_meta_oracle``,
  ``rangedet_tpu/models/meta_kernel.py:_bhcw``) in the port's layout: every
  operand cast to feat.dtype, so in bf16 ``h`` and ``w`` round to bf16.
* ``meta_kernel_taps`` routes: a CPU tensor to the plain version, a CUDA
  tensor to the kernel (bf16, at the widths it is built for: C=64 or 128,
  Cm=32) or raises.
  The kernel is the "taps" mode of ``csrc/meta_block.cu``'s forward kernel,
  whose tap stage meta_stats, meta_agg and the block backward share: rel,
  h and w in f32 from the bf16 operands, rounded once, at the product,
  to the tap product a of the training plain version
  (``ops/meta_block.py:_taps``). It stores its tiles by TMA, whose rows
  need 16-byte strides: for W % 8 != 0 it writes rows of plan.pitch and
  returns a view of the first W columns.
* ``MetaKernelTaps`` is the custom VJP ``meta_kernel_fused``: the forward
  is ``meta_kernel_taps``, the backward the plain version's autograd VJP
  for every input, coordinates included (``_meta_vjp_bwd``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv3x3 import _route, _stream
from .meta_block import _check, _grid, _kernel_inputs, _pitched, plan_meta

# kernel launches since the last reset: one per call that launches the
# kernel
LAUNCHES = 0


def reset_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def meta_kernel_taps_plain(feat, cb, w0, b0, w1, b1):
    """feat (B, H, C, W), cb (B, H, 3, W) -> (B, H, 9C, W) in feat.dtype,
    every step in feat.dtype (differentiable)."""
    _check(feat, cb, w0, b0, w1, b1)
    B, H, C, W = feat.shape
    d = feat.dtype
    w0, b0, w1, b1 = (t.to(d) for t in (w0, b0, w1, b1))
    cb = cb.to(d)
    cp = F.pad(cb, (1, 1, 0, 0, 1, 1))
    fp = F.pad(feat, (1, 1, 0, 0, 1, 1))
    outs = []
    for dy in range(3):
        for dx in range(3):
            rel = cp[:, dy:dy + H, :, dx:dx + W] - cb
            h = torch.einsum("bhcw,cd->bhdw", rel, w0)
            h = torch.relu(h + b0[None, None, :, None])
            wt = torch.einsum("bhdw,dc->bhcw", h, w1)
            wt = wt + b1[None, None, :, None]
            outs.append(fp[:, dy:dy + H, :, dx:dx + W] * wt)
    return torch.cat(outs, dim=2)


def meta_kernel_taps(feat, cb, w0, b0, w1, b1):
    """The taps (B, H, 9C, W) in feat.dtype. No gradient: see
    MetaKernelTaps."""
    global LAUNCHES
    _check(feat, cb, w0, b0, w1, b1)
    if not _route(feat, "meta_kernel"):
        return meta_kernel_taps_plain(feat, cb, w0, b0, w1, b1)
    lib, cbb, ws = _kernel_inputs(feat, cb, w0, b0, w1, b1)
    B, H, C, W = feat.shape
    plan = plan_meta("taps", B, H, W, _grid(lib, 4, C, B, H, W), C)
    fp, cp = _pitched(feat, plan.pitch), _pitched(cbb, plan.pitch)
    out = torch.empty((B, H, 9 * C, plan.pitch), dtype=feat.dtype,
                      device=feat.device)
    with torch.cuda.device(feat.device):
        err = lib.meta_kernel_taps(
            fp.data_ptr(), cp.data_ptr(), *(w.data_ptr() for w in ws),
            out.data_ptr(), C, B, H, W, plan.pitch, plan.blocks,
            _stream(feat))
    if err != 0:
        raise RuntimeError(f"meta_kernel_taps launch failed: cudaError {err}")
    LAUNCHES += 1
    return out if plan.pitch == W else out[..., :W]


class MetaKernelTaps(torch.autograd.Function):
    """out = meta_kernel_taps(...); the backward recomputes the plain
    version under autograd and returns its VJP for all six inputs. The
    forward looks ``meta_kernel_taps`` up on this module at call time, so
    patching it (as chip_smoke does with the plain version) routes it."""

    @staticmethod
    def forward(ctx, feat, cb, w0, b0, w1, b1):
        ctx.save_for_backward(feat, cb, w0, b0, w1, b1)
        return meta_kernel_taps(feat, cb, w0, b0, w1, b1)

    @staticmethod
    def backward(ctx, gy):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = meta_kernel_taps_plain(*inputs)
        return torch.autograd.grad(out, inputs, gy, allow_unused=True)
