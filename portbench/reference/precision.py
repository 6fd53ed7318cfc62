"""Precision of the reference and of its control.

The reference computes in f32 with TF32 off (``no_tf32``). The control is
the reference computed in the precision just below the one the
configurations state (bf16): fp8 e4m3. The model (``reference.model.Net``)
rounds through its ``cast`` every operand of a contraction and every
tensor a layer hands on (the input, each conv's, BatchNorm's, residual
sum's and tap product's output), as the program keeps them in bf16;
``fp8_cast`` rounds through e4m3 with a per-tensor scale that maps the
largest magnitude to e4m3's largest finite value (448), and rounds the
gradient flowing back the same way.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """f32 matmuls and convolutions in full f32 on a CUDA card."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class _Round(torch.autograd.Function):
    """x rounded through ``dtype`` with a per-tensor scale that maps its
    largest magnitude to ``top`` (None: no scale); the gradient rounded
    the same way on its way back."""

    @staticmethod
    def forward(ctx, x, dtype, top):
        ctx.dtype, ctx.top = dtype, top
        return _round(x, dtype, top)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dtype, ctx.top), None, None


def _round(x, dtype, top):
    if top is None:
        return x.to(dtype).to(x.dtype)
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


def bf16_cast(x: torch.Tensor) -> torch.Tensor:
    """x, and its gradient, rounded through bf16: the reference at the
    precision the configurations state, a witness of what that rounding
    alone reads."""
    return _Round.apply(x, torch.bfloat16, None)


def fp8_cast(x: torch.Tensor) -> torch.Tensor:
    """x, and its gradient, rounded through fp8 e4m3, scaled per tensor."""
    return _Round.apply(x, torch.float8_e4m3fn, E4M3_MAX)
