"""3x3 convolution over (B, H, C, W) activations: the hand-written Hopper
kernel (``csrc/conv3x3_bhcw.cu``), its wrapper, and its plain version.

Counterpart of ``rangedet_tpu/ops/conv_pallas.py`` (forward only):
``conv3x3_bhcw(x, w)`` is the plain conv and ``conv3x3_bhcw(x, w, scale,
bias)`` the fused producer-BN ingest ``conv(relu(x*scale + bias))``, with
the affine in f32 and the activation rounded to ``x.dtype`` before the
multiply-accumulate, as ``conv_pallas._ingest`` does. ``stride_w=2`` is XLA
SAME for an even width (pad 0 left, 1 right), taken natively by the kernel
rather than through the TPU's phase packing.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build

# kernel launches since the last reset; the wrapper adds one per launch
LAUNCHES = 0

_CI_ALIGN = 16  # K-chunk of the kernel
_CO_ALIGN = 64  # Co tile of the kernel


def _check(x, w, scale, bias, stride_w):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, Ci, W), got {tuple(x.shape)}")
    Ci, W = x.shape[2], x.shape[3]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, Ci):
        raise ValueError(
            f"w must be (3, 3, {Ci}, Co) for x {tuple(x.shape)}, "
            f"got {tuple(w.shape)}"
        )
    if stride_w not in (1, 2):
        raise ValueError(f"stride_w must be 1 or 2, got {stride_w}")
    if stride_w == 2 and W % 2:
        raise ValueError(f"stride 2 needs an even width, got W={W}")
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias come together")
    if scale is not None and (
        tuple(scale.shape) != (Ci,) or tuple(bias.shape) != (Ci,)
    ):
        raise ValueError(f"scale/bias must be ({Ci},)")


def conv3x3_bhcw_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    stride_w: int = 1,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Reference: torch ops in f32 on the same operands, the ingest rounded
    to x.dtype; the output in ``out_dtype`` (default x.dtype).

    The result is exact f32 only with TF32 convolutions off
    (``torch.backends.cudnn.allow_tf32``) on a CUDA tensor."""
    _check(x, w, scale, bias, stride_w)
    a = x
    if scale is not None:
        af = x.float() * scale.float()[None, None, :, None]
        af = af + bias.float()[None, None, :, None]
        a = torch.relu(af).to(x.dtype)
    a = a.float().permute(0, 2, 1, 3)  # (B, Ci, H, W)
    wt = w.float().permute(3, 2, 0, 1)  # (Co, Ci, 3, 3)
    if stride_w == 1:
        y = F.conv2d(a, wt, padding=1)
    else:
        y = F.conv2d(F.pad(a, (0, 1, 1, 1)), wt, stride=(1, 2))
    return y.permute(0, 2, 1, 3).to(out_dtype or x.dtype).contiguous()


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) -> the kernel's (Co_pad, 9, Ci_pad), zero-padded to
    Co_pad % 64 == 0 and Ci_pad % 16 == 0."""
    Ci, Co = w.shape[2], w.shape[3]
    ci_pad = -(-Ci // _CI_ALIGN) * _CI_ALIGN
    co_pad = -(-Co // _CO_ALIGN) * _CO_ALIGN
    wp = torch.zeros((co_pad, 9, ci_pad), dtype=w.dtype, device=w.device)
    wp[:Co, :, :Ci] = w.permute(3, 0, 1, 2).reshape(Co, 9, Ci)
    return wp


def _launch(x, w, scale, bias, stride_w):
    global LAUNCHES
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(
            f"the kernel takes bf16 x and w, got {x.dtype} and {w.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if scale is not None:
        for name, t in (("scale", scale), ("bias", bias)):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise TypeError(f"{name} must be contiguous f32")
            if t.device != x.device:
                raise ValueError(f"{name} on {t.device}, x on {x.device}")
    B, H, Ci, W = x.shape
    Co = w.shape[3]
    if B * H > 65535:
        raise ValueError(f"B*H={B * H} exceeds the kernel's grid")
    lib = _build.load()
    wp = pack_weight(w)
    Wo = W if stride_w == 1 else W // 2
    y = torch.empty((B, H, Co, Wo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_bhcw_fwd(
            x.data_ptr(), wp.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            y.data_ptr(), B, H, Ci, W, Co, wp.shape[2], stride_w, stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3x3_bhcw_fwd launch failed: cudaError {err}")
    LAUNCHES += 1
    return y


def conv3x3_bhcw(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    stride_w: int = 1,
) -> torch.Tensor:
    """y = conv3x3(x or relu(x*scale + bias), w): (B, H, Ci, W) x
    (3, 3, Ci, Co) -> (B, H, Co, W // stride_w)."""
    _check(x, w, scale, bias, stride_w)
    if x.device.type == "cpu":
        return conv3x3_bhcw_plain(x, w, scale, bias, stride_w)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3x3 kernel for device {x.device}")
    return _launch(x, w, scale, bias, stride_w)
