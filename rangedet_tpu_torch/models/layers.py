"""Conv building blocks in the (B, H, C, W) layout, counterpart of the bhcw
path of ``rangedet_tpu/models/layers.py``.

Convs compute in ``dtype`` (bf16 on the card) from f32 parameters, cast at
use. BatchNorm has MXNet semantics (eps 1e-3, momentum 0.9): in eval it
folds the running statistics into an f32 (scale, bias); in training it
uses the batch statistics in f32, from the producer kernel's (sum y,
sum y^2) when given. A layer that emits ``PendingBN`` defers its BN apply +
relu to the consumer, whose 3x3 conv fuses it into the kernel's input load
(``ops/conv3x3.py``); gradients flow through all of it.

With a sync group (``set_sync_group``) a training BatchNorm sums its
statistics over the group's ranks, as JAX's BatchNorm psums them over
``bn_sync_axis`` (``rangedet_tpu/models/layers.py:143-162,200-211``):
global sync-BN over the per-rank batches, the sums still the producer
kernel's.

With a width group (``set_width_group``; width sharding, the counterpart
of JAX's ``width_axis``) a 3x3 conv or a deconv exchanges halo columns with
its neighbours (``parallel/halo.py``), runs the unmodified op on the
extended slice and keeps the interior (``conv3x3_width``,
``rangedet_tpu/models/layers.py:464-506``; ``DeconvNormRelu``,
``:785-820``). A PendingBN input is materialized before the exchange, and
the conv's in-kernel statistics are not asked for (they would count the
halo columns): the BatchNorm takes them from the exact-width tensor, as
means over the ranks of the sync group, which must then be the whole
world. Every rank holds the same number of pixels (equal shards,
``parallel/dist.py:check_width_split``), so those means are the global
batch's.

Parameter layouts are PyTorch's: conv weights (Co, Ci, kh, kw) as in
``nn.Conv2d``, deconv weights (Ci, Co, kh, kw) as in ``nn.ConvTranspose2d``.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as tdist
from torch import nn

from ..ops import conv3x3 as _conv
from ..parallel.dist import all_reduce_sum
from ..parallel.halo import width_halo

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.9


class PendingBN(NamedTuple):
    """A conv output whose BatchNorm apply + relu is deferred: the consumer
    computes ``relu(y * scale + bias)`` on load. ``scale``/``bias`` are the
    f32 BN fold (C,)."""

    y: torch.Tensor  # raw conv output (B, H, C, W)
    scale: torch.Tensor
    bias: torch.Tensor

    def materialize(self) -> torch.Tensor:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (self.y, self.scale, self.bias)):
            return _BnReluMat.apply(self.y, self.scale, self.bias)
        return _bn_relu(self.y, self.scale, self.bias)


def _bn_relu(y, scale, bias):
    a = y.float() * scale[None, None, :, None] + bias[None, None, :, None]
    return torch.relu(a).to(y.dtype)


class _BnReluMat(torch.autograd.Function):
    """relu(y*scale + bias) with the backward of ``_bn_relu_mat``
    (``rangedet_tpu/models/layers.py:48-85``): every full-size intermediate
    stays in y.dtype, f32 only inside the elementwise math and the two
    per-channel reductions."""

    @staticmethod
    def forward(ctx, y, scale, bias):
        ctx.save_for_backward(y, scale, bias)
        return _bn_relu(y, scale, bias)

    @staticmethod
    def backward(ctx, g):
        y, scale, bias = ctx.saved_tensors
        sb = scale[None, None, :, None]
        yf = y.float()
        pos = yf * sb + bias[None, None, :, None] > 0.0
        gz = torch.where(pos, g, torch.zeros_like(g))  # y.dtype
        dy = (gz.float() * sb).to(y.dtype)
        gzf = gz.float()
        return dy, (gzf * yf).sum(dim=(0, 1, 3)), gzf.sum(dim=(0, 1, 3))


MaybePending = Union[torch.Tensor, PendingBN]


def materialize(x: MaybePending) -> torch.Tensor:
    return x.materialize() if isinstance(x, PendingBN) else x


def lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """Normal(0, 1/fan_in) truncated at two standard deviations, like
    flax's lecun_normal."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


def normal_(w: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        w.normal_(0.0, std, generator=g)


class BatchNormFold(nn.Module):
    """BatchNorm that takes the per-channel sums and returns only the f32
    fold (scale, bias), for a kernel that applies it without materializing
    the tensor (``rangedet_tpu/models/layers.py:181-222``, the fused
    Meta-Kernel block's). Training: mean = s1/n, var = s2/n - mean^2
    clamped at 0, running statistics moved by momentum 0.9 (not while
    ``frozen``: a forward recomputed in the backward, see ``frozen_stats``);
    eval: the running statistics. Parameter and buffer names are
    BatchNorm's, so state dicts are interchangeable.

    ``sync_group`` (None: this rank's batch alone): in training, the sums
    are summed over the group's ranks (``parallel/dist.py:AllReduceSum``,
    whose backward sums their cotangent too) and the count multiplied by
    the world size, so every rank folds the global batch's statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.frozen = 0  # depth of the frozen_stats contexts around it
        self.sync_group = None

    def forward(self, s1: torch.Tensor, s2: torch.Tensor, count: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.training:
            return self._fold(self.running_mean, self.running_var)
        if self.sync_group is not None:
            s1, s2, world = self._sync(s1, s2)
            count = count * world
        mean = s1 / count
        return self._update_fold(mean, s2 / count - mean * mean)

    def _sync(self, a: torch.Tensor, b: torch.Tensor):
        """(a, b) summed over the sync group, in one all-reduce, and the
        group's size."""
        s = all_reduce_sum(torch.stack([a, b]), self.sync_group)
        return s[0], s[1], tdist.get_world_size(self.sync_group)

    def _update_fold(self, mean, var):
        var = var.clamp(min=0.0)
        if self.frozen:
            return self._fold(mean, var)
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1 - BN_MOMENTUM) * var)
        return self._fold(mean, var)

    def _fold(self, mean, var):
        inv = torch.rsqrt(var + BN_EPSILON) * self.weight
        return inv, self.bias - mean * inv


def set_sync_group(module: nn.Module, group) -> None:
    """Every BatchNorm of ``module`` sums its training statistics over
    ``group`` (None: each rank its own), the counterpart of building the
    JAX model from ``cfg.replace(bn_sync_axis="data")``. Eval, on the
    running statistics, is unaffected."""
    for m in module.modules():
        if isinstance(m, BatchNormFold):
            m.sync_group = group


def sync_groups(module: nn.Module) -> set:
    """The sync groups of ``module``'s BatchNorms (a set of one, where
    ``set_sync_group`` set them all)."""
    return {m.sync_group for m in module.modules()
            if isinstance(m, BatchNormFold)}


def set_width_group(module: nn.Module, group) -> None:
    """Every width-aware layer of ``module`` (those with a ``width_group``:
    the 3x3 ConvNormRelu, DeconvNormRelu, the BasicBlock's conv2, the
    Meta-Kernel) exchanges its halos over ``group`` (None: the unsharded
    ops), the counterpart of building the JAX model with
    ``width_axis="model"``."""
    for m in module.modules():
        if hasattr(m, "width_group"):
            m.width_group = group


def width_groups(module: nn.Module) -> set:
    """The width groups of ``module``'s width-aware layers."""
    return {m.width_group for m in module.modules()
            if hasattr(m, "width_group")}


@contextlib.contextmanager
def without_width(module: nn.Module):
    """Within it, ``module`` runs the unsharded ops (the full frame on every
    rank, as the train CLI's validation runs it); the width groups come
    back after."""
    saved = [(m, m.width_group) for m in module.modules()
             if hasattr(m, "width_group")]
    for m, _ in saved:
        m.width_group = None
    try:
        yield
    finally:
        for m, g in saved:
            m.width_group = g


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Within it, no BatchNorm of ``module`` moves its running statistics.
    A checkpointed forward runs again in the backward (``torch.utils.
    checkpoint``); that recompute runs in this context, so the statistics
    move once a step, as JAX's functional batch_stats do."""
    bns = [m for m in module.modules() if isinstance(m, BatchNormFold)]
    for m in bns:
        m.frozen += 1
    try:
        yield
    finally:
        for m in bns:
            m.frozen -= 1


class BatchNorm(BatchNormFold):
    """BatchNorm over channel axis 2 (``rangedet_tpu/models/layers.py:
    102-178``). Eval: the running statistics. Training: the batch's, in
    f32, from ``sums`` = (sum x, sum x^2) when the producer kernel gave them
    and from the tensor otherwise; var = E[x^2] - mean^2 clamped at 0; the
    running statistics move by momentum 0.9. With a sync group the tensor's
    statistics are summed as its means (E[x], E[x^2]) over the ranks, whose
    counts are equal, and divided by the world size: a group of one is the
    plain BatchNorm bit for bit.

    With ``affine_out`` it returns ``PendingBN(x, scale, bias)`` with the f32
    fold; otherwise ``x * mul + add`` in ``dtype``, with the fold cast to
    it. ``fold_sums`` is the BatchNormFold of the same parameters."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 affine_out: bool = False):
        super().__init__(channels)
        self.dtype = dtype
        self.affine_out = affine_out

    fold_sums = BatchNormFold.forward

    def fold(self, sums=None, x: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.training:
            return self._fold(self.running_mean, self.running_var)
        sync = self.sync_group is not None
        if sums is not None:
            n = x.numel() // x.shape[2]
            s1, s2 = sums
            if sync:
                s1, s2, world = self._sync(s1, s2)
                n = n * world
            mean = s1 / n
            var = s2 / n - mean * mean
        else:
            xf = x.float()
            mean = xf.mean(dim=(0, 1, 3))
            msq = (xf * xf).mean(dim=(0, 1, 3))
            if sync:
                mean, msq, world = self._sync(mean, msq)
                mean, msq = mean / world, msq / world
            var = msq - mean * mean
        return self._update_fold(mean, var)

    def forward(self, x: torch.Tensor, sums=None) -> MaybePending:
        inv, add = self.fold(sums, x)
        if self.affine_out:
            return PendingBN(x.to(self.dtype), inv, add)
        mul = inv.to(self.dtype)[None, None, :, None]
        add = add.to(self.dtype)[None, None, :, None]
        return x.to(self.dtype) * mul + add


def conv3x3_consume(x: MaybePending, weight: torch.Tensor, stride_w: int,
                    dtype: torch.dtype, want_stats: bool = False):
    """3x3 conv of a tensor or a PendingBN (its BN apply + relu fused into
    the kernel's input load). weight: (Co, Ci, 3, 3) f32, handed to the
    kernel wrapper as (3, 3, Ci, Co). Returns (y, sums): with
    ``want_stats`` sums = (sum y, sum y^2) per channel from the kernel,
    else None."""
    w = weight.permute(2, 3, 1, 0).to(dtype)
    if isinstance(x, PendingBN):
        out = _conv.conv3x3(x.y, w, x.scale, x.bias, stride_w, want_stats)
    else:
        out = _conv.conv3x3(x.to(dtype).contiguous(), w, None, None,
                            stride_w, want_stats)
    if want_stats:
        return out[0], out[1:]
    return out, None


def conv3x3_width(x: MaybePending, weight: torch.Tensor, stride_w: int,
                  dtype: torch.dtype, group) -> torch.Tensor:
    """``conv3x3_consume`` on a width shard (``conv3x3_bhcw_width_sharded``):
    the halo from the neighbours in ``group``, the conv kernel on the
    extended slice, the interior. Stride 1: a 1-column halo, the conv on
    W+2, columns [1, W+1). Stride 2 (SAME pads 0 left and 1 right at an
    even width): [x, right halo, one zero column], an even W+2 as the
    kernel's stride-2 path needs, and the first W/2 outputs: y[u] reads
    columns 2u .. 2u+2 <= W, so the zero column is never read. A PendingBN
    input is materialized first (the halo lives in the activated domain);
    no in-kernel statistics."""
    x = materialize(x).to(dtype)
    W = x.shape[-1]
    xe = width_halo(x, 1, group)
    if stride_w == 1:
        y, _ = conv3x3_consume(xe, weight, 1, dtype)
        return y[..., 1:-1]
    xe = torch.nn.functional.pad(xe[..., 1:], (0, 1))
    y, _ = conv3x3_consume(xe, weight, 2, dtype)
    return y[..., :W // 2]


def conv1x1_bhcw(x: torch.Tensor, weight: torch.Tensor, stride_w: int = 1
                 ) -> torch.Tensor:
    """1x1 conv on (B, H, Ci, W); weight (Co, Ci) in x's dtype. A strided
    1x1 conv reads columns 0, s, 2s, ..."""
    if stride_w != 1:
        x = x[..., ::stride_w]
    return torch.einsum("bhiw,oi->bhow", x, weight)


class ConvNormRelu(nn.Module):
    """3x3 or 1x1 conv (stride 1) + BN + relu. With a ``width_group`` the
    3x3 conv is ``conv3x3_width`` and its BatchNorm takes the statistics
    from the tensor."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.bfloat16,
                 emit_pending: bool = False, init_std: Optional[float] = None):
        super().__init__()
        if kernel not in (1, 3):
            raise ValueError(f"kernel must be 1 or 3, got {kernel}")
        self.kernel, self.dtype = kernel, dtype
        self.init_std = init_std  # None: lecun normal
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kernel, kernel))
        self.bn = BatchNorm(features, dtype, affine_out=emit_pending)
        self.width_group = None

    def init_from(self, g: torch.Generator) -> None:
        if self.init_std is None:
            lecun_normal_(self.weight, self.weight[0].numel(), g)
        else:
            normal_(self.weight, self.init_std, g)

    def forward(self, x: MaybePending) -> MaybePending:
        if self.kernel == 1:
            x = materialize(x).to(self.dtype)
            y = conv1x1_bhcw(x, self.weight[:, :, 0, 0].to(self.dtype))
            out = self.bn(y)
        elif self.width_group is not None:
            out = self.bn(conv3x3_width(x, self.weight, 1, self.dtype,
                                        self.width_group))
        else:
            y, sums = conv3x3_consume(x, self.weight, 1, self.dtype,
                                      want_stats=self.training)
            out = self.bn(y, sums)
        return out if isinstance(out, PendingBN) else torch.relu(out)


def pack_deconv_phases(k: torch.Tensor, stride_w: int) -> torch.Tensor:
    """SAME transposed conv (kh=3, kw=2s) as ONE stride-1 3x3 conv with s*Co
    outputs at the input resolution: output phase p (columns p, p+s, ...)
    is a 3x2-tap conv whose column offsets lie in {-1, 0, +1}
    (``rangedet_tpu/models/layers.py:deconv_bhcw_phase_conv``).

    k: (3, kw, Ci, Co), the JAX package's HWIO form. Returns (3, 3, Ci, s*Co).
    """
    kh, kw, Ci, Co = k.shape
    s = stride_w
    if kh != 3 or kw != 2 * s:
        raise ValueError(f"deconv kernel ({kh}, {kw}) with stride {s}")
    pad = (kw - s) // 2
    J = kw // s
    kp = k.new_zeros((3, 3, Ci, s * Co))
    for p in range(s):
        k0 = (p + pad) % s
        D = (p + pad - k0) // s
        for j in range(J):
            k_idx = k0 + j * s
            off = D - j
            kp[:, off + 1, :, p * Co:(p + 1) * Co] = k[:, kw - 1 - k_idx]
    return kp


class DeconvNormRelu(nn.Module):
    """Transposed conv with stride (1, s) and SAME padding + BN + relu, the
    FPN aggregation upsampler (reference deconvs (3,8)/(1,4)/pad (1,2) and
    (3,4)/(1,2)/pad (1,1), i.e. ``F.conv_transpose2d`` with those paddings).
    Runs as the phase-packed 3x3 conv on the kernel, then an interleave.

    With a ``width_group`` it runs ``deconv_width``."""

    def __init__(self, in_channels: int, features: int,
                 kernel: Tuple[int, int], stride_w: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride_w, self.dtype = stride_w, dtype
        self.weight = nn.Parameter(torch.empty(in_channels, features, *kernel))
        self.bn = BatchNorm(features, dtype)
        self.width_group = None

    def init_from(self, g: torch.Generator) -> None:
        kh, kw = self.weight.shape[2:]
        lecun_normal_(self.weight, kh * kw * self.weight.shape[0], g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if self.width_group is not None:
            y = deconv_width(x, w, self.stride_w, self.width_group)
        else:
            y = deconv_bhcw(x.contiguous(), w, self.stride_w)
        return torch.relu(self.bn(y))


def deconv_bhcw(x: torch.Tensor, weight: torch.Tensor, stride_w: int
                ) -> torch.Tensor:
    """SAME transposed conv, stride (1, s), on (B, H, Ci, W) through the
    phase-packed 3x3 conv kernel. weight: (Ci, Co, 3, 2s) in
    ``nn.ConvTranspose2d``'s layout, same dtype as x. -> (B, H, Co, W*s).
    Its gradients run through the same conv's backward kernels; autograd
    carries them through the packing and the interleave."""
    B, H, _, W = x.shape
    s = stride_w
    Co = weight.shape[1]
    # the JAX form (kh, kw, Ci, Co) correlates with the flipped kernel
    kp = pack_deconv_phases(weight.flip(2, 3).permute(2, 3, 0, 1), s)
    y2 = _conv.conv3x3(x, kp)  # (B, H, s*Co, W)
    y = y2.reshape(B, H, s, Co, W).permute(0, 1, 3, 4, 2)
    return y.reshape(B, H, Co, W * s)


def deconv_width(x: torch.Tensor, weight: torch.Tensor, stride_w: int,
                 group) -> torch.Tensor:
    """``deconv_bhcw`` on a width shard (``rangedet_tpu/models/
    layers.py:808-818``): a halo of J+2 = kw // s + 2 columns from the
    neighbours in ``group`` (the phase decomposition's own zero margin in
    JAX's ``deconv_bhcw``), the deconv on the extended slice, and the
    interior: s*W columns from s*(J+2) on."""
    s = stride_w
    halo = weight.shape[3] // s + 2
    y = deconv_bhcw(width_halo(x, halo, group).contiguous(), weight, s)
    return y[..., s * halo:-s * halo]
