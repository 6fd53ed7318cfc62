"""DLA-style backbone over the range image, counterpart of
``rangedet_tpu/models/dla_backbone.py`` (reference
rangedet/symbol/backbone/dla_backbone.py:13-175), (B, H, C, W). Train and
eval follow ``self.training``. With ``use_pallas_meta`` the Meta-Kernel
block trains in the fused form (the JAX MetaBlock with use_pallas=True,
layout "bhcw": ``ops/meta_block.py``) and evaluates in the materialized form
with the taps from their kernel (the JAX MetaKernel with use_pallas=True,
layout "nhwc": ``ops/meta_kernel.py``). Without it the block is the
materialized form with the taps' plain version, differentiated by autograd.

``remat`` runs every ResStage (res1 .. res3 and the four agg stages, not
the deconvs or the head) under ``torch.utils.checkpoint``, as JAX's
nn.remat over ResStage: its activations are recomputed in the backward.
``remat_meta`` does so for the materialized Meta-Kernel block only; the
fused block saves no 9C tensor (``rangedet_tpu/models/dla_backbone.py:
194-205``). Either way the running statistics move once a step
(``layers.frozen_stats``).

The network downsamples the width only (stride (1, 2) at res2a, res2,
res3a, res3) and re-aggregates with deconv "agg" nodes into per-stride
outputs {1: agg3 (+ input skip), 2: agg2a, 4: agg2, 16: res3}. The
Meta-Kernel block replaces the first conv of a configured unit (shipped:
res1_unit2).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..ops import meta_block
from .layers import (
    BatchNorm,
    ConvNormRelu,
    DeconvNormRelu,
    conv1x1_bhcw,
    conv3x3_consume,
    conv3x3_width,
    frozen_stats,
    lecun_normal_,
)
from .meta_kernel import MetaKernel

DEFAULT_NUM_BLOCK = {
    "res1": 2, "res2a": 3, "res2": 3, "res3a": 5, "res3": 5,
    "agg1": 2, "agg2": 2, "agg2a": 1, "agg3": 2,
}
DEFAULT_NUM_FILTER = {
    "res1": 64, "res2a": 64, "res2": 128, "res3a": 128, "res3": 128,
    "agg1": 64, "agg2": 128, "agg2a": 64, "agg3": 64,
}
DEFAULT_META_UNITS = {
    "res1_unit2": dict(channel_list=(32, 64)),
}
# name -> (input branch, upsampled branch, deconv kernel, deconv stride)
AGG_NODES = (
    ("agg2", "res2", "res3", (3, 8), 4),
    ("agg1", "res1", "res2", (3, 8), 4),
    ("agg2a", "res2a", "agg2", (3, 4), 2),
    ("agg3", "agg1", "agg2a", (3, 4), 2),
)
LEVELS = {1: "agg3", 2: "agg2a", 4: "agg2", 16: "res3"}  # stride -> output
WIDTH_STRIDE = 16  # res2a, res2, res3a and res3 each halve the width
# the widest halo a deconv exchanges under width sharding, J + 2 columns
DECONV_HALO = max(k[1] // s + 2 for _, _, _, k, s in AGG_NODES)


def checkpointed(module: nn.Module, *args):
    """module(*args), its activations recomputed in the backward
    (non-reentrant ``torch.utils.checkpoint``) with its running statistics
    frozen there; a plain call where no gradient is taken."""
    if not (module.training and torch.is_grad_enabled()):
        return module(*args)
    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          frozen_stats(module)))


class MetaBlock(nn.Module):
    """Meta-Kernel -> BN -> relu -> 1x1 aggregation conv -> BN -> relu
    (reference meta_kernel_conv, dla_backbone.py:59-103).

    With ``use_pallas_meta``, training runs the fused block
    (``rangedet_tpu/models/dla_backbone.py:137-168``): the kernels' channel
    sums, meta_bn as a BatchNormFold, then the aggregation straight from
    the recomputed taps, so the (B, H, 9C, W) tensor never exists. Eval
    keeps the materialized form, as the JAX block does, and takes the taps
    from their kernel (``MetaKernelTaps``, as JAX's nhwc block with
    use_pallas does): kernel 7 -> meta_bn (running statistics) -> relu ->
    meta_agg. The parameters are the same in every form."""

    def __init__(self, channel_list: Sequence[int], features: int,
                 dtype: torch.dtype = torch.bfloat16,
                 use_pallas_meta: bool = False):
        super().__init__()
        c = channel_list[-1]
        self.dtype = dtype
        self.use_pallas_meta = use_pallas_meta
        self.meta_kernel = MetaKernel(channel_list, dtype, use_pallas_meta)
        self.meta_bn = BatchNorm(9 * c, dtype)
        self.meta_agg = ConvNormRelu(9 * c, features, kernel=1, dtype=dtype)

    @property
    def fused(self) -> bool:
        """Training in the fused form: with ``use_pallas_meta``, not under
        width sharding (``dla_backbone.py:96-99``)."""
        return (self.training and self.use_pallas_meta
                and self.meta_kernel.width_group is None)

    def forward(self, x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        with record_function("meta_block"):
            if self.fused:
                return self._fused(x, coords)
            mk = torch.relu(self.meta_bn(self.meta_kernel(x, coords)))
            return self.meta_agg(mk)

    def _fused(self, x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        B, H, _, W = x.shape
        x = x.to(self.dtype).contiguous()
        mk = self.meta_kernel
        mlp = (mk.mlp0.weight.t(), mk.mlp0.bias, mk.mlp1.weight.t(),
               mk.mlp1.bias)  # the JAX layout: (3, Cm), (Cm,), (Cm, C), (C,)
        cb = coords.permute(0, 1, 3, 2).to(x.dtype).contiguous()
        s1, s2 = meta_block.MetaStats.apply(x, cb, *mlp)
        s9, b9 = self.meta_bn.fold_sums(s1, s2, float(B * H * W))
        agg = self.meta_agg.weight[:, :, 0, 0].t()  # (9C, Co)
        y = meta_block.MetaAgg.apply(x, cb, *mlp, s9, b9, agg)
        return torch.relu(self.meta_agg.bn(y))


class BasicBlock(nn.Module):
    """Residual basic block. A unit1 projects the shortcut with a 1x1 conv
    and carries the stage's stride on conv2 (conv1 is stride 1). conv1's BN
    apply + relu is deferred into conv2's kernel input load. With
    ``remat_meta`` the materialized Meta-Kernel block is checkpointed. With
    a ``width_group`` conv2 is ``layers.conv3x3_width``."""

    def __init__(self, in_channels: int, features: int, stride_w: int = 1,
                 proj: bool = False,
                 meta_channel_list: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 use_pallas_meta: bool = False, remat_meta: bool = False):
        super().__init__()
        self.stride_w, self.proj, self.dtype = stride_w, proj, dtype
        self.remat_meta = remat_meta
        if meta_channel_list is not None:
            self.meta_block = MetaBlock(meta_channel_list, features, dtype,
                                        use_pallas_meta)
            self.conv1 = None
        else:
            self.meta_block = None
            self.conv1 = ConvNormRelu(in_channels, features, dtype=dtype,
                                      emit_pending=True)
        self.conv2_weight = nn.Parameter(torch.empty(features, features, 3, 3))
        self.bn2 = BatchNorm(features, dtype)
        if proj:
            self.sc_weight = nn.Parameter(
                torch.empty(features, in_channels, 1, 1))
            self.sc_bn = BatchNorm(features, dtype)
        self.width_group = None

    def init_from(self, g: torch.Generator) -> None:
        lecun_normal_(self.conv2_weight, self.conv2_weight[0].numel(), g)
        if self.proj:
            lecun_normal_(self.sc_weight, self.sc_weight.shape[1], g)

    def forward(self, x: torch.Tensor, coords: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if self.meta_block is not None:
            if self.remat_meta and not self.meta_block.fused:
                y = checkpointed(self.meta_block, x, coords)
            else:
                y = self.meta_block(x, coords)
        else:
            y = self.conv1(x)
        if self.width_group is not None:
            y, sums = conv3x3_width(y, self.conv2_weight, self.stride_w,
                                    self.dtype, self.width_group), None
        else:
            y, sums = conv3x3_consume(y, self.conv2_weight, self.stride_w,
                                      self.dtype, want_stats=self.training)
        y = self.bn2(y, sums)
        if self.proj:
            sc = conv1x1_bhcw(x.to(self.dtype),
                              self.sc_weight[:, :, 0, 0].to(self.dtype),
                              self.stride_w)
            sc = self.sc_bn(sc)
        else:
            sc = x
        return torch.relu(y + sc)


class ResStage(nn.Module):
    """num_block BasicBlocks named ``{name}_unit{i}``; unit1 projects and
    carries the stride (reference dla_backbone.py:106-114)."""

    def __init__(self, name: str, num_block: int, in_channels: int,
                 features: int, stride_w: int = 1,
                 meta_units: Optional[Mapping[str, dict]] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 use_pallas_meta: bool = False, remat_meta: bool = False):
        super().__init__()
        self.unit_names: List[str] = []
        for i in range(1, num_block + 1):
            unit = f"{name}_unit{i}"
            meta = (meta_units or {}).get(unit)
            self.add_module(unit, BasicBlock(
                in_channels if i == 1 else features, features,
                stride_w=stride_w if i == 1 else 1, proj=(i == 1),
                meta_channel_list=meta["channel_list"] if meta else None,
                dtype=dtype, use_pallas_meta=use_pallas_meta,
                remat_meta=remat_meta,
            ))
            self.unit_names.append(unit)

    def forward(self, x: torch.Tensor, coords: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        for unit in self.unit_names:
            x = getattr(self, unit)(x, coords)
        return x


class DLABackbone(nn.Module):
    """Returns the (B, H, C, W) features of the requested fpn_strides."""

    def __init__(self, fpn_strides: Sequence[int] = (1, 2, 4),
                 num_block: Optional[Mapping[str, int]] = None,
                 num_filter: Optional[Mapping[str, int]] = None,
                 meta_units: Optional[Mapping[str, dict]] = None,
                 add_data_sc: bool = True, in_channels: int = 8,
                 dtype: torch.dtype = torch.bfloat16,
                 use_pallas_meta: bool = False, remat: bool = False,
                 remat_meta: bool = False):
        super().__init__()
        nb = dict(num_block or DEFAULT_NUM_BLOCK)
        nf = dict(num_filter or DEFAULT_NUM_FILTER)
        meta = DEFAULT_META_UNITS if meta_units is None else meta_units
        self.fpn_strides = tuple(fpn_strides)
        self.add_data_sc, self.dtype = add_data_sc, dtype
        self.remat = remat

        ch = {"data": in_channels}
        for name, src, stride in (("res1", "data", 1), ("res2a", "res1", 2),
                                  ("res2", "res2a", 2), ("res3a", "res2", 2),
                                  ("res3", "res3a", 2)):
            self.add_module(name, ResStage(name, nb[name], ch[src], nf[name],
                                           stride, meta, dtype,
                                           use_pallas_meta, remat_meta))
            ch[name] = nf[name]
        for name, const, up, kernel, stride in AGG_NODES:
            self.add_module(f"{name}_deconv", DeconvNormRelu(
                ch[up], nf[name], kernel, stride, dtype))
            if ch[const] != nf[name]:
                raise ValueError(f"{name}: {const} has {ch[const]} channels, "
                                 f"the deconv {nf[name]}")
            self.add_module(name, ResStage(name, nb[name], nf[name], nf[name],
                                           1, meta, dtype, use_pallas_meta,
                                           remat_meta))
            ch[name] = nf[name]
        self.out_channels = [
            ch[LEVELS[s]] + (in_channels if s == 1 and add_data_sc else 0)
            for s in self.fpn_strides
        ]

    def forward(self, data: torch.Tensor, coords: torch.Tensor
                ) -> List[torch.Tensor]:
        """data (B, H, W, 8), coords (B, H, W, 3)."""
        data = data.to(self.dtype).permute(0, 1, 3, 2).contiguous()
        f: Dict[str, torch.Tensor] = {"data": data}
        f["res1"] = self._stage("res1", data, coords)
        for name, src in (("res2a", "res1"), ("res2", "res2a"),
                          ("res3a", "res2"), ("res3", "res3a")):
            f[name] = self._stage(name, f[src])
        for name, const, up, _, _ in AGG_NODES:
            x_up = getattr(self, f"{name}_deconv")(f[up])
            f[name] = self._stage(name, f[const] + x_up)
        if self.add_data_sc:
            f["agg3"] = torch.cat([data, f["agg3"]], dim=2)
        return [f[LEVELS[s]] for s in self.fpn_strides]

    def _stage(self, name: str, x: torch.Tensor,
               coords: Optional[torch.Tensor] = None) -> torch.Tensor:
        stage = getattr(self, name)
        return checkpointed(stage, x, coords) if self.remat else stage(
            x, coords)
