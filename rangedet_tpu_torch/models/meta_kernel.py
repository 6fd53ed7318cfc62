"""Meta-Kernel: coordinate-conditioned dynamic convolution (reference
rangedet/symbol/backbone/meta_kernel.py:166-240), in the materialized
(B, H, C, W) form of ``rangedet_tpu/models/meta_kernel.py``.

For each of the 9 taps of a pixel's 3x3 neighbourhood, the neighbour's
coordinates relative to the centre pass through a shared MLP 3 -> Cm -> C
(relu between), and the result multiplies the neighbour's features. The
output stacks the taps tap-major, channel-minor: (B, H, 9C, W). Coordinates
and features are zero-padded, so a border tap's relative coordinate is
``-centre``. The op is ``ops/meta_kernel.py``: with ``use_pallas_meta`` its
kernel (``MetaKernelTaps``, the JAX ``use_pallas=True`` path), otherwise
its plain version (the XLA form).

With a ``width_group`` (width sharding, ``rangedet_tpu/models/
meta_kernel.py:55-67``) the features and the coordinates both take a
1-column halo from the neighbours (a neighbour tap and its relative
coordinate cross the shard's edge), the unmodified op runs on the extended
slice, and the interior is kept.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import meta_kernel as ops_mk
from ..parallel.halo import width_halo
from .layers import lecun_normal_


class MetaKernel(nn.Module):
    def __init__(self, channel_list: Sequence[int] = (32, 64),
                 dtype: torch.dtype = torch.bfloat16,
                 use_pallas_meta: bool = False):
        super().__init__()
        if len(channel_list) != 2:
            raise ValueError(f"channel_list must be (Cm, C), got {channel_list}")
        c_mid, c_out = channel_list
        self.dtype = dtype
        self.use_pallas_meta = use_pallas_meta
        self.mlp0 = nn.Linear(3, c_mid)
        self.mlp1 = nn.Linear(c_mid, c_out)
        self.width_group = None

    def init_from(self, g: torch.Generator) -> None:
        for lin in (self.mlp0, self.mlp1):
            lecun_normal_(lin.weight, lin.in_features, g)
            with torch.no_grad():
                lin.bias.zero_()

    def forward(self, feat: torch.Tensor, coords: torch.Tensor
                ) -> torch.Tensor:
        """feat (B, H, C, W); coords (B, H, W, 3) -> (B, H, 9C, W)."""
        C = feat.shape[2]
        if self.mlp1.out_features != C:
            raise ValueError(
                f"MetaKernel MLP ends at {self.mlp1.out_features}, "
                f"features have {C} channels"
            )
        feat, cb = feat.to(self.dtype), coords.permute(0, 1, 3, 2)
        group = self.width_group
        if group is not None:
            feat, cb = width_halo(feat, 1, group), width_halo(cb, 1, group)
        args = (feat, cb, self.mlp0.weight.t(), self.mlp0.bias,
                self.mlp1.weight.t(),
                self.mlp1.bias)  # the JAX layout: (3, Cm), (Cm,), (Cm, C)
        if self.use_pallas_meta:
            out = ops_mk.MetaKernelTaps.apply(*args)
        else:
            out = ops_mk.meta_kernel_taps_plain(*args)
        return out if group is None else out[..., 1:-1]
