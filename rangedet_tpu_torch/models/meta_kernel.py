"""Meta-Kernel: coordinate-conditioned dynamic convolution (reference
rangedet/symbol/backbone/meta_kernel.py:166-240), in the materialized
(B, H, C, W) form of ``rangedet_tpu/models/meta_kernel.py:_bhcw``.

For each of the 9 taps of a pixel's 3x3 neighbourhood, the neighbour's
coordinates relative to the centre pass through a shared MLP 3 -> Cm -> C
(relu between), and the result multiplies the neighbour's features. The
output stacks the taps tap-major, channel-minor: (B, H, 9C, W). Coordinates
and features are zero-padded, so a border tap's relative coordinate is
``-centre``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import lecun_normal_


class MetaKernel(nn.Module):
    def __init__(self, channel_list: Sequence[int] = (32, 64),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if len(channel_list) != 2:
            raise ValueError(f"channel_list must be (Cm, C), got {channel_list}")
        c_mid, c_out = channel_list
        self.dtype = dtype
        self.mlp0 = nn.Linear(3, c_mid)
        self.mlp1 = nn.Linear(c_mid, c_out)

    def init_from(self, g: torch.Generator) -> None:
        for lin in (self.mlp0, self.mlp1):
            lecun_normal_(lin.weight, lin.in_features, g)
            with torch.no_grad():
                lin.bias.zero_()

    def forward(self, feat: torch.Tensor, coords: torch.Tensor
                ) -> torch.Tensor:
        """feat (B, H, C, W); coords (B, H, W, 3) -> (B, H, 9C, W)."""
        B, H, C, W = feat.shape
        if self.mlp1.out_features != C:
            raise ValueError(
                f"MetaKernel MLP ends at {self.mlp1.out_features}, "
                f"features have {C} channels"
            )
        d = self.dtype
        w0, b0 = self.mlp0.weight.to(d), self.mlp0.bias.to(d)  # (Cm, 3)
        w1, b1 = self.mlp1.weight.to(d), self.mlp1.bias.to(d)  # (C, Cm)
        cb = coords.permute(0, 1, 3, 2).to(d)  # (B, H, 3, W)
        cp = F.pad(cb, (1, 1, 0, 0, 1, 1))
        fp = F.pad(feat.to(d), (1, 1, 0, 0, 1, 1))
        outs = []
        for dy in range(3):
            for dx in range(3):
                rel = cp[:, dy:dy + H, :, dx:dx + W] - cb
                h = torch.einsum("bhcw,dc->bhdw", rel, w0)
                h = torch.relu(h + b0[None, None, :, None])
                wt = torch.einsum("bhdw,cd->bhcw", h, w1)
                wt = wt + b1[None, None, :, None]
                outs.append(fp[:, dy:dy + H, :, dx:dx + W] * wt)
        return torch.cat(outs, dim=2)
