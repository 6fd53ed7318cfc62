"""Per-level detection head towers, counterpart of
``rangedet_tpu/models/head.py`` (reference RangeRpnHead.get_fpn_output,
rangedet/symbol/head/builder.py:198-266), train and eval.

Each FPN level has its own cls and reg towers of 3x3 conv-BN-relu layers,
chained through PendingBN so each conv's BN apply + relu runs in the next
conv's input load, then 1x1 projections to ``num_classes`` logits and
``num_classes * num_reg_delta`` deltas. The projections add their bias in
the compute dtype and the outputs are cast to f32.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from .layers import ConvNormRelu, conv1x1_bhcw, materialize, normal_

_GAUSS_STD = 0.01


class RangeRpnHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 1,
                 num_reg_delta: int = 8, cls_conv_layers: int = 4,
                 cls_conv_channel: int = 128, reg_conv_layers: int = 4,
                 reg_conv_channel: int = 128,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.levels = len(in_channels)
        self.tower_names: List[Tuple[List[str], List[str]]] = []
        for lvl, cin in enumerate(in_channels):
            towers = []
            for kind, n, c in (("cls", cls_conv_layers, cls_conv_channel),
                               ("reg", reg_conv_layers, reg_conv_channel)):
                names, ci = [], cin
                for i in range(n):
                    name = f"{kind}_conv_{i}_lvl_{lvl}"
                    self.add_module(name, ConvNormRelu(
                        ci, c, dtype=dtype, emit_pending=True,
                        init_std=_GAUSS_STD))
                    names.append(name)
                    ci = c
                towers.append((names, ci))
            (cls_names, cls_c), (reg_names, reg_c) = towers
            self.tower_names.append((cls_names, reg_names))
            for name, ci, co in (
                (f"cls_logit_lvl_{lvl}", cls_c, num_classes),
                (f"reg_delta_lvl_{lvl}", reg_c, num_classes * num_reg_delta),
            ):
                self.register_parameter(f"{name}_weight", nn.Parameter(
                    torch.empty(co, ci, 1, 1)))
                self.register_parameter(f"{name}_bias", nn.Parameter(
                    torch.zeros(co)))

    def init_from(self, g: torch.Generator) -> None:
        for lvl in range(self.levels):
            for name in (f"cls_logit_lvl_{lvl}", f"reg_delta_lvl_{lvl}"):
                normal_(getattr(self, f"{name}_weight"), _GAUSS_STD, g)
                with torch.no_grad():
                    getattr(self, f"{name}_bias").zero_()

    def _project(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w = getattr(self, f"{name}_weight")[:, :, 0, 0].to(self.dtype)
        b = getattr(self, f"{name}_bias").to(self.dtype)
        out = conv1x1_bhcw(x, w) + b[None, None, :, None]
        return out.permute(0, 1, 3, 2).float()  # (B, H, W_s, K)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """feats: per level (B, H, C, W_s). Returns per level f32 logits
        (B, H, W_s, K) and deltas (B, H, W_s, 8K)."""
        cls_out, reg_out = [], []
        for lvl, feat in enumerate(feats):
            cls_names, reg_names = self.tower_names[lvl]
            cls_feat = reg_feat = feat.to(self.dtype)
            for name in cls_names:
                cls_feat = getattr(self, name)(cls_feat)
            for name in reg_names:
                reg_feat = getattr(self, name)(reg_feat)
            cls_out.append(self._project(materialize(cls_feat),
                                         f"cls_logit_lvl_{lvl}"))
            reg_out.append(self._project(materialize(reg_feat),
                                         f"reg_delta_lvl_{lvl}"))
        return cls_out, reg_out
