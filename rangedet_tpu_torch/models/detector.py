"""RangeDet detector: model assembly and the inference path, counterpart of
``rangedet_tpu/models/detector.py`` (RangeDet and run_inference).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..ops import boxes as ops_boxes
from ..ops import decode as ops_decode
from ..ops import nms as ops_nms
from .dla_backbone import DLABackbone
from .head import RangeRpnHead


class RangeDet(nn.Module):
    """Backbone + head. forward returns per-level f32 (cls_logits, deltas),
    shapes (B, H, W_s, K) and (B, H, W_s, 8K)."""

    def __init__(self, fpn_strides: Sequence[int] = (1, 2, 4),
                 num_classes: int = 1, num_reg_delta: int = 8,
                 num_block: Optional[dict] = None,
                 num_filter: Optional[dict] = None,
                 meta_units: Optional[dict] = None, add_data_sc: bool = True,
                 cls_conv_layers: int = 4, cls_conv_channel: int = 128,
                 reg_conv_layers: int = 4, reg_conv_channel: int = 128,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fpn_strides = tuple(fpn_strides)
        self.backbone = DLABackbone(fpn_strides, num_block, num_filter,
                                    meta_units, add_data_sc, dtype=dtype)
        self.head = RangeRpnHead(
            self.backbone.out_channels, num_classes, num_reg_delta,
            cls_conv_layers, cls_conv_channel, reg_conv_layers,
            reg_conv_channel, dtype,
        )

    def init_from(self, g: torch.Generator) -> None:
        """Seeded initialisation of every conv, deconv, MLP and projection
        weight, in module registration order. BatchNorm keeps the identity
        it is constructed with (scale 1, bias 0, mean 0, var 1)."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_from"):
                m.init_from(g)

    def forward(self, input_data: torch.Tensor, coords: torch.Tensor):
        """input_data (B, H, W, 8), coords (B, H, W, 3)."""
        W = input_data.shape[2]
        if W % max(self.fpn_strides):
            raise ValueError(
                f"range-image width {W} must be divisible by the largest FPN "
                f"stride {max(self.fpn_strides)} (pad W, cf. pad_field)"
            )
        return self.head(self.backbone(input_data, coords))


def run_inference(
    cls_logits: List[torch.Tensor],
    reg_deltas: List[torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg,
) -> Dict[str, Any]:
    """Per class: concat levels -> masked top-k -> decode -> weighted NMS ->
    box8_eval rows [cx, cy, cz, l, w, h, yaw, score].

    The candidate set is the top ``min(device_topk, pre_nms_top_n, N)``
    masked scores, ordered by a stable sort; a candidate is valid when its
    score is strictly above min_score (reference tools/test.py:200).
    ``truncated`` flags a frame whose weakest kept candidate still clears
    min_score, i.e. where the cap bound. batch holds pc_s{s} and mask_s{s}.
    Returns {class_name: {"boxes": (B, post_nms, 8), "valid": (B, post_nms),
    "truncated": (B,)}}.
    """
    B = cls_logits[0].shape[0]
    K = cfg.num_classes
    scores = torch.cat(
        [torch.sigmoid(l).reshape(B, -1, K) for l in cls_logits], dim=1)
    deltas = torch.cat([d.reshape(B, -1, K, 8) for d in reg_deltas], dim=1)
    pc = torch.cat(
        [batch[f"pc_s{s}"].reshape(B, -1, 3) for s in cfg.fpn_strides], 1)
    mask = torch.cat(
        [batch[f"mask_s{s}"].reshape(B, -1) for s in cfg.fpn_strides], 1)

    results = {}
    for k, name in enumerate(cfg.class_names):
        topk = min(cfg.device_topk.get(name, 4096),
                   cfg.pre_nms_top_n.get(name, 50000), scores.shape[1])
        min_score = cfg.min_score[name]
        masked = torch.where(mask > 0, scores[..., k],
                             torch.zeros_like(scores[..., k]))
        idx = torch.sort(-masked, dim=1, stable=True).indices[:, :topk]
        top_scores = torch.gather(masked, 1, idx)
        top_deltas = torch.gather(deltas[:, :, k], 1,
                                  idx[..., None].expand(-1, -1, 8))
        top_pc = torch.gather(pc, 1, idx[..., None].expand(-1, -1, 3))
        box11 = ops_boxes.box10_to_box11(
            ops_decode.decode_boxes(top_deltas, top_pc))
        valid = top_scores > min_score
        truncated = top_scores[:, -1] > min_score
        out12, out_valid = ops_nms.weighted_nms(
            box11, top_scores, valid,
            thresh=cfg.wnms_thr_lo, thresh_vote=cfg.wnms_thr_hi,
            max_keep=cfg.post_nms_top_n[name], iou_3d=cfg.wnms_is_3d,
            block=cfg.wnms_block,
        )
        results[name] = {"boxes": ops_boxes.box12_to_box8_eval(out12),
                         "valid": out_valid, "truncated": truncated}
    return results
