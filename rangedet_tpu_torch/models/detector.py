"""RangeDet detector: model assembly, on-device train targets, losses and
the inference path, counterpart of ``rangedet_tpu/models/detector.py``.
The batch dimension is written out where the JAX package uses vmap.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import assigner as ops_assigner
from ..ops import boxes as ops_boxes
from ..ops import decode as ops_decode
from ..ops import iou_target as ops_iou_target
from ..ops import nms as ops_nms
from ..ops import targets as ops_targets
from ..utils.spans import span
from . import losses as L
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
                 dtype: torch.dtype = torch.bfloat16,
                 use_pallas_meta: bool = False, remat: bool = False,
                 remat_meta: bool = False):
        super().__init__()
        self.fpn_strides = tuple(fpn_strides)
        self.backbone = DLABackbone(fpn_strides, num_block, num_filter,
                                    meta_units, add_data_sc, dtype=dtype,
                                    use_pallas_meta=use_pallas_meta,
                                    remat=remat, remat_meta=remat_meta)
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


@torch.no_grad()
def build_train_targets(batch: Dict[str, torch.Tensor], cfg,
                        count_group=None) -> Dict[str, torch.Tensor]:
    """Raw batch -> per-stride dense targets, on the batch's device
    (reference host pipeline rangedet/core/input.py:276-607).

    batch (channels last, padded to cfg.pad_field): input_data (B,H,W,8),
    coord, pc (B,H,W,3), mask, unnorm_range (B,H,W,1), gt_csa (B,M,7),
    gt_class (B,M), gt_valid (B,M); optional is_in_nlz (B,H,W,1), > 0
    excludes the pixel from assignment.

    Returns, per stride s: reg_target_s, reg_weight_s, reg_norm_weight_s,
    mask_s (valid and in the range interval), pc_s; and gt_corners_cls{k},
    the class-k GT BEV corners (other rows zero-size, so IoU 0).

    ``count_group``: the width group of a width-sharded batch (its columns
    of each frame); the per-box point counts are summed over it
    (``ops/targets.py``)."""
    strides = tuple(cfg.fpn_strides)
    nlz = batch.get("is_in_nlz")
    if nlz is None:  # synthetic/legacy batches: nothing is in an NLZ
        nlz = torch.full_like(batch["mask"], -1.0)
    frames = []
    for b in range(batch["pc"].shape[0]):
        pc, mask = batch["pc"][b].float(), batch["mask"][b].float()
        gt_csa = batch["gt_csa"][b].float()
        assignment = ops_assigner.assign_points_to_boxes(
            pc.reshape(-1, 3), ops_boxes.csa_to_corners3d(gt_csa),
            mask.reshape(-1), box_valid=batch["gt_valid"][b],
            is_in_nlz=nlz[b].reshape(-1),
        )
        dense = ops_targets.generate_dense_targets(
            pc, gt_csa, batch["gt_class"][b], assignment,
            label_set=tuple(cfg.label_set),
            reg_dim_weights=tuple(cfg.reg_dim_weights),
            count_group=count_group,
        )
        imasks = ops_targets.interval_masks(batch["unnorm_range"][b],
                                            cfg.fpn_intervals, strides)
        out = {}
        for s in strides:
            m = imasks[s]
            for key, name in (("reg_target", "rpn_reg_target"),
                              ("reg_weight", "rpn_reg_weight"),
                              ("reg_norm_weight", "reg_normalize_weight")):
                out[f"{key}_s{s}"] = ops_targets.stride_slice(
                    dense[name] * m, s, w_axis=1)
            out[f"mask_s{s}"] = ops_targets.stride_slice(mask * m, s, 1)
            out[f"pc_s{s}"] = ops_targets.stride_slice(pc, s, 1)
        frames.append(out)
    targets = {k: torch.stack([f[k] for f in frames]) for k in frames[0]}

    gt_bev = ops_boxes.csa_to_corners_bev(batch["gt_csa"].float())
    for k, label in enumerate(cfg.label_set):
        keep = ((batch["gt_class"].to(torch.int32) == label)
                & batch["gt_valid"].bool())
        targets[f"gt_corners_cls{k}"] = torch.where(
            keep[..., None, None], gt_bev, torch.zeros_like(gt_bev))
    return targets


def iou_targets_per_level(reg_deltas: List[torch.Tensor],
                          targets: Dict[str, torch.Tensor], cfg
                          ) -> List[torch.Tensor]:
    """Per level, the max IoU of each pixel's decoded box against the GTs of
    each class (RangeRpnHead.get_iou_target, builder.py:156-196) through the
    IoU-target kernel, with G = max(iou_topk_gt, 32) candidates per block:
    (B, H, W_s, K), no gradient."""
    out = []
    for level, s in enumerate(cfg.fpn_strides):
        delta = reg_deltas[level].detach()  # (B, H, Ws, K*8)
        per_class = [
            ops_iou_target.iou_target(
                delta[..., k * 8:(k + 1) * 8], targets[f"pc_s{s}"],
                targets[f"gt_corners_cls{k}"],
                topk_gt=max(cfg.iou_topk_gt, 32))
            for k in range(cfg.num_classes)
        ]
        out.append(torch.stack(per_class, dim=-1))
    return out


def compute_losses(cls_logits: List[torch.Tensor],
                   reg_deltas: List[torch.Tensor],
                   targets: Dict[str, torch.Tensor], cfg, sync_group=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and per-level metrics (get_fpn_loss, builder.py:268-348),
    weights cls x cfg.cls_loss_weight, reg x cfg.reg_loss_weight.
    ``sync_group``: the normalizers are the group's (``losses.py``), so the
    loss is this rank's share of the global batch's."""
    iou_t = iou_targets_per_level(reg_deltas, targets, cfg)
    metrics = {}
    total = 0.0
    for level, s in enumerate(cfg.fpn_strides):
        cls_loss = L.vfl_cls_loss(cls_logits[level], iou_t[level],
                                  targets[f"mask_s{s}"], alpha=cfg.vfl_alpha,
                                  gamma=cfg.vfl_gamma, sync_group=sync_group)
        reg_loss = L.normalized_reg_loss(
            reg_deltas[level], targets[f"reg_target_s{s}"],
            targets[f"reg_weight_s{s}"], targets[f"reg_norm_weight_s{s}"],
            smooth_l1_scalar=cfg.smooth_l1_scalar, l1=cfg.l1_loss,
            sync_group=sync_group)
        metrics[f"cls_loss_s{s}"] = cls_loss
        metrics[f"reg_loss_s{s}"] = reg_loss
        total = (total + cfg.cls_loss_weight * cls_loss
                 + cfg.reg_loss_weight * reg_loss)
    metrics["total_loss"] = total
    return total, metrics


def run_inference(
    cls_logits: List[torch.Tensor],
    reg_deltas: List[torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg,
) -> Dict[str, Any]:
    """Every class at once: concat levels -> masked top-k -> decode ->
    weighted NMS -> box8_eval rows [cx, cy, cz, l, w, h, yaw, score].

    A class's candidate set is the top ``min(device_topk, pre_nms_top_n,
    N)`` of its masked scores, ordered by a stable sort; a candidate is
    valid when its score is strictly above the class's min_score
    (reference tools/test.py:200). ``truncated`` flags a frame whose
    weakest kept candidate still clears min_score, i.e. where the cap
    bound. The classes are rows beside the frames, (B, K, ...) frame by
    frame: one sort of the B x K rows, one gather each of scores, deltas
    and points, one decode and one weighted-NMS call over the B x K rows,
    each row with its class's keep cap (``post_nms_top_n``); a class of
    fewer candidates is padded to the largest count with zero, invalid
    columns. Each class's validity, scores and truncation equal those of
    the class run alone bit for bit, and so do its boxes on the card and
    wherever no class is padded. batch holds
    pc_s{s} and mask_s{s}. Returns {class_name: {"boxes": (B, post_nms, 8),
    "valid": (B, post_nms), "truncated": (B,)}}. Profiler ranges
    (``utils/spans.py``): ``topk``, ``decode`` and ``wnms``, once each.
    """
    B = cls_logits[0].shape[0]
    K = cfg.num_classes
    names = cfg.class_names
    with span("topk"):
        scores = torch.cat(
            [torch.sigmoid(l).reshape(B, -1, K) for l in cls_logits], dim=1)
        deltas = torch.cat([d.reshape(B, -1, K, 8) for d in reg_deltas],
                           dim=1)
        pc = torch.cat(
            [batch[f"pc_s{s}"].reshape(B, -1, 3) for s in cfg.fpn_strides],
            1)
        mask = torch.cat(
            [batch[f"mask_s{s}"].reshape(B, -1) for s in cfg.fpn_strides], 1)
        N = scores.shape[1]
        topks = [min(cfg.device_topk.get(n, 4096),
                     cfg.pre_nms_top_n.get(n, 50000), N) for n in names]
        T = max(topks)
        rows = scores.transpose(1, 2)  # (B, K, N)
        masked = torch.where(mask[:, None] > 0, rows, torch.zeros_like(rows))
        idx = torch.sort(-masked, dim=2, stable=True).indices[..., :T]
        top_scores = torch.gather(masked, 2, idx)
        top_deltas = torch.gather(deltas.transpose(1, 2), 2,
                                  idx[..., None].expand(-1, -1, -1, 8))
        top_pc = torch.gather(pc[:, None].expand(-1, K, -1, -1), 2,
                              idx[..., None].expand(-1, -1, -1, 3))
        valid = torch.empty_like(top_scores, dtype=torch.bool)
        truncated = torch.empty((B, K), dtype=torch.bool,
                                device=top_scores.device)
        for k, (n, t) in enumerate(zip(names, topks)):
            torch.gt(top_scores[:, k], cfg.min_score[n], out=valid[:, k])
            torch.gt(top_scores[:, k, t - 1], cfg.min_score[n],
                     out=truncated[:, k])
            if t < T:  # the padding
                valid[:, k, t:] = False
    with span("decode"):
        box11 = ops_boxes.box10_to_box11(
            ops_decode.decode_boxes(top_deltas, top_pc))
    with span("wnms"):
        for k, t in enumerate(topks):
            if t < T:  # a padded column's non-finite value would poison
                box11[:, k, t:] = 0  # the weighted sums (csrc/wnms.cu)
        caps = [cfg.post_nms_top_n[n] for n in names]
        out12, out_valid = ops_nms.weighted_nms(
            box11.reshape(B * K, T, 11), top_scores.reshape(B * K, T),
            valid.reshape(B * K, T),
            thresh=cfg.wnms_thr_lo, thresh_vote=cfg.wnms_thr_hi,
            max_keep=caps[0] if len(set(caps)) == 1 else caps,
            iou_3d=cfg.wnms_is_3d, block=cfg.wnms_block,
        )
        boxes = ops_boxes.box12_to_box8_eval(out12).view(B, K, -1, 8)
        out_valid = out_valid.view(B, K, -1)
    return {n: {"boxes": boxes[:, k, :c], "valid": out_valid[:, k, :c],
                "truncated": truncated[:, k]}
            for k, (n, c) in enumerate(zip(names, caps))}
