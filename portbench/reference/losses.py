"""Plain RangeDet losses (the authors' rangedet/symbol/head/builder.py and
loss.py): per FPN level the IoU-aware varifocal classification loss and
the normalized smooth-L1 regression loss, and the dense IoU target they
need. f32.

IoU target: each pixel's predicted box (its deltas decoded around its
point) against every box of the class, the largest BEV IoU
(``geometry.iou_bev``), no gradient.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .geometry import EPS, decode_boxes, iou_bev, polygon_area

IOU_CHUNK = 1 << 16  # pixels a chunk of the dense IoU


@torch.no_grad()
def iou_target(deltas: torch.Tensor, pc: torch.Tensor, gt: torch.Tensor
               ) -> torch.Tensor:
    """deltas (B, H, W, 8), pc (B, H, W, 3), gt corners (B, M, 4, 2) ->
    (B, H, W): the max BEV IoU over the frame's boxes of non-zero area,
    cleaned to [0, 1]."""
    B, H, W, _ = deltas.shape
    out = torch.zeros(B, H * W, device=deltas.device)
    for b in range(B):
        g = gt[b][polygon_area(gt[b]).abs() >= EPS]
        if g.shape[0] == 0:
            continue
        box = decode_boxes(deltas[b].reshape(-1, 8), pc[b].reshape(-1, 3))
        q = box[:, :8].reshape(-1, 4, 2)
        for lo in range(0, q.shape[0], IOU_CHUNK):
            iou = iou_bev(q[lo:lo + IOU_CHUNK, None], g[None]).amax(-1)
            iou = torch.where(torch.isfinite(iou), iou, torch.zeros_like(iou))
            out[b, lo:lo + IOU_CHUNK] = torch.where(
                (iou < 0) | (iou > 1), torch.zeros_like(iou), iou)
    return out.reshape(B, H, W)


def bce_logits(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x.clamp(min=0.0) - x * y + torch.log1p(torch.exp(-x.abs()))


def varifocal(x: torch.Tensor, q: torch.Tensor, alpha: float, gamma: float
              ) -> torch.Tensor:
    """Positives (q > 0) weighted by q, negatives by alpha |q - p|^gamma."""
    p = torch.sigmoid(x)
    w = (q * (q > 0).float()
         + alpha * (q - p).abs() ** gamma * (q == 0).float())
    return bce_logits(x, q) * w


def smooth_l1(x: torch.Tensor, sigma: float) -> torch.Tensor:
    s2 = sigma * sigma
    return torch.where(x.abs() < 1.0 / s2, 0.5 * s2 * x * x,
                       x.abs() - 0.5 / s2)


def losses(cls: List[torch.Tensor], reg: List[torch.Tensor],
           targets: Dict[str, torch.Tensor], rc: dict
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss (cls x cls_loss_weight + reg x reg_loss_weight, summed
    over levels) and the per-level losses. Each loss is the level's sum
    over (its normalizer + 1): the valid pixels for cls, the 1/N weights
    for reg."""
    metrics, total = {}, 0.0
    K = rc["num_classes"]
    for lvl, s in enumerate(rc["fpn_strides"]):
        d = reg[lvl].detach()
        q = torch.stack([iou_target(d[..., 8 * k:8 * k + 8],
                                    targets[f"pc_s{s}"],
                                    targets[f"gt_corners_cls{k}"])
                         for k in range(K)], dim=-1)
        mask = targets[f"mask_s{s}"]
        c = (varifocal(cls[lvl], q, rc["vfl_alpha"], rc["vfl_gamma"])
             * mask).sum() / (mask.sum() + 1.0)
        nw = targets[f"reg_norm_weight_s{s}"]
        r = (smooth_l1(reg[lvl] - targets[f"reg_target_s{s}"],
                       rc["smooth_l1_scalar"])
             * targets[f"reg_weight_s{s}"] * nw).sum() / (nw.sum() + 1.0)
        metrics[f"cls_loss_s{s}"], metrics[f"reg_loss_s{s}"] = c, r
        total = total + rc["cls_loss_weight"] * c + rc["reg_loss_weight"] * r
    metrics["total_loss"] = total
    return total, metrics
