"""Loss functions, counterpart of ``rangedet_tpu/models/losses.py``
(reference rangedet/symbol/head/loss.py and the loss assembly of
RangeRpnHead.get_vfl_loss / get_normalize_reg_loss, builder.py:350-422).

bf16 compute with f32 loss math and no loss scaling: the reference's x128
grad_scale / rescale_grad pair collapses to plain weighting (cls x10,
reg x8 in the shipped configs). Targets, masks and weights are detached.

``sync_group``: the normalizer (detached) is summed over the group's ranks,
the numerator stays this rank's, as ``rangedet_tpu/models/losses.py:70-77,
96-99`` psums only the denominator: each rank's gradient is then a partial
of the global batch's loss, and the ranks' gradients sum to it.
"""
from __future__ import annotations

import torch

from ..parallel.dist import all_reduce_sum


def sigmoid_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                            ) -> torch.Tensor:
    """Elementwise stable BCE: max(l, 0) - l*y + log(1 + exp(-|l|))
    (loss.py:4-24 with alpha=0.5 scaled by 2)."""
    return (logits.clamp(min=0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def varifocal_loss(logits: torch.Tensor, iou_score: torch.Tensor,
                   alpha: float = 1.0, gamma: float = 2.0) -> torch.Tensor:
    """IoU-aware varifocal loss (loss.py:22-30): positives (score > 0)
    weighted by the score, negatives by alpha * |score - p|^gamma."""
    p = torch.sigmoid(logits)
    bce = sigmoid_bce_with_logits(logits, iou_score)
    positive = (iou_score > 0).to(logits.dtype)
    negative = (iou_score == 0).to(logits.dtype)
    weight = (iou_score * positive
              + alpha * (iou_score - p).abs() ** gamma * negative)
    return bce * weight


def smooth_l1(x: torch.Tensor, scalar: float = 1.0) -> torch.Tensor:
    """MXNet smooth_l1 with sigma=scalar: 0.5*(s*x)^2 for |x| < 1/s^2,
    else |x| - 0.5/s^2."""
    s2 = scalar * scalar
    absx = x.abs()
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


def vfl_cls_loss(cls_logit: torch.Tensor, iou_target: torch.Tensor,
                 valid_mask: torch.Tensor, alpha: float = 1.0,
                 gamma: float = 2.0, sync_group=None) -> torch.Tensor:
    """Per-level cls loss (builder.py:350-379): masked VFL summed over the
    level, over (#valid pixels + 1)."""
    loss = varifocal_loss(cls_logit, iou_target.detach(), alpha, gamma)
    mask = valid_mask.detach()
    den = mask.sum()
    if sync_group is not None:
        den = all_reduce_sum(den, sync_group)
    return (loss * mask).sum() / (den + 1.0)


def normalized_reg_loss(reg_delta: torch.Tensor, reg_target: torch.Tensor,
                        reg_weight: torch.Tensor,
                        reg_norm_weight: torch.Tensor,
                        smooth_l1_scalar: float = 3.0, l1: bool = False,
                        sync_group=None) -> torch.Tensor:
    """Per-level reg loss (builder.py:381-422): per-dim weighted smooth-L1
    over (sum of the 1/N-points weights + 1)."""
    diff = reg_delta - reg_target.detach()
    loss = diff.abs() if l1 else smooth_l1(diff, smooth_l1_scalar)
    nw = reg_norm_weight.detach()
    den = nw.sum()
    if sync_group is not None:
        den = all_reduce_sum(den, sync_group)
    return (loss * reg_weight.detach() * nw).sum() / (den + 1.0)
