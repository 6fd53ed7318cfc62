"""The eval step, counterpart of ``build_eval_inputs`` and
``make_eval_step`` in ``rangedet_tpu/train/train_step.py``."""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from .models.detector import run_inference
from .ops import targets as ops_targets


def build_eval_inputs(batch: Dict[str, Any], cfg,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """Move a raw batch (numpy or tensors, channels-last, padded to
    cfg.pad_field) to ``device`` and add the per-stride pc_s{s} / mask_s{s}
    (valid and range-interval masks, then the width stride slice; reference
    GenerateFPNTarget, input.py:561-607)."""
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    strides = tuple(cfg.fpn_strides)
    imasks = ops_targets.interval_masks(out["unnorm_range"],
                                        cfg.fpn_intervals, strides)
    for s in strides:
        out[f"pc_s{s}"] = ops_targets.stride_slice(out["pc"], s, w_axis=2)
        out[f"mask_s{s}"] = ops_targets.stride_slice(
            out["mask"] * imasks[s], s, w_axis=2)
    return out


def make_eval_step(model: torch.nn.Module, cfg) -> Callable:
    """Returns eval_step(batch) -> {class: {boxes, valid, truncated}}: the
    forward, then top-k, decode and weighted NMS, under inference mode.
    batch comes from build_eval_inputs."""

    def eval_step(batch: Dict[str, torch.Tensor]):
        with torch.inference_mode():
            cls_logits, reg_deltas = model(batch["input_data"],
                                           batch["coord"])
            return run_inference(cls_logits, reg_deltas, batch, cfg)

    return eval_step
