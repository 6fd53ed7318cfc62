"""How ``correct`` is decided: the numbers that compare what the timed path
produced with the plain reference (``portbench/reference``), each held to
its limit in the configuration file's ``limits``.

Training (the first three steps of the object the window then drives):

* ``res1_gap``: |y - y_ref| / |y_ref| (2-norms over the elements) of the
  first step's output of the backbone's first stage, ``res1`` (the conv
  kernels, the fused Meta-Kernel block, BatchNorm on the batch's
  statistics), the program's against the reference's;
* ``forward1_gap``: the largest |y - y_ref| / |y_ref| (2-norms over the
  elements) of the first step's logits and deltas, every level, the
  program's forward in train mode against the reference's;
* ``loss1_gap``: |L - L_ref| / |L_ref| of the first step's total loss;
* ``grad_median_gap``: per leaf, the gap between the norm of the first
  update's clipped gradient (the program's: its momentum buffer after one
  step less the weight decay, as SGD got it) and the reference's, over
  the larger of the reference leaf's norm and the median leaf's; the
  median over the leaves;
* ``update_median_gap``: the same for the parameters' change over the
  three steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out. The worst leaf's gaps
and the later steps' loss gaps are read (``train_gaps``) but not held to
a limit: bf16 rounding alone moves them by tenths (PERF.md).

Eval (a sample of the window's steps drawn from the seed):

* ``forward_gap``: the largest |y - y_ref| / max|y_ref| of the logits and
  deltas of every level, the program's forward against the reference's;
* ``boxes_mismatch``: rows whose validity differs between the program's
  boxes and the reference's top-k, decode and weighted NMS run on the
  program's own logits and deltas (the stage after the forward, checked
  alone);
* ``boxes_gap``: the largest |box - box_ref| over the rows valid in both.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

from .reference.model import Net
from .reference.post import run_inference
from .reference.precision import bf16_cast, fp8_cast, no_tf32
from .reference.targets import stride_slice
from .reference.train import train_steps

TINY_LEAF = 1e-3  # of the median leaf's reference gradient norm
SHAPE_MISMATCH = 1e9  # a gap where the program's output has another shape


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def kept_leaves(grad_ref: Dict[str, torch.Tensor]) -> List[str]:
    n = _norms(grad_ref)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= TINY_LEAF * med]


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Sequence[str]) -> Dict[str, float]:
    """Per leaf of ``keep``: | |prog| - |ref| | / max(|ref|, median
    |ref|)."""
    pn, rn = _norms({k: prog[k] for k in keep}), _norms({k: ref[k]
                                                          for k in keep})
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in keep}


def train_gaps(prog: dict, ref: dict, P0: Dict[str, torch.Tensor]) -> dict:
    """``prog`` and ``ref``: {"losses": [3 floats], "forward1": (logits,
    deltas), "grad1": {leaf: g}, "params": {leaf: p after 3 steps}}, on one
    device -> {"losses": the steps' relative loss gaps, "forward1": the
    first forward's gap, "grad": {leaf: gap}, "update": {leaf: gap}}."""
    keep = kept_leaves(ref["grad1"])
    if len(prog["losses"]) != len(ref["losses"]):
        losses = [SHAPE_MISMATCH]
    else:
        losses = [abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(prog["losses"], ref["losses"])]
    delta = {k: prog["params"][k] - P0[k] for k in keep}
    delta_ref = {k: ref["params"][k] - P0[k] for k in keep}
    rows = prog["forward1"][0][0].shape[0]
    ref1 = tuple([t[:rows] for t in o] for o in ref["forward1"])
    stages = {k: stage_gap(prog, ref, k) for k in ref["stages1"]}
    return {"losses": losses, "stages1": stages,
            "forward1": forward_rms_gap(prog["forward1"], ref1),
            "forward1_max": forward_gap(prog["forward1"], ref1),
            "grad": leaf_gaps(prog["grad1"], ref["grad1"], keep),
            "update": leaf_gaps(delta, delta_ref, keep)}


def stage_gap(prog: dict, ref: dict, name: str) -> float:
    """|y - y_ref| / |y_ref| of the first step's output of backbone stage
    ``name``: the program's (B, H, C, W), the reference's (B, C, H, W), of
    which the program's rows."""
    y = prog["stages1"][name]
    return _rms_gap(y.float(), ref["stages1"][name][:y.shape[0]]
                    .permute(0, 2, 1, 3))


def train_numbers(g: dict) -> Dict[str, float]:
    """The numbers compared, from ``train_gaps``: the first step's loss
    gap and the median leaf's gaps (the worst leaf's and the later steps'
    swing with bf16 rounding alone; PERF.md)."""
    return {"res1_gap": g["stages1"]["res1"],
            "forward1_gap": g["forward1"],
            "loss1_gap": g["losses"][0],
            "grad_median_gap": statistics.median(g["grad"].values()),
            "update_median_gap": statistics.median(g["update"].values())}


CASTS = {"f32": None, "fp8": fp8_cast, "bf16": bf16_cast}


def reference_train(P0, c, steps_per_epoch, batches, precision="f32"
                    ) -> dict:
    with no_tf32():
        return train_steps(P0, c, steps_per_epoch, batches,
                           cast=CASTS[precision])


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return SHAPE_MISMATCH
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def forward_gap(prog, ref) -> float:
    """prog, ref: (logits per level, deltas per level) -> the largest
    max|y - y_ref| / max|y_ref| of the outputs."""
    return max(_gap(a, b) for p, r in zip(prog, ref) for a, b in zip(p, r))


def _rms_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return SHAPE_MISMATCH
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp(min=1e-30))


def forward_rms_gap(prog, ref) -> float:
    """The largest |y - y_ref| / |y_ref| (2-norms over every element) of
    the outputs."""
    return max(_rms_gap(a, b) for p, r in zip(prog, ref)
               for a, b in zip(p, r))


def reference_boxes(fwd, batch, c, precision="f32"):
    """The reference's post-processing of (logits, deltas) ``fwd``, at
    ``precision`` (the control's: bf16, below the f32 it states)."""
    pcs, masks = level_inputs(batch, c)
    with torch.no_grad():
        return run_inference(list(fwd[0]), list(fwd[1]), pcs, masks, c,
                             cast=CASTS[precision])


def reference_forward(P0, c, batch, precision="f32"):
    cast = CASTS[precision]
    with no_tf32(), torch.no_grad():
        net = Net(P0, c, train=False, **({} if cast is None else
                                           {"cast": cast}))
        return net(batch["input_data"], batch["coord"])


def level_inputs(batch, c):
    """The reference's per-level points and masks of a raw batch."""
    pcs, masks = [], []
    rng = batch["unnorm_range"].float()
    for s in c["fpn_strides"]:
        lo, hi = c["fpn_intervals"][str(s)]
        m = ((rng >= lo) & (rng < hi)).float()
        pcs.append(stride_slice(batch["pc"].float(), s, 2))
        masks.append(stride_slice(batch["mask"].float() * m, s, 2))
    return pcs, masks


def boxes_numbers(prog_out, fwd, batch, c) -> Dict[str, float]:
    """prog_out: the program's host outputs {class: {"boxes", "valid"}};
    fwd: the program's (logits, deltas) of the same step."""
    cls, reg = fwd
    if cls[0].shape[0] != batch["pc"].shape[0]:
        return {"boxes_mismatch": SHAPE_MISMATCH, "boxes_gap": SHAPE_MISMATCH}
    pcs, masks = level_inputs(batch, c)
    with torch.no_grad():
        ref = run_inference(list(cls), list(reg), pcs, masks, c)
    return compare_boxes(prog_out, ref)


def compare_boxes(prog_out, ref) -> Dict[str, float]:
    """Rows whose validity differs, and the largest gap over the rows
    valid in both."""
    mismatch, gap = 0, 0.0
    for name, r in ref.items():
        pv = torch.as_tensor(prog_out[name]["valid"]).cpu().bool()
        pb = torch.as_tensor(prog_out[name]["boxes"]).cpu().float()
        rv, rb = r["valid"].cpu(), r["boxes"].cpu()
        if pv.shape != rv.shape or pb.shape != rb.shape:
            return {"boxes_mismatch": SHAPE_MISMATCH,
                    "boxes_gap": SHAPE_MISMATCH}
        mismatch += int((pv != rv).sum())
        both = pv & rv
        if both.any():
            gap = max(gap, float((pb[both] - rb[both]).abs().max()))
    return {"boxes_mismatch": float(mismatch), "boxes_gap": gap}
