"""rangedet_tpu_torch — the PyTorch / CUDA port of rangedet_tpu for one
NVIDIA Hopper card (H100).

Layers (bottom-up), each mirroring the module of the same path in
``rangedet_tpu``:
  csrc/      hand-written sm_90a CUDA kernels, built by _build.py at first use
  ops/       the kernels' wrappers with their plain versions, plus plain-torch
             geometry: boxes, decode, rotated IoU, FPN masks, weighted NMS
  models/    nn.Modules: layers, Meta-Kernel, DLA backbone, head, RangeDet
  configs/   jax-free mirror of RangeDetConfig and the recipes
  data/      synthetic scenes, the Waymo roidb/npz reader, host prefetch
  eval/      AP evaluator, in-process evaluation, prediction export
  train/     train state, schedule, train step, checkpoints
  convert.py weight bridge from the JAX package's parameter tree
  infer.py   eval step: per-stride inputs, forward, top-k, decode, WNMS
  tools/     command-line entry points (``python -m rangedet_tpu_torch.tools.test``)

The package imports torch and numpy (scipy for the Hungarian evaluator),
never jax and nothing of ``rangedet_tpu``: it keeps its own copies.
"""
