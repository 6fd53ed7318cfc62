"""The plain reference of the benchmark: RangeDet in f32 PyTorch, written
from the architecture and the authors' code, importing nothing of the
program under test (``rangedet_tpu_torch``) or of the JAX package.

* ``model``: the forward (backbone, Meta-Kernel block, head) and the
  names and shapes of the parameters;
* ``targets``: assignment and dense targets from the raw batch;
* ``losses``: the dense IoU target and the losses;
* ``train``: the clip and SGD over a few steps;
* ``post``: top-k, decode, weighted NMS;
* ``precision``: TF32 off, and the fp8 rounding of the control.

Each reads the configuration file's ``config`` section
(``portbench/configs/<name>.json``) as its dict ``c``.
"""
