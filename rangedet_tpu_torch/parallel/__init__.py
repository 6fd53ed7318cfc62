"""Data-parallel training over processes, one per card: the counterpart of
``rangedet_tpu/parallel/`` for data-only meshes (``dist.py``: the group,
the batch rows, the collectives; ``dp_step.py``: the train step's
reduction)."""
