"""Data- and width-parallel training over processes, one per card: the
counterpart of ``rangedet_tpu/parallel/`` (``dist.py``: the group, the
mesh, a rank's rows and columns, the collectives; ``halo.py``: the width
halo exchange; ``dp_step.py``: the train step's reduction)."""
