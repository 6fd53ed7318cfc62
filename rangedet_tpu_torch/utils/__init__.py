"""Training metrics and experiment logging, counterparts of
``rangedet_tpu/utils/metrics.py`` and ``rangedet_tpu/utils/logger.py``."""
