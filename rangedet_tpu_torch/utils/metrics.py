"""Running training metrics, the port's copy of
``rangedet_tpu/utils/metrics.py`` (the reference's
rangedet/core/detection_metric.py EvalMetric subclasses; the shipped
configs use only ScalarLoss, config:407-419), on host values: numpy
arrays, scalars or CPU tensors.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class Metric:
    name: str

    def update(self, **kw):  # pragma: no cover - interface
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def get(self):
        raise NotImplementedError


class ScalarLoss(Metric):
    """Running mean of a named scalar loss (detection_metric.py:200-211)."""

    def __init__(self, name: str, key: str):
        self.name = name
        self.key = key
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._count = 0

    def update(self, **outputs):
        if self.key in outputs:
            self._sum += float(outputs[self.key])
            self._count += 1

    def get(self):
        return self.name, self._sum / max(self._count, 1)


class AccWithIgnore(Metric):
    """Binary accuracy over a masked dense prediction
    (detection_metric.py:23-55): prediction = score > 0.5 vs target > 0,
    pixels with mask == 0 ignored."""

    def __init__(self, name: str, score_key: str, target_key: str,
                 mask_key: str):
        self.name = name
        self.keys = (score_key, target_key, mask_key)
        self.reset()

    def reset(self):
        self._correct = 0
        self._total = 0

    def update(self, **outputs):
        s, t, m = (np.asarray(outputs[k]) for k in self.keys)
        valid = m > 0
        pred = s > 0.5
        pos = t > 0
        self._correct += int((pred == pos)[valid].sum())
        self._total += int(valid.sum())

    def get(self):
        return self.name, self._correct / max(self._total, 1)


class CeWithIgnore(Metric):
    """Mean binary cross-entropy over a masked dense prediction
    (detection_metric.py:115-158): -[t*log(p) + (1-t)*log(1-p)] averaged
    over the pixels whose mask is nonzero."""

    def __init__(self, name: str, score_key: str, target_key: str,
                 mask_key: str):
        self.name = name
        self.keys = (score_key, target_key, mask_key)
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._count = 0

    def update(self, **outputs):
        s, t, m = (np.asarray(outputs[k], np.float64) for k in self.keys)
        valid = m > 0
        p = np.clip(s, 1e-12, 1.0 - 1e-12)
        pos = (t > 0).astype(np.float64)
        ce = -(pos * np.log(p) + (1.0 - pos) * np.log(1.0 - p))
        self._sum += float(ce[valid].sum())
        self._count += int(valid.sum())

    def get(self):
        return self.name, self._sum / max(self._count, 1)


class L1Metric(Metric):
    """Mean absolute regression error over weighted pixels
    (detection_metric.py:161-198)."""

    def __init__(self, name: str, pred_key: str, target_key: str,
                 weight_key: str):
        self.name = name
        self.keys = (pred_key, target_key, weight_key)
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._count = 0.0

    def update(self, **outputs):
        p, t, w = (np.asarray(outputs[k]) for k in self.keys)
        self._sum += float((np.abs(p - t) * (w > 0)).sum())
        self._count += float((w > 0).sum())

    def get(self):
        return self.name, self._sum / max(self._count, 1.0)


class CompositeMetric:
    """A list of metrics and their log line (mx.metric.CompositeEvalMetric's
    counterpart)."""

    def __init__(self, metrics: Sequence[Metric]):
        self.metrics = list(metrics)

    def reset(self):
        for m in self.metrics:
            m.reset()

    def update(self, **outputs):
        for m in self.metrics:
            m.update(**outputs)

    def get(self) -> Dict[str, float]:
        return dict(m.get() for m in self.metrics)

    def format(self) -> str:
        return ", ".join(f"{k}={v:.5f}" for k, v in self.get().items())
