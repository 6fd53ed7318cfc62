"""Experiment logging and the training speedometers, the port's copy of
``rangedet_tpu/utils/logger.py`` (reference utils/logger.py's file and
console logger; utils/callback.py's Speedometer, DetailSpeedometer
(callback.py:52-99) and optional TensorBoard recorder (callback.py:20,
40-46)). ``ProfilerHook`` runs ``torch.profiler`` where the JAX package
runs ``jax.profiler``.
"""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict, Optional

LOGGER = "rangedet_tpu_torch"


def config_logger(experiment_dir: str, name: str,
                  log_file: bool = True) -> logging.Logger:
    """The package's logger, writing ``<experiment_dir>/<name>/log.txt``
    (unless not ``log_file``: the ranks but 0 of a data-parallel run) and
    the console (standard output, where the port's CLIs print) in the JAX
    package's format. Each call replaces the handlers of the last."""
    log_dir = os.path.join(experiment_dir, name)
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(LOGGER)
    logger.setLevel(logging.INFO)
    logger.propagate = False  # avoid duplicate lines via the root logger
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    if log_file:
        fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    return logger


class ScalarWriter:
    """Optional TensorBoard scalar recorder (reference
    utils/callback.py:20,40-46) over ``torch.utils.tensorboard``, opened at
    its first write; a no-op, after one warning, where tensorboard does not
    import, so training never depends on it."""

    def __init__(self, log_dir: str, logger=None):
        self.log_dir = log_dir
        self._writer = None
        self._dead = False
        self._logger = logger or logging.getLogger(LOGGER)

    def _get(self):
        if self._writer is None and not self._dead:
            try:
                from torch.utils.tensorboard import SummaryWriter

                os.makedirs(self.log_dir, exist_ok=True)
                self._writer = SummaryWriter(self.log_dir)
            except ImportError as e:
                self._dead = True
                self._logger.warning(f"tensorboard writer unavailable: {e}")
        return self._writer

    def scalars(self, tag_values: Dict[str, float], step: int):
        w = self._get()
        if w is not None:
            for tag, v in tag_values.items():
                w.add_scalar(tag, float(v), step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class Speedometer:
    """Logs frames/s and the running-mean metrics every ``frequency``
    calls."""

    def __init__(self, batch_size: int, frequency: int = 100, logger=None,
                 tb: Optional[ScalarWriter] = None):
        self.batch_size = batch_size
        self.frequency = frequency
        self.logger = logger or logging.getLogger(LOGGER)
        self.tb = tb
        self._tic = time.time()
        self._count = 0
        self._sums: Dict[str, float] = {}

    def _extra(self) -> str:
        return ""

    @property
    def due_next(self) -> bool:
        """True when the NEXT __call__ will emit a log line, so callers
        compute what only that line needs (the lr) for just that call."""
        return (self._count + 1) % self.frequency == 0

    def __call__(self, epoch: int, step: int, metrics: Dict[str, float],
                 lr: Optional[float] = None,
                 global_step: Optional[int] = None):
        self._count += 1
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
        if self._count % self.frequency == 0:
            dt = time.time() - self._tic
            speed = self.frequency * self.batch_size / max(dt, 1e-9)
            means = ", ".join(
                f"{k}={v / self.frequency:.5f}"
                for k, v in sorted(self._sums.items())
            )
            lr_str = f" lr={lr:.6f}" if lr is not None else ""
            self.logger.info(
                f"Epoch[{epoch}] Batch[{step}] speed {speed:.2f} frames/s"
                f"{lr_str}{self._extra()} {means}"
            )
            if self.tb is not None:
                gs = global_step if global_step is not None else step
                scalars = {
                    (k if "/" in k else f"train/{k}"): v / self.frequency
                    for k, v in self._sums.items()
                }
                scalars["train/frames_per_sec"] = speed
                if lr is not None:
                    scalars["train/lr"] = lr
                self.tb.scalars(scalars, gs)
            self._sums.clear()
            self._tic = time.time()


class DetailSpeedometer(Speedometer):
    """A Speedometer whose line also splits the time between the wait for
    data and the step (reference utils/callback.py:52-99). The loop feeds
    each step's host times through :meth:`tick`; a line carries their
    means, ``data_ms`` (blocked on the input iterator) and ``step_ms``
    (the step's dispatch, and a metrics window's sync)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._data_s = 0.0
        self._step_s = 0.0

    def tick(self, data_s: float, step_s: float):
        self._data_s += data_s
        self._step_s += step_s

    def _extra(self) -> str:
        n = max(self.frequency, 1)
        s = (f" data_ms={1e3 * self._data_s / n:.1f}"
             f" step_ms={1e3 * self._step_s / n:.1f}")
        if self.tb is not None:
            self._sums.setdefault("time/data_ms", 0.0)
            self._sums["time/data_ms"] += 1e3 * self._data_s  # /freq in tb
            self._sums.setdefault("time/step_ms", 0.0)
            self._sums["time/step_ms"] += 1e3 * self._step_s
        self._data_s = 0.0
        self._step_s = 0.0
        return s


class ProfilerHook:
    """A ``torch.profiler`` trace of steps [start, start + num): called
    with each step's global count before the step, it starts the profiler
    at ``start`` and stops it at ``start + num`` (or at :meth:`close`),
    writing a trace that Chrome and TensorBoard read under ``log_dir``.
    The device's activity is traced when a CUDA card is present."""

    def __init__(self, log_dir: str, start_step: int = 0, num_steps: int = 0):
        self.log_dir = log_dir
        self.start = start_step
        self.stop = start_step + num_steps
        self._prof = None

    def __call__(self, step: int):
        if self.stop <= self.start:
            return
        if step == self.start and self._prof is None:
            import torch
            from torch.profiler import (
                ProfilerActivity,
                profile,
                tensorboard_trace_handler,
            )

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(
                activities=acts,
                on_trace_ready=tensorboard_trace_handler(self.log_dir))
            self._prof.start()
        elif step == self.stop:
            self.close()

    def close(self):
        """Stop an open trace and write it; the traced steps' device work
        is waited for first."""
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.stop()
