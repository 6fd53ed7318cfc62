"""Threaded batch loader, the port's copy of ``BatchLoader`` from
``rangedet_tpu/data/loader.py`` (itself the replacement of the reference's
``PostMergeBatchLoader``, utils/detection_input.py:11-181): index queue -> N
worker threads mapping records to padded input dicts -> stacked batches,
per-host dataset slices and a shuffle per epoch included.

Same semantics as the reference loader, with one repair: when the consumer
closes an epoch's generator early (a run cut at ``--steps-per-epoch``), its
workers end and the generator joins them. The reference's workers block on
a full output queue there and never see the stop flag, so every cut-short
epoch leaks its workers and the frames they hold. Which frames an epoch
trains on does not change.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Sequence

import numpy as np

# how long a worker waits on a full output queue before it looks at the
# stop flag again
PUT_POLL_S = 0.05


def put_until(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Put ``item`` on ``q``, waiting while it is full, until ``stop`` is
    set. Returns whether the item went in."""
    while not stop.is_set():
        try:
            q.put(item, timeout=PUT_POLL_S)
            return True
        except queue.Full:
            pass
    return False


class BatchLoader:
    def __init__(
        self,
        records: Sequence,
        map_fn: Callable[[dict], Dict[str, np.ndarray]],
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 8,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 4,
        drop_last: bool = True,
    ):
        # per-host contiguous partition (utils/detection_input.py:49-55)
        per_host = len(records) // num_hosts if num_hosts > 1 else len(records)
        lo = host_id * per_host
        self.records = (list(records[lo:lo + per_host]) if num_hosts > 1
                        else list(records))
        self.map_fn = map_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.records) // self.batch_size
        if not self.drop_last and len(self.records) % self.batch_size:
            n += 1
        return n

    def _order(self) -> np.ndarray:
        """The record order of the next epoch: one shuffle of the rng."""
        order = np.arange(len(self.records))
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def skip_epoch(self) -> None:
        """Spend the shuffle of one epoch without mapping any record."""
        self._order()

    def epoch(self):
        """Generator over stacked batches for one epoch."""
        order = self._order()
        idx_q: "queue.Queue" = queue.Queue()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.batch_size)
        for i in order:
            idx_q.put(int(i))
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    i = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = self.map_fn(self.records[i])
                except Exception as e:  # surface loader errors, don't hang
                    item = e
                if not put_until(out_q, (i, item), stop):
                    return

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        try:
            n_total = len(order)
            n_batches = len(self)
            emitted = 0
            buf: List[Dict[str, np.ndarray]] = []
            for _ in range(n_total):
                i, item = out_q.get()
                if isinstance(item, Exception):
                    raise item
                buf.append(item)
                if len(buf) == self.batch_size:
                    yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
                    emitted += 1
                    buf = []
                    if emitted == n_batches:
                        break
            if buf and not self.drop_last:
                yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
        finally:
            stop.set()
            for t in threads:
                t.join()
