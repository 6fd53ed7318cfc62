"""Prefetch, the port's copy of ``rangedet_tpu/data/prefetch.py``:
``threaded_prefetch`` prepares the next batches' records in a background
thread while the card runs the current step (the reference does this with
PostMergeBatchLoader's collector threads); ``device_prefetch`` puts them
on the card ``depth`` steps ahead, on a side CUDA stream, and
``threaded_device_prefetch`` does so from the background thread, so the
copies overlap the steps' kernels; ``pool_map_prefetch`` maps a function
over a stream of arguments in a thread pool.

One repair against the copy: when the consumer closes the generator, the
thread stops pulling from the source, closes it (a ``BatchLoader`` epoch
then ends its workers) and exits, and the close joins it. The reference's
thread blocks on its full queue there for the rest of the process.
The device prefetches and ``pool_map_prefetch`` close their source
likewise, and the pool's close waits for its threads."""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import torch

from .loader import put_until


def threaded_prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run the source iterator in a background thread, `depth` items ahead."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    END = object()
    stop = threading.Event()

    def worker():
        try:
            for item in iterator:
                if not put_until(q, item, stop):
                    break
        except Exception as e:  # surface in the consumer
            put_until(q, e, stop)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
            put_until(q, END, stop)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is END:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class SidePut:
    """``put`` (a host batch -> its tensors on the device) on a side stream
    of a CUDA ``device``: ``__call__`` runs it there and records an event;
    ``ready`` makes the caller's current stream wait on that event and
    ``record_stream``-s every tensor of the batch onto it, so the caching
    allocator does not reuse the memory while the step still reads it.
    ``put`` should copy from pinned memory, non-blocking
    (``train_step.batch_to_device``). Elsewhere ``put`` runs as it is."""

    def __init__(self, put: Callable, device: Optional[torch.device]):
        self.put, self.device = put, device
        self.side = (torch.cuda.Stream(device)
                     if device is not None
                     and torch.device(device).type == "cuda" else None)

    def __call__(self, item):
        if self.side is None:
            return self.put(item), None
        with torch.cuda.stream(self.side):
            out = self.put(item)
            done = torch.cuda.Event()
            done.record(self.side)
        return out, done

    def ready(self, pair):
        out, done = pair
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in _tensors(out):
                if t.device.type == "cuda":
                    t.record_stream(stream)
        return out


def _close(iterator):
    close = getattr(iterator, "close", None)
    if close is not None:
        close()


def device_prefetch(iterator: Iterator, put: Callable, depth: int = 2,
                    device: Optional[torch.device] = None) -> Iterator:
    """Apply ``put`` ``depth`` items ahead of consumption, in order, in the
    consumer's thread (so a ``put`` that joins a collective keeps its
    order among the ranks); on a CUDA ``device`` through ``SidePut``."""
    side = SidePut(put, device)
    buf: "collections.deque" = collections.deque()
    try:
        for item in iterator:
            buf.append(side(item))
            if len(buf) >= depth:
                yield side.ready(buf.popleft())
        while buf:
            yield side.ready(buf.popleft())
    finally:
        _close(iterator)


def threaded_device_prefetch(iterator: Iterator, put: Callable,
                             depth: int = 2,
                             device: Optional[torch.device] = None
                             ) -> Iterator:
    """``threaded_prefetch`` of ``put``: a background thread pulls the
    source and puts each item (``SidePut``), ``depth`` items ahead, so on
    the card the copies run while the consumer's thread dispatches the
    steps and overlap their kernels. ``put`` must not join a collective
    (its order among the ranks would depend on the thread's timing)."""
    side = SidePut(put, device)

    def put_each():
        try:
            for item in iterator:
                yield side(item)
        finally:
            _close(iterator)

    source = threaded_prefetch(put_each(), depth)
    try:
        for pair in source:
            yield side.ready(pair)
    finally:
        source.close()


def pool_map_prefetch(fn: Callable, args_iter, workers: int = 4,
                      depth: int = 8) -> Iterator:
    """Map ``fn`` over ``args_iter`` with a thread pool, yielding results in
    submission order ``depth`` ahead: the parallel analogue of the
    reference's N transform worker threads (utils/detection_input.py:
    147-156) for generator-bound streams (e.g. raytraced synthetic
    scenes)."""
    ex = ThreadPoolExecutor(max_workers=workers)
    futs: "collections.deque" = collections.deque()
    try:
        for a in args_iter:
            futs.append(ex.submit(fn, a))
            if len(futs) >= depth:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
