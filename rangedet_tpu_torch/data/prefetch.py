"""Host-side prefetch, the port's copy of ``threaded_prefetch`` from
``rangedet_tpu/data/prefetch.py``: prepare the next batches' records in a
background thread while the card runs the current step (the reference
does this with PostMergeBatchLoader's collector threads).

One repair against the copy: when the consumer closes the generator, the
thread stops pulling from the source, closes it (a ``BatchLoader`` epoch
then ends its workers) and exits, and the close joins it. The reference's
thread blocks on its full queue there for the rest of the process."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

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
