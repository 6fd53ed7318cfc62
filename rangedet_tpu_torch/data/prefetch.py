"""Host-side prefetch, the port's copy of ``threaded_prefetch`` from
``rangedet_tpu/data/prefetch.py``: prepare the next batches' records in a
background thread while the card runs the current step (the reference
does this with PostMergeBatchLoader's collector threads)."""
from __future__ import annotations

import queue
import threading
from typing import Iterator


def threaded_prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run the source iterator in a background thread, `depth` items ahead."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except Exception as e:  # surface in the consumer
            q.put(e)
        finally:
            q.put(END)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is END:
            return
        if isinstance(item, Exception):
            raise item
        yield item
