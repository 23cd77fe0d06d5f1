"""Host-side batch prefetching for the training loop.

The port's own copy of ``ssg_tpu/data/prefetch.py``. P x K training batches
are random-access (sampler indices), so they are rendered on demand. This
generic producer thread keeps up to ``depth`` rendered batches ahead of the
consumer: rendering in numpy (which releases the GIL in its array
operations) overlaps with the train step's launches, the same overlap the
reference gets from DataLoader workers (SURVEY.md §2 #12), without worker
processes.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``iterable`` on a background thread, ``depth`` items ahead.

    Order-preserving; producer exceptions re-raise at the consumer.
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    sentinel = object()
    failure: list[BaseException] = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            failure.append(e)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is sentinel:
            if failure:
                raise failure[0]
            return
        yield item
