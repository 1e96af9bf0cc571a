"""Host→device ingest pipeline: background packing + prefetched H2D.

The reference overlaps a reader thread with counter tasks (reference
src/mains/main.cpp:132-218: the omp single thread reads FASTQ while omp
tasks count).  The analog here is a bounded producer queue: background
thread(s) parse + pack + *start the async H2D copy* (jax.device_put
returns before the transfer completes), while the main thread dispatches
the jitted device steps.  With a queue depth of D, up to D batch transfers
are in flight behind the current device step — hiding host parse time and
the host→device copy (the dominant non-device cost through a slow link).

All functions re-raise producer exceptions in the consumer, after every
producer thread has stopped (so partial stats are consistent).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

_DONE = object()


def merged_iter(iterables: list, depth: int = 4) -> Iterator:
    """Drive each iterable on its own daemon thread; yield items as ready.

    Order across iterables is arrival order (counting is order-invariant);
    order within one iterable is preserved.  The bounded queue applies
    backpressure so producers never run more than `depth` items ahead of
    the consumer.  If the consumer stops early, producers are signalled
    and drained so no thread leaks blocked.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    errs: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def drain(it):
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            errs.append(e)
        finally:
            put(_DONE)

    threads = [
        threading.Thread(target=drain, args=(it,), daemon=True)
        for it in iterables
    ]
    for t in threads:
        t.start()
    done = 0
    try:
        while done < len(threads):
            item = q.get()
            if item is _DONE:
                done += 1
                continue
            yield item
    finally:
        stop.set()
        for t in threads:
            t.join()
    if errs:
        raise errs[0]


def prefetch(
    items: Iterable,
    transform: Callable,
    depth: int = 2,
) -> Iterator:
    """Apply `transform` (e.g. jax.device_put) to each item on a background
    thread, yielding results in order, at most `depth` ahead."""
    return merged_iter([map(transform, items)], depth=depth)
