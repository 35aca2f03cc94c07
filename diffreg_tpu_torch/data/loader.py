"""Parallel host data pipeline: threaded sample building and batch prefetch.

Counterpart of the JAX package's data/loader.py (the reference's worker
dataloaders, ``num_workers: 8``): the per-pair work (native grid subsampling
and radius search, numpy GT building) runs in a thread pool, since the native
calls and numpy release the GIL, and a bounded queue builds batches ahead of
the consumer.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


def parallel_map_iter(fn: Callable[[T], U], items: Iterable[T], num_workers: int = 8,
                      window: Optional[int] = None) -> Iterator[U]:
    """Yield ``fn(item)`` in order, with up to ``num_workers`` calls at once and
    at most ``window`` results ahead of the consumer. An exception of ``fn``
    is raised where its result would have been yielded."""
    if num_workers <= 1:
        for item in items:
            yield fn(item)
        return
    window = window or 2 * num_workers
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        futures = []
        it = iter(items)
        done = False
        while True:
            while not done and len(futures) < window:
                try:
                    futures.append(ex.submit(fn, next(it)))
                except StopIteration:
                    done = True
            if not futures:
                return
            yield futures.pop(0).result()


def prefetch_iter(iterator: Iterable[T], buffer_size: int = 4) -> Iterator[T]:
    """Run ``iterator`` in a daemon thread, at most ``buffer_size`` items ahead;
    an exception of the producer is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    err = []

    def produce():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item
