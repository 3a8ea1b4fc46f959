"""Background-thread host-side batch prefetch (counterpart of
``esrecsys_tpu/data/prefetch.py``).

The wrapped iterator runs on a daemon producer thread that fills a
bounded queue, so the next batch's host work (a shard load, a
permutation, record decoding) overlaps the current step. The producer
must do host work only: an iterator that launches CUDA work would run it
on the thread's own current stream and race the main thread's
generators. ``fit(prefetch=k)`` wraps its train iterator with this
(``train/loop.py``); the copy to the card stays on the main thread.
Do not share one source iterator across two prefetchers.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class _PrefetchIterator:
    def __init__(self, source: Iterator, depth: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None
        self._thread = threading.Thread(
            target=self._produce, args=(source,), daemon=True)
        self._thread.start()

    def _produce(self, source: Iterator) -> None:
        try:
            for item in source:
                self._q.put(item)
        except BaseException as e:  # re-raised by the consumer's next()
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            # later calls see the end again instead of blocking
            self._q.put(_SENTINEL)
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetched(source: Iterator[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``source`` on a background thread, ``depth`` items ahead.

    Exceptions from the source re-raise at the consuming ``next()``;
    exhaustion propagates as ``StopIteration``. ``depth`` bounds the host
    memory held in flight (depth x batch bytes); ``depth <= 0`` returns
    ``source`` itself.
    """
    if depth <= 0:
        return source
    return _PrefetchIterator(source, depth)
