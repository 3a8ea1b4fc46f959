"""The port's host prefetch (``data/prefetch.py``) against the JAX
package's: the same items in the same order, exhaustion, exceptions at
the consuming ``next()``, a producer that runs ahead, depth 0. Exact."""

import threading
import time

import pytest

from esrecsys_tpu.data.prefetch import prefetched as jax_prefetched
from esrecsys_tpu_torch.data.prefetch import prefetched


@pytest.mark.parametrize("depth", [1, 4, 200])
def test_order_and_exhaustion_match_the_reference(depth):
    ours = prefetched(iter(range(100)), depth=depth)
    assert list(ours) == list(jax_prefetched(iter(range(100)), depth=depth))
    # exhausted: every later next() ends again instead of blocking
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(ours)


def test_exceptions_propagate():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = prefetched(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_producer_runs_ahead_on_its_own_thread():
    produced, threads = [], set()

    def source():
        for i in range(10):
            produced.append(i)
            threads.add(threading.get_ident())
            yield i

    it = prefetched(source(), depth=4)
    assert next(it) == 0
    deadline = time.monotonic() + 10
    while len(produced) < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(produced) >= 5  # ran ahead of the single consume
    assert threads and threading.get_ident() not in threads
    assert list(it) == list(range(1, 10))


@pytest.mark.parametrize("depth", [0, -1])
def test_depth_zero_is_identity(depth):
    src = iter([1, 2, 3])
    assert prefetched(src, depth=depth) is src
