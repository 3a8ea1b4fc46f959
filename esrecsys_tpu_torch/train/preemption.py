"""Graceful-preemption guard for training loops (counterpart of
``esrecsys_tpu/train/preemption.py``).

A SIGTERM (a maintenance event, a spot reclaim) becomes a clean stop:

  - the signal sets a flag (the handler does nothing else);
  - the train loop polls :meth:`PreemptionGuard.should_stop` once a step;
  - the loop checkpoints and returns with ``FitResult.preempted=True``;
    workloads skip the final export and exit 0, and the relaunched job
    resumes from the checkpoint.

``should_stop`` is this process's flag. The reference agrees the flag
across processes so that every host saves the same step; that waits for
the port's multi-process training, and meanwhile a guard polled inside a
``torch.distributed`` group of more than one process raises.

Use via ``fit(..., preemption=True)`` or an explicitly managed guard::

    with PreemptionGuard() as guard:
        result = fit(..., preemption=guard)
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional, Sequence

log = logging.getLogger(__name__)


class PreemptionGuard:
    """Context manager that latches termination signals into a flag.

    Handlers are installed on ``__enter__`` and restored on ``__exit__``.
    Installing needs the main thread (a CPython rule); elsewhere the guard
    warns and stays usable through :meth:`request_stop`.
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._old = {}
        self._installed = False
        self._flag = threading.Event()

    def _handler(self, signum, frame):  # noqa: ARG002 (signal signature)
        self._flag.set()

    def __enter__(self) -> "PreemptionGuard":
        try:
            for s in self._signals:
                self._old[s] = signal.signal(s, self._handler)
            self._installed = True
        except ValueError:  # signal.signal off the main thread
            log.warning(
                "PreemptionGuard: not on the main thread; signal handlers "
                "NOT installed, only request_stop() will trigger a stop")
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            for s, h in self._old.items():
                signal.signal(s, h)
            self._installed = False

    def request_stop(self) -> None:
        """Programmatic preemption (tests, external watchdogs)."""
        self._flag.set()

    @property
    def requested(self) -> bool:
        """This process's flag."""
        return self._flag.is_set()

    def should_stop(self) -> bool:
        """True once this process was signalled or asked to stop."""
        import torch.distributed as dist

        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            raise NotImplementedError(
                "PreemptionGuard: agreeing the stop across processes is not "
                "ported yet (ROADMAP queue 1 item 8, multi-device)")
        return self._flag.is_set()


def log_if_preempted(result, logger) -> bool:
    """Workload tail after ``fit``: when the run was preempted, warn (a
    checkpoint exists; export is skipped so the grace window is not spent
    serializing) and return True so the caller returns early."""
    if not result.preempted:
        return False
    logger.warning(
        "preempted at step %d: checkpoint saved, export skipped; "
        "relaunch with resume=True", int(result.state.step))
    return True


def resolve(preemption) -> Optional[PreemptionGuard]:
    """fit()'s argument coercion: False/None -> None, True -> a fresh
    guard, a guard -> itself."""
    if preemption is None or preemption is False:
        return None
    if preemption is True:
        return PreemptionGuard()
    return preemption
