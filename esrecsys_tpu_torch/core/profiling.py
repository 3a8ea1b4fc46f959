"""Profiling and step timing (counterpart of
``esrecsys_tpu/core/profiling.py``).

``trace`` captures a ``torch.profiler`` trace and writes it as a Chrome
trace (``chrome://tracing`` or Perfetto read it; no tensorboard package
is needed). ``StepTimer`` gives examples/s over a window of steps on the
host clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


def start_trace(log_dir: str, cuda: Optional[bool] = None
                ) -> torch.profiler.profile:
    """Start a profiler whose trace lands in ``log_dir`` as
    ``trace-<pid>-<ns>.json`` when :func:`stop_trace` stops it. Device
    activity is traced when ``cuda`` is true (default: when a card is
    available); a CPU run asks for CPU activity only."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=lambda p: p.export_chrome_trace(path))
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile) -> None:
    """Stop ``prof`` (waiting for the card first) and write its trace."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def trace(log_dir: Optional[str], cuda: Optional[bool] = None
          ) -> Iterator[None]:
    """Trace the body into ``log_dir`` if it is given."""
    if not log_dir:
        yield
        return
    prof = start_trace(log_dir, cuda)
    try:
        yield
    finally:
        stop_trace(prof)


class StepTimer:
    """Wall-clock examples/sec over a sliding window of steps."""

    def __init__(self, examples_per_step: int, window: int = 100):
        self.examples_per_step = examples_per_step
        self.window = window
        self._t0 = time.perf_counter()
        self._steps_in_window = 0
        self._examples_in_window = 0.0

    def tick(self, examples: Optional[float] = None,
             force: bool = False) -> Optional[Dict[str, float]]:
        """Call once per step; returns stats every ``window`` steps.

        ``examples`` overrides the per-step example count for this tick;
        ``force`` emits stats for a partial window (a log step that does
        not close a whole window).
        """
        self._steps_in_window += 1
        self._examples_in_window += (
            self.examples_per_step if examples is None else examples)
        if self._steps_in_window < self.window and not force:
            return None
        t1 = time.perf_counter()
        dt = t1 - self._t0
        stats = {
            "steps_per_sec": self._steps_in_window / dt,
            "examples_per_sec": self._examples_in_window / dt,
            "ms_per_step": 1000.0 * dt / self._steps_in_window,
        }
        self._t0 = t1
        self._steps_in_window = 0
        self._examples_in_window = 0.0
        return stats
