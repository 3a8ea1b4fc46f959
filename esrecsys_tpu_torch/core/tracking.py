"""Pluggable experiment tracking (counterpart of
``esrecsys_tpu/core/tracking.py``).

Scalar metrics per step and artifact registration behind one interface,
with local implementations: ``JsonlTracker`` writes ``metrics.jsonl``,
``config.json`` and ``artifacts.jsonl`` in the reference's format. The
reference's optional wandb adapter is not carried over: the port imports
torch, numpy and the standard library only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, Mapping, Optional


class Tracker:
    """Interface: scalar metrics per step + artifact registration."""

    def log(self, metrics: Mapping[str, Any], step: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def log_artifact(self, path: str, name: str, kind: str = "model") -> None:
        pass

    def finish(self) -> None:
        pass


class NullTracker(Tracker):
    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        pass


class JsonlTracker(Tracker):
    """Append-only metrics.jsonl + artifacts.jsonl in a run directory."""

    def __init__(self, run_dir: str,
                 config: Optional[Mapping[str, Any]] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._metrics = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        if config is not None:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(dict(config), f, indent=2, default=str)

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        rec: Dict[str, Any] = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._metrics.write(json.dumps(rec) + "\n")
        self._metrics.flush()

    def log_artifact(self, path: str, name: str, kind: str = "model") -> None:
        with open(os.path.join(self.run_dir, "artifacts.jsonl"), "a") as f:
            f.write(json.dumps({"path": path, "name": name, "kind": kind})
                    + "\n")

    def finish(self) -> None:
        self._metrics.close()


class MemoryTracker(Tracker):
    """In-memory tracker for tests."""

    def __init__(self) -> None:
        self.records: list = []
        self.artifacts: list = []

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        self.records.append((int(step), {k: v for k, v in metrics.items()}))

    def log_artifact(self, path: str, name: str, kind: str = "model") -> None:
        self.artifacts.append((path, name, kind))


class CompositeTracker(Tracker):
    def __init__(self, trackers: Iterable[Tracker]):
        self.trackers = list(trackers)

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        for t in self.trackers:
            t.log(metrics, step)

    def log_artifact(self, path: str, name: str, kind: str = "model") -> None:
        for t in self.trackers:
            t.log_artifact(path, name, kind)

    def finish(self) -> None:
        for t in self.trackers:
            t.finish()


def make_tracker(run_dir: Optional[str] = None,
                 config: Optional[Mapping[str, Any]] = None) -> Tracker:
    """A ``JsonlTracker`` in ``run_dir``, or a ``NullTracker`` without one
    and on every process but rank 0 of an initialised
    ``torch.distributed`` group (they would log the same rows)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_rank():
        return NullTracker()
    if run_dir:
        return JsonlTracker(run_dir, config)
    return NullTracker()
