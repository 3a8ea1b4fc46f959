"""The step loop (counterpart of ``esrecsys_tpu/train/loop.py`` ``fit``,
its core).

Ported: the step loop, the ``log_every`` and ``eval_every`` cadences,
``eval_setup_fn`` once per eval round, eval metrics averaged over
``eval_steps`` batches, examples/s from ``examples_per_step``, and the
``eval_round_s`` / ``first_dispatch_s`` stage accounting. Checkpoints,
preemption, prefetch, ``steps_per_call``, meshes, hooks, profiling and the
packed-state hooks are not ported yet: asking for any of them raises.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)


@dataclasses.dataclass
class FitResult:
    state: Any
    last_train_metrics: Dict[str, float]
    last_eval_metrics: Dict[str, float]
    steps_run: int
    # seconds per eval round, and of the first train step (which builds
    # the CUDA kernels on their first use in the process)
    eval_round_s: tuple = ()
    first_dispatch_s: float = 0.0


def _sync(tensors) -> None:
    """Wait for the device work behind ``tensors`` (no-op on the CPU)."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def fit(
    state: Any,
    train_step: Callable[[Any, Any], tuple],
    train_iter: Iterator[Any],
    num_steps: int,
    *,
    eval_step: Optional[Callable[..., Dict[str, Any]]] = None,
    eval_setup_fn: Optional[Callable[[Any], Any]] = None,
    eval_iter_fn: Optional[Callable[[], Iterator[Any]]] = None,
    eval_every: int = 0,
    eval_steps: int = 0,
    log_every: int = 100,
    examples_per_step: int = 0,
    checkpointer: Optional[Any] = None,
    checkpoint_every: int = 0,
    hooks=(),
    hook_every: int = 0,
    prefetch: int = 0,
    steps_per_call: int = 1,
    mesh: Optional[Any] = None,
    profile_dir: Optional[str] = None,
    preemption: Any = None,
    state_pack: Optional[Callable] = None,
    state_unpack: Optional[Callable] = None,
) -> FitResult:
    """Run ``train_step(state, batch) -> (state, metrics)`` up to the
    absolute step ``num_steps``, resuming from ``state.step``.

    ``eval_step(state, batch[, aux]) -> metrics`` runs every
    ``eval_every`` steps over ``eval_steps`` batches from a fresh
    ``eval_iter_fn()``, with ``aux = eval_setup_fn(state)`` computed once
    per round; the round's metrics are averaged. Every ``log_every`` steps
    the window's mean train metrics (and, with ``examples_per_step``,
    steps/s, examples/s and ms/step on the host clock) are logged. The
    last of each are returned."""
    asked = {"checkpointer": checkpointer is not None,
             "checkpoint_every": bool(checkpoint_every),
             "hooks": bool(hooks) or bool(hook_every),
             "prefetch": bool(prefetch), "steps_per_call": steps_per_call != 1,
             "mesh": mesh is not None, "profile_dir": bool(profile_dir),
             "preemption": bool(preemption),
             "state_pack": state_pack is not None or state_unpack is not None}
    missing = sorted(k for k, v in asked.items() if v)
    if missing:
        raise NotImplementedError(f"fit: {', '.join(missing)} not ported yet")
    if eval_step is not None and eval_iter_fn is None:
        raise ValueError("eval_step needs an eval_iter_fn")
    step = int(state.step)
    steps_run = 0
    window: Dict[str, list] = {}
    last_train: Dict[str, float] = {}
    last_eval: Dict[str, float] = {}
    eval_round_s: list = []
    first_dispatch_s = 0.0
    t_window = time.perf_counter()
    window_steps = 0

    def crossed(step: int, cadence: int) -> bool:
        return cadence > 0 and step % cadence == 0

    while step < num_steps:
        batch = next(train_iter)
        t_call = time.perf_counter() if steps_run == 0 else None
        state, metrics = train_step(state, batch)
        if t_call is not None:
            _sync(metrics.values())
            first_dispatch_s = time.perf_counter() - t_call
        step += 1
        steps_run += 1
        window_steps += 1
        for k, v in metrics.items():
            window.setdefault(k, []).append(v)

        if crossed(step, log_every):
            # one device->host copy per metric for the whole window
            last_train = {f"train_{k}": float(torch.stack(
                [torch.as_tensor(x) for x in v]).float().mean())
                for k, v in window.items()}
            if examples_per_step:
                dt = time.perf_counter() - t_window
                last_train.update({
                    "steps_per_sec": window_steps / dt,
                    "examples_per_sec": window_steps * examples_per_step / dt,
                    "ms_per_step": 1000.0 * dt / window_steps})
            t_window = time.perf_counter()
            window_steps = 0
            log.info("step %d: %s", step, last_train)
            window = {}

        if eval_step is not None and crossed(step, eval_every):
            _sync(metrics.values())  # pending train time stays train time
            t_eval = time.perf_counter()
            it = eval_iter_fn()
            aux = (eval_setup_fn(state),) if eval_setup_fn is not None else ()
            acc: Dict[str, list] = {}
            for _ in range(eval_steps):
                em = eval_step(state, next(it), *aux)
                for k, v in em.items():
                    acc.setdefault(k, []).append(float(v))
            last_eval = {f"eval_{k}": float(np.mean(v))
                         for k, v in acc.items()}
            eval_round_s.append(time.perf_counter() - t_eval)
            log.info("step %d: %s", step, last_eval)
    return FitResult(state, last_train, last_eval, steps_run,
                     eval_round_s=tuple(eval_round_s),
                     first_dispatch_s=first_dispatch_s)
