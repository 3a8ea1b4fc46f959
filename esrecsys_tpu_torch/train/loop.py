"""The step loop (counterpart of ``esrecsys_tpu/train/loop.py`` ``fit``).

Ported: the step loop with the ``log_every``, ``eval_every``,
``hook_every`` and ``checkpoint_every`` cadences, the tracker, host
prefetch of the train iterator, a ``torch.profiler`` trace of the steps
after the first, preemption (a stop at the next step, a checkpoint, and
``FitResult.preempted``), the final save, ``eval_setup_fn`` once per eval
round, eval metrics averaged over ``eval_steps`` batches, examples/s from
``examples_per_step``, and the ``eval_round_s`` / ``ckpt_save_s`` /
``first_dispatch_s`` stage accounting. ``steps_per_call`` (a TPU dispatch
trick), ``mesh`` and the packed-state hooks are not ported: asking for
them raises.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from esrecsys_tpu_torch.core.profiling import StepTimer, start_trace, stop_trace
from esrecsys_tpu_torch.core.tracking import NullTracker, Tracker
from esrecsys_tpu_torch.data.prefetch import prefetched
from esrecsys_tpu_torch.train import preemption as _preemption

log = logging.getLogger(__name__)


@dataclasses.dataclass
class FitResult:
    state: Any
    last_train_metrics: Dict[str, float]
    last_eval_metrics: Dict[str, float]
    steps_run: int
    # stopped by a termination signal: the state WAS checkpointed at this
    # step; callers skip the final export and exit promptly
    preempted: bool = False
    # seconds per eval round, per checkpoint save (the final one
    # included), and of the first train step (which builds the CUDA
    # kernels on their first use in the process)
    eval_round_s: tuple = ()
    ckpt_save_s: tuple = ()
    first_dispatch_s: float = 0.0


def _sync(tensors) -> None:
    """Wait for the device work behind ``tensors`` (no-op on the CPU)."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def _on_cuda(state: Any) -> bool:
    params = getattr(state, "params", None)
    if isinstance(params, torch.nn.Module):
        return any(p.is_cuda for p in params.parameters())
    if isinstance(params, dict):
        return any(isinstance(t, torch.Tensor) and t.is_cuda
                   for t in params.values())
    return False


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
    tracker: Optional[Tracker] = None,
    checkpointer: Optional[Any] = None,
    checkpoint_every: int = 0,
    hooks: Sequence[Callable[[Any, int], None]] = (),
    hook_every: int = 0,
    examples_per_step: int = 0,
    eval_on_train: bool = False,
    state_pack: Optional[Callable] = None,
    state_unpack: Optional[Callable] = None,
    prefetch: int = 2,
    steps_per_call: int = 1,
    mesh: Optional[Any] = None,
    profile_dir: Optional[str] = None,
    profile_steps: int = 20,
    preemption: Any = None,
) -> FitResult:
    """Run ``train_step(state, batch) -> (state, metrics)`` up to the
    absolute step ``num_steps``, resuming from ``state.step``.

    Args:
      eval_step: ``(state, batch[, aux]) -> metrics``, run every
        ``eval_every`` steps over ``eval_steps`` batches from a fresh
        ``eval_iter_fn()``, with ``aux = eval_setup_fn(state)`` computed
        once per round; the round's metrics are averaged. Without
        ``eval_iter_fn`` it needs ``eval_on_train=True`` and evaluates the
        next training batches.
      log_every: the window's mean train metrics (and, with
        ``examples_per_step``, steps/s, examples/s and ms/step on the host
        clock) go to ``tracker`` every ``log_every`` steps.
      checkpointer: ``save(step, state)`` every ``checkpoint_every``
        steps, and once more at the end of a run that took a step (its
        ``wait()`` then makes it durable before ``fit`` returns).
      hooks: ``hook(state, step)`` every ``hook_every`` steps.
      prefetch: pull the train iterator this many batches ahead on a
        host thread (``data/prefetch.py``); off when eval reads the train
        iterator. The iterator must do host work only.
      profile_dir: trace ``profile_steps`` steps after the first into a
        Chrome trace there (``core/profiling.py``).
      preemption: ``True`` installs a SIGTERM guard for the loop, or pass
        a managed ``train.preemption.PreemptionGuard``. Polled once a
        step: on a stop the loop saves and returns ``preempted=True``.
    """
    asked = {"steps_per_call": steps_per_call != 1, "mesh": mesh is not None,
             "state_pack": state_pack is not None or state_unpack is not None}
    missing = sorted(k for k, v in asked.items() if v)
    if missing:
        raise NotImplementedError(f"fit: {', '.join(missing)} not ported")
    tracker = tracker or NullTracker()
    if eval_step is not None and eval_iter_fn is None and not eval_on_train:
        raise ValueError(
            "eval_step given without eval_iter_fn: eval would run on "
            "training batches; pass eval_iter_fn or set eval_on_train=True")
    step = int(state.step)
    timer = (StepTimer(examples_per_step, window=max(log_every, 1))
             if examples_per_step else None)
    window: Dict[str, list] = {}
    last_train: Dict[str, float] = {}
    last_eval: Dict[str, float] = {}
    eval_round_s: list = []
    ckpt_save_s: list = []
    first_dispatch_s = 0.0

    def crossed(step: int, cadence: int) -> bool:
        return cadence > 0 and step % cadence == 0

    guard = _preemption.resolve(preemption)
    own_guard = preemption is True  # fit installs and restores the handlers
    preempted = False
    steps_run = 0
    prof = None
    # the producer thread would race eval's pulls from the train iterator
    if prefetch > 0 and not (eval_step is not None and eval_iter_fn is None):
        feed = prefetched(train_iter, depth=prefetch)
    else:
        feed = train_iter

    if own_guard:
        guard.__enter__()
    try:
        while step < num_steps:
            if profile_dir and steps_run == 1 and prof is None:
                # after the first step, so the trace is steady state
                prof = start_trace(profile_dir, cuda=_on_cuda(state))
            batch = next(feed)
            t_call = time.perf_counter() if steps_run == 0 else None
            state, metrics = train_step(state, batch)
            if t_call is not None:
                _sync(metrics.values())
                first_dispatch_s = time.perf_counter() - t_call
            step += 1
            steps_run += 1
            for k, v in metrics.items():
                window.setdefault(k, []).append(v)

            if crossed(step, log_every):
                # one device->host copy per metric for the whole window
                last_train = {f"train_{k}": float(torch.stack(
                    [torch.as_tensor(x) for x in v]).float().mean())
                    for k, v in window.items()}
                if timer is not None:
                    last_train.update(timer.tick(force=True))
                tracker.log(last_train, step)
                log.info("step %d: %s", step, last_train)
                window = {}
            elif timer is not None:
                timer.tick()

            if eval_step is not None and crossed(step, eval_every):
                _sync(metrics.values())  # pending train time stays train time
                t_eval = time.perf_counter()
                it = eval_iter_fn() if eval_iter_fn is not None else train_iter
                aux = (eval_setup_fn(state),) if eval_setup_fn is not None else ()
                acc: Dict[str, list] = {}
                for _ in range(eval_steps):
                    em = eval_step(state, next(it), *aux)
                    for k, v in em.items():
                        acc.setdefault(k, []).append(float(v))
                last_eval = {f"eval_{k}": float(np.mean(v))
                             for k, v in acc.items()}
                eval_round_s.append(time.perf_counter() - t_eval)
                tracker.log(last_eval, step)
                log.info("step %d: %s", step, last_eval)

            if hooks and crossed(step, hook_every):
                for hook in hooks:
                    hook(state, step)

            if prof is not None and steps_run >= 1 + profile_steps:
                stop_trace(prof)
                prof = None

            if checkpointer is not None and crossed(step, checkpoint_every):
                _sync(metrics.values())
                t_ck = time.perf_counter()
                checkpointer.save(step, state)
                ckpt_save_s.append(time.perf_counter() - t_ck)

            if guard is not None and guard.should_stop():
                log.warning(
                    "termination signal: stopping cleanly at step %d "
                    "(checkpoint follows; resume re-launches from it)", step)
                preempted = True
                break
    finally:
        if own_guard:
            guard.__exit__(None, None, None)
        if prof is not None:
            stop_trace(prof)

    if checkpointer is not None and steps_run:
        t_ck = time.perf_counter()
        checkpointer.save(int(state.step), state)
        # an async checkpointer overlaps the cadenced saves with training;
        # the final one is on disk before fit returns
        wait = getattr(checkpointer, "wait", None)
        if wait is not None:
            wait()
        ckpt_save_s.append(time.perf_counter() - t_ck)
    return FitResult(state, last_train, last_eval, steps_run, preempted,
                     eval_round_s=tuple(eval_round_s),
                     ckpt_save_s=tuple(ckpt_save_s),
                     first_dispatch_s=first_dispatch_s)
