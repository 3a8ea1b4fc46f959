"""The port's ``fit`` against the JAX package's on a deterministic toy step
(``steps_per_call=1``): the steps at which log, eval, hook and
checkpoint fire, the tracker's records, the final save, ``preempted``
after ``request_stop()``, eval on the train iterator, and a resumed start.
Also the preemption guard itself, and a profiler trace written on the
CPU.

Tolerance: train and eval metrics are float32 sums and means of small
integers; the two packages' means may round differently in the last
bits, so they agree to a relative 1e-6. Everything else is exact.
"""

import json
import os
import signal
import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.core.tracking import MemoryTracker as JaxMemoryTracker
from esrecsys_tpu.train import PreemptionGuard as JaxGuard
from esrecsys_tpu.train import fit as jax_fit
from esrecsys_tpu_torch.core.tracking import MemoryTracker
from esrecsys_tpu_torch.train import PreemptionGuard, TrainState, fit


class JaxToy(NamedTuple):
    step: jax.Array
    w: jax.Array


def jax_step(state, batch):
    x = batch["x"]
    return JaxToy(state.step + 1, state.w + x), {"loss": jnp.sum(x)}


def jax_eval(state, batch, aux):
    return {"m": jnp.sum(state.w) + jnp.sum(batch["x"]) + aux}


def torch_step(state, batch):
    x = torch.from_numpy(batch["x"])
    state.params["w"] += x
    state.step += 1
    return state, {"loss": x.sum()}


def torch_eval(state, batch, aux):
    return {"m": state.params["w"].sum() + float(batch["x"].sum()) + aux}


def batches(start=1):
    i = start
    while True:
        yield {"x": np.full(3, i, np.float32)}
        i += 1


class Recorder:
    """A checkpointer that records what it is asked to save."""

    def __init__(self, weights):
        self.weights = weights
        self.saves, self.waits = [], 0

    def save(self, step, state):
        self.saves.append((int(step), self.weights(state).tolist()))

    def wait(self):
        self.waits += 1


def _run(package, *, init_step=0, stop_at=None, eval_on_train=False,
         **kw):
    """One fit of the toy through ``package`` ("jax" or "torch"):
    returns the result, the tracker, the checkpointer and the hook log."""
    if package == "jax":
        state = JaxToy(jnp.int32(init_step), jnp.zeros(3, jnp.float32))
        weights = lambda s: np.asarray(s.w)
        guard, tracker = JaxGuard(), JaxMemoryTracker()
        run, step, ev = jax_fit, jax_step, jax_eval
        setup = lambda s: jnp.sum(s.w) * 0.5
    else:
        state = TrainState(step=init_step, params={"w": torch.zeros(3)})
        weights = lambda s: s.params["w"].numpy().copy()
        guard, tracker = PreemptionGuard(), MemoryTracker()
        run, step, ev = fit, torch_step, torch_eval
        setup = lambda s: float(s.params["w"].sum()) * 0.5
    ckpt, hooked = Recorder(weights), []

    def hook(s, n):
        hooked.append((int(n), weights(s).tolist()))
        if n == stop_at:
            guard.request_stop()

    eval_iter_fn = None if eval_on_train else (lambda: batches(100))
    result = run(state, step, batches(), num_steps=20, eval_step=ev,
                 eval_setup_fn=setup, eval_iter_fn=eval_iter_fn,
                 eval_on_train=eval_on_train, eval_every=6, eval_steps=2,
                 log_every=4, tracker=tracker, checkpointer=ckpt,
                 checkpoint_every=5, hooks=[hook], hook_every=3,
                 preemption=guard, **kw)
    return result, tracker, ckpt, hooked


def _same_records(ours, theirs):
    assert [s for s, _ in ours] == [s for s, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k, v in b.items():
            if k in ("steps_per_sec", "examples_per_sec", "ms_per_step"):
                continue  # host-clock rates: present in both
            assert float(a[k]) == pytest.approx(float(v), rel=1e-6), k


@pytest.mark.parametrize("case", [
    dict(), dict(init_step=7), dict(stop_at=12), dict(stop_at=9,
                                                      init_step=4),
    dict(eval_on_train=True), dict(examples_per_step=3),
    dict(prefetch=0)])
def test_cadences_match_the_reference_fit(case):
    res_t, tr_t, ck_t, hk_t = _run("torch", **case)
    res_j, tr_j, ck_j, hk_j = _run("jax", **case)
    assert res_t.steps_run == res_j.steps_run
    assert res_t.preempted == res_j.preempted == ("stop_at" in case)
    assert res_t.state.step == int(res_j.state.step)
    np.testing.assert_array_equal(res_t.state.params["w"].numpy(),
                                  np.asarray(res_j.state.w))
    assert hk_t == hk_j and hk_t  # hooks: steps and the state they saw
    assert ck_t.saves == ck_j.saves  # cadenced saves, then the final one
    assert ck_t.waits == ck_j.waits == 1
    assert ck_t.saves[-1][0] == res_t.state.step
    _same_records(tr_t.records, tr_j.records)
    assert len(res_t.ckpt_save_s) == len(ck_t.saves)
    assert len(res_t.eval_round_s) == len(res_j.eval_round_s)


def test_options_that_stay_unported_raise():
    state = TrainState(step=0, params={"w": torch.zeros(3)})
    for kw in (dict(steps_per_call=4), dict(mesh=object()),
               dict(state_pack=lambda s: s)):
        with pytest.raises(NotImplementedError, match="not ported"):
            fit(state, torch_step, batches(), 2, **kw)
    with pytest.raises(ValueError, match="eval_iter_fn"):
        fit(state, torch_step, batches(), 2, eval_step=torch_eval)


def test_profile_dir_writes_a_chrome_trace_on_the_cpu(tmp_path):
    state = TrainState(step=0, params={"w": torch.zeros(3)})
    res = fit(state, torch_step, batches(), 6, profile_dir=str(tmp_path),
              profile_steps=2)
    assert res.steps_run == 6
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert events and not any(e.get("cat") == "kernel" for e in events)


def test_guard_latches_sigterm_and_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested and guard.should_stop()
    assert signal.getsignal(signal.SIGTERM) is before


def test_guard_outside_main_thread_degrades():
    out = {}

    def run():
        with PreemptionGuard() as g:
            out["before"] = g.requested
            g.request_stop()
            out["after"] = g.should_stop()

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert out == {"before": False, "after": True}
