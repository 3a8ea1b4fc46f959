"""The lazy momentum carrier's optimizer functions in the port
(``esrecsys_tpu_torch/ops/optim.py``) against the JAX package's
(``esrecsys_tpu/ops/optim.py``), and against dense SGD momentum (optax).

Every case feeds the same seeded numpy inputs to both sides. Idle rows are
planted: ``last_step`` holds rows settled at the current step (0 idle
steps), one step back and many steps back (up to 40, where 0.98^40 is
0.45).

Tolerances: against the JAX functions 1e-6 relative and absolute for the
settlement deltas, flushes and settles (the same float32 operations in the
same order; ``mu ** k`` may differ by an ulp between XLA's and PyTorch's
``pow``), 1e-5 relative and 1e-6 absolute for an update with duplicate
ids (their gradients summed in another order); ``last_step`` bit-equal.
Against dense SGD momentum, the bounds of ``tests/test_optim.py``: 1e-5
relative and 1e-6 absolute (1e-6 relative for plain SGD).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esrecsys_tpu.ops import optim as jopt
from esrecsys_tpu_torch.ops import optim as topt

MUS = [0.0, 0.9, 0.98]


def _t(a):
    return torch.from_numpy(np.array(a))


def _state(rng, R, D, step):
    """(table, momentum, last_step) with rows idle 0, 1 and many steps."""
    table = rng.normal(size=(R, D)).astype(np.float32)
    mom = rng.normal(size=(R, D)).astype(np.float32)
    last = rng.integers(0, step + 1, R).astype(np.int32)
    last[:3] = [step, step - 1, 0]
    return table, mom, last


def _jstate(mom, last):
    return {"momentum": jnp.asarray(mom), "last_step": jnp.asarray(last)}


def _tstate(mom, last):
    return {"momentum": _t(mom), "last_step": _t(last)}


def _close(t, j, rtol=1e-6, atol=1e-6, msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_momentum_init_per_carrier():
    table = torch.zeros(256, 4)
    dense = topt.momentum_init(table)
    lazy = topt.momentum_init(table, lazy=True)
    assert set(dense) == {"momentum"}
    assert set(lazy) == set(jopt.momentum_init(jnp.zeros((256, 4))))
    assert lazy["momentum"].dtype == torch.float32
    assert lazy["last_step"].dtype == torch.int32
    assert lazy["last_step"].shape == (256,)
    assert not lazy["momentum"].any() and not lazy["last_step"].any()


@pytest.mark.parametrize("mu", MUS)
def test_catchup_rows_match_jax(mu):
    rng = np.random.default_rng(0)
    R, D, step = 64, 4, 40
    _, mom, last = _state(rng, R, D, step)
    ids = np.concatenate([[0, 1, 2, 2], rng.integers(0, R, 20)]).astype(
        np.int32)
    want = jopt.momentum_catchup_rows(_jstate(mom, last), jnp.asarray(ids),
                                      lr=0.05, mu=mu, step=jnp.int32(step))
    got = topt.momentum_catchup_rows(_tstate(mom, last), _t(ids), lr=0.05,
                                     mu=mu, step=step)
    _close(got, want)
    # a row settled at this step has nothing pending
    assert not got[0].any()


@pytest.mark.parametrize("mu", MUS)
@pytest.mark.parametrize("dim", [3, 4, 32])
def test_lazy_update_matches_jax(mu, dim):
    """Heavy duplication (rows 3 and 7 three and two times, the idle-0,
    idle-1 and idle-40 rows touched), over three consecutive steps."""
    rng = np.random.default_rng(1)
    R, step = 48, 40
    table, mom, last = _state(rng, R, dim, step)
    jt, js = jnp.asarray(table), _jstate(mom, last)
    tt, ts = _t(table), _tstate(mom, last)
    for s in range(step, step + 3):
        ids = np.concatenate([[3, 3, 7, 3, 7, 0, 1, 2],
                              rng.integers(0, R, 12)]).astype(np.int32)
        g = rng.normal(size=(len(ids), dim)).astype(np.float32)
        jt, js = jopt.lazy_momentum_update(jt, js, jnp.asarray(ids),
                                           jnp.asarray(g), lr=0.05, mu=mu,
                                           step=jnp.int32(s))
        topt.lazy_momentum_update(tt, ts, _t(ids), _t(g), lr=0.05, mu=mu,
                                  step=s)
        _close(tt, jt, rtol=1e-5, msg=f"table, step {s}")
        _close(ts["momentum"], js["momentum"], rtol=1e-5,
               msg=f"momentum, step {s}")
        np.testing.assert_array_equal(ts["last_step"].numpy(),
                                      np.asarray(js["last_step"]))


@pytest.mark.parametrize("mu", MUS)
def test_flush_matches_jax_and_leaves_the_state(mu):
    rng = np.random.default_rng(2)
    table, mom, last = _state(rng, 40, 4, 25)
    want = jopt.momentum_flush(jnp.asarray(table), _jstate(mom, last),
                               lr=0.1, mu=mu, step=jnp.int32(25))
    tt, ts = _t(table), _tstate(mom, last)
    got = topt.momentum_flush(tt, ts, lr=0.1, mu=mu, step=25)
    _close(got, want)
    np.testing.assert_array_equal(tt.numpy(), table)
    np.testing.assert_array_equal(ts["momentum"].numpy(), mom)
    np.testing.assert_array_equal(ts["last_step"].numpy(), last)


@pytest.mark.parametrize("mu", [0.9, 0.98])
def test_settle_matches_jax(mu):
    rng = np.random.default_rng(3)
    table, mom, last = _state(rng, 40, 4, 25)
    jt, js = jopt.momentum_settle(jnp.asarray(table), _jstate(mom, last),
                                  lr=0.1, mu=mu, step=jnp.int32(25))
    tt, ts = _t(table), _tstate(mom, last)
    topt.momentum_settle(tt, ts, lr=0.1, mu=mu, step=25)
    _close(tt, jt)
    _close(ts["momentum"], js["momentum"])
    np.testing.assert_array_equal(ts["last_step"].numpy(),
                                  np.asarray(js["last_step"]))


def _dense_momentum_run(table, grads_per_step, lr, mu):
    """optax.sgd(momentum) with full-table (scattered) gradients."""
    tx = optax.sgd(lr, momentum=mu)
    table = jnp.asarray(table)
    state = tx.init(table)
    for g in grads_per_step:
        updates, state = tx.update(jnp.asarray(g), state, table)
        table = optax.apply_updates(table, updates)
    return np.asarray(table)


def _scattered(R, D, ids, g):
    dense = np.zeros((R, D), np.float32)
    np.add.at(dense, ids, g)
    return dense


def test_lazy_momentum_matches_dense_with_flush():
    """``tests/test_optim.py:19``."""
    rng = np.random.default_rng(0)
    R, D, lr, mu, steps = 50, 4, 0.1, 0.9, 7
    table0 = rng.normal(size=(R, D)).astype(np.float32)
    ids_l = [rng.integers(0, R, 6).astype(np.int32) for _ in range(steps)]
    gs = [rng.normal(size=(6, D)).astype(np.float32) for _ in range(steps)]
    want = _dense_momentum_run(
        table0, [_scattered(R, D, i, g) for i, g in zip(ids_l, gs)], lr, mu)
    table = _t(table0)
    state = topt.momentum_init(table, lazy=True)
    for s, (ids, g) in enumerate(zip(ids_l, gs)):
        topt.lazy_momentum_update(table, state, _t(ids), _t(g), lr=lr, mu=mu,
                                  step=s)
    settled = topt.momentum_flush(table, state, lr=lr, mu=mu, step=steps)
    _close(settled, want, rtol=1e-5)


def test_lazy_momentum_duplicate_ids_match_dense():
    """``tests/test_optim.py:44``."""
    rng = np.random.default_rng(1)
    R, D, lr, mu = 10, 3, 0.05, 0.8
    table0 = rng.normal(size=(R, D)).astype(np.float32)
    ids = np.asarray([3, 3, 7, 3, 7, 1], np.int32)
    g = rng.normal(size=(6, D)).astype(np.float32)
    want = _dense_momentum_run(table0, [_scattered(R, D, ids, g)], lr, mu)
    table = _t(table0)
    state = topt.momentum_init(table, lazy=True)
    topt.lazy_momentum_update(table, state, _t(ids), _t(g), lr=lr, mu=mu,
                              step=0)
    _close(topt.momentum_flush(table, state, lr=lr, mu=mu, step=1), want,
           rtol=1e-5)


def test_lazy_momentum_mu_zero_is_plain_sgd():
    """``tests/test_optim.py:60``."""
    rng = np.random.default_rng(2)
    table0 = rng.normal(size=(8, 2)).astype(np.float32)
    ids = np.asarray([0, 2, 2], np.int32)
    g = rng.normal(size=(3, 2)).astype(np.float32)
    table = _t(table0)
    topt.lazy_momentum_update(table, topt.momentum_init(table, lazy=True),
                              _t(ids), _t(g), lr=0.5, mu=0.0, step=0)
    want = table0.copy()
    np.add.at(want, ids, -0.5 * g)
    _close(table, want, rtol=1e-6, atol=0)


def _lazy_run(rng, R, D, steps, lr, mu):
    table = _t(rng.normal(size=(R, D)).astype(np.float32))
    state = topt.momentum_init(table, lazy=True)
    for s in range(steps):
        ids = _t(rng.integers(0, R, 6).astype(np.int32))
        g = _t(rng.normal(size=(6, D)).astype(np.float32))
        topt.lazy_momentum_update(table, state, ids, g, lr=lr, mu=mu, step=s)
    return table, state


def test_momentum_settle_is_flush_plus_advanced_state():
    """``tests/test_optim.py:177``: settle equals the flush, and a flush or
    settle right after it is a no-op."""
    rng = np.random.default_rng(5)
    lr, mu = 0.1, 0.9
    table, state = _lazy_run(rng, 40, 4, 5, lr, mu)
    flushed = topt.momentum_flush(table, state, lr=lr, mu=mu, step=5)
    topt.momentum_settle(table, state, lr=lr, mu=mu, step=5)
    assert torch.equal(table, flushed)
    assert torch.equal(topt.momentum_flush(table, state, lr=lr, mu=mu,
                                           step=5), table)
    assert (state["last_step"] == 5).all()


def test_settle_then_continue_matches_dense():
    """``tests/test_optim.py:203``: a settle barrier mid-run (an lr-phase
    boundary) leaves lazy plus flush on the dense trajectory."""
    rng = np.random.default_rng(6)
    R, D, lr, mu, steps = 30, 4, 0.05, 0.9, 8
    table0 = rng.normal(size=(R, D)).astype(np.float32)
    ids_l = [rng.integers(0, R, 5).astype(np.int32) for _ in range(steps)]
    gs = [rng.normal(size=(5, D)).astype(np.float32) for _ in range(steps)]
    want = _dense_momentum_run(
        table0, [_scattered(R, D, i, g) for i, g in zip(ids_l, gs)], lr, mu)
    table = _t(table0)
    state = topt.momentum_init(table, lazy=True)
    for s in range(steps):
        if s == steps // 2:
            topt.momentum_settle(table, state, lr=lr, mu=mu, step=s)
        topt.lazy_momentum_update(table, state, _t(ids_l[s]), _t(gs[s]),
                                  lr=lr, mu=mu, step=s)
    _close(topt.momentum_flush(table, state, lr=lr, mu=mu, step=steps),
           want, rtol=1e-5)


def test_out_of_range_ids_are_dropped():
    """Ids outside ``[0, R)`` change no row and no ``last_step``, as the
    scatters drop them; the in-range ids update as without them."""
    rng = np.random.default_rng(7)
    R, D = 16, 4
    table0 = rng.normal(size=(R, D)).astype(np.float32)
    ids = np.asarray([2, 5, 2], np.int32)
    g = rng.normal(size=(3, D)).astype(np.float32)
    runs = []
    for extra in ([], [-1, R]):
        table = _t(table0)
        state = topt.momentum_init(table, lazy=True)
        all_ids = np.concatenate([ids, extra]).astype(np.int32)
        all_g = np.concatenate([g, np.ones((len(extra), D), np.float32)])
        topt.lazy_momentum_update(table, state, _t(all_ids), _t(all_g),
                                  lr=0.1, mu=0.9, step=3)
        runs.append((table, state))
    (t0, s0), (t1, s1) = runs
    assert torch.equal(t0, t1)
    assert torch.equal(s0["momentum"], s1["momentum"])
    assert torch.equal(s0["last_step"], s1["last_step"])
    assert s1["last_step"].tolist() == [0, 0, 4, 0, 0, 4] + [0] * (R - 6)
