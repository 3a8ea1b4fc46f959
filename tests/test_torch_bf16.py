"""bf16 tables in the port against the JAX package: the gather and
scatter-add kernels' plain versions on bf16 tables (and the narrow rows
the card's narrow instantiation takes), their launch plans, the lazy
momentum carrier and LazyAdam with bf16 state, dense Adam against optax,
and ``scale_table --dtype bfloat16``.

Inputs come from numpy seeds. The JAX functions run eagerly, one XLA
operation at a time, as their code reads: jitted, XLA may fuse a multiply
and an add into one rounding, or keep a bf16 product in float32.

Tolerances:
- the gather of bf16 rows widened to float32: bit-equal to ``jnp.take``
  widened (the widening is exact);
- the bf16 scatter-add: bit-equal on rows hit once; a row hit k times
  within k (ulp(M) + M 2^-22) of the exact sum of the table and the
  bf16-rounded updates (M = |t| + sum |round(u)|), since each add rounds
  to bf16 in an order the reference does not fix;
- the optimizers with bf16 state: each element within 1 bf16 ulp of the
  JAX result (the float32 arithmetic matches to float32 rounding, e.g.
  XLA's ``pow`` against PyTorch's, and a last-bit difference can flip a
  bf16 rounding); their float32 outputs (settlement deltas) within 1e-6;
- LazyAdam in float32 within 1e-6 relative and absolute, 1e-5 relative
  with duplicate ids (their gradients summed in another order); dense
  Adam against optax within 1e-6 relative and 1e-7 absolute after 5
  steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esrecsys_tpu.ops import optim as jopt
from esrecsys_tpu_torch.kernels import gather_pool as tgather
from esrecsys_tpu_torch.kernels import scatter_add as tscatter
from esrecsys_tpu_torch.ops import optim as topt
from esrecsys_tpu_torch.ops.lookup import gather_rows
from esrecsys_tpu_torch.tools import scale_table as tst

BF16 = torch.bfloat16


def _bf16_np(a):
    """A float32 array rounded to bf16, as float32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _tb(a):
    return torch.from_numpy(np.array(a, np.float32)).to(BF16)


def _ulps(got: torch.Tensor, want) -> np.ndarray:
    """|got - want| in bf16 ulps of the larger magnitude."""
    g = got.double().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
    return np.abs(g - w) / np.exp2(np.floor(np.log2(mag)) - 7)


def _within_one_ulp(got, want, msg=""):
    assert got.dtype == BF16, msg
    assert _ulps(got, want).max() <= 1, msg


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("dim", [1, 3, 8, 32, 64])
def test_bf16_gather_plain_is_take_widened(dim):
    rng = np.random.default_rng(dim)
    table = _bf16_np(rng.normal(size=(300, dim)))
    ids = rng.integers(0, 300, 777).astype(np.int32)
    want = jnp.take(jnp.asarray(table, jnp.bfloat16), jnp.asarray(ids),
                    axis=0).astype(jnp.float32)
    got = tgather.gather_pool(_tb(table), _t(ids)[:, None])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gather_rows(_tb(table), _t(ids)).numpy(),
                                  np.asarray(want))


def test_bf16_pooled_gather_sums_widened_rows():
    rng = np.random.default_rng(5)
    table = _tb(rng.normal(size=(50, 12)))
    ids = _t(rng.integers(0, 50, (9, 4)).astype(np.int32))
    ids[0, 1] = 0
    got = tgather.gather_pool(table, ids, mean=True, mask_id=0)
    want = tgather.gather_pool(table.float(), ids, mean=True, mask_id=0)
    assert torch.equal(got, want)


def _exact_and_bound(table, ids, upd):
    """Exact float64 sum of a bf16 scatter-add and its per-element bound
    (see the module docstring)."""
    ub = _bf16_np(upd).astype(np.float64)
    exact = table.astype(np.float64).copy()
    mag = np.abs(exact)
    np.add.at(exact, ids, ub)
    np.add.at(mag, ids, np.abs(ub))
    adds = np.bincount(ids, minlength=table.shape[0]).astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return exact, adds[:, None] * (ulp + mag * 2.0 ** -22), adds


@pytest.mark.parametrize("dim", [1, 3, 32, 64])
@pytest.mark.parametrize("dups", [False, True], ids=["unique", "dups"])
def test_bf16_scatter_plain_matches_jax(dim, dups):
    rng = np.random.default_rng(dim * 2 + dups)
    R, n = 400, 300
    table = _bf16_np(rng.normal(size=(R, dim)) * 0.1)
    ids = (rng.integers(0, 60, n) if dups
           else rng.permutation(R)[:n]).astype(np.int32)
    upd = (rng.normal(size=(n, dim)) * 1e-2).astype(np.float32)
    want = jnp.asarray(table, jnp.bfloat16).at[jnp.asarray(ids)].add(
        jnp.asarray(upd).astype(jnp.bfloat16))
    got = tscatter.scatter_add(_tb(table), _t(ids), _t(upd))
    assert got.dtype == BF16
    exact, bound, adds = _exact_and_bound(table, ids, upd)
    once = adds == 1
    np.testing.assert_array_equal(
        got.float().numpy()[once],
        np.asarray(want.astype(jnp.float32))[once])
    for g in (got.double().numpy(), np.asarray(want.astype(jnp.float32),
                                                np.float64)):
        assert np.all(np.abs(g - exact) <= bound + (adds[:, None] == 0))


def test_bf16_scatter_drops_out_of_range_ids():
    table = torch.zeros(4, 8, dtype=BF16)
    ids = torch.tensor([-1, 2, 4, 2], dtype=torch.int32)
    got = tscatter.scatter_add(table, ids, torch.ones(4, 8))
    want = torch.zeros(4, 8, dtype=BF16)
    want[2] = 2
    assert torch.equal(got, want) and got is table


# (dim, dtype, table pointer) -> the instantiation
@pytest.mark.parametrize("dim,dtype,ptr,kind", [
    (32, torch.float32, 1 << 20, tgather.F32X4),
    (4, torch.float32, 16, tgather.F32X4),
    (32, torch.float32, (1 << 20) + 4, tgather.NARROW_F32),
    (1, torch.float32, 1 << 20, tgather.NARROW_F32),
    (6, torch.float32, 1 << 20, tgather.NARROW_F32),
    (32, BF16, 1 << 20, tgather.BF16X8),
    (8, BF16, 16, tgather.BF16X8),
    (4, BF16, 1 << 20, tgather.NARROW_BF16),
    (32, BF16, (1 << 20) + 2, tgather.NARROW_BF16),
    (1, BF16, 1 << 20, tgather.NARROW_BF16)],
    ids=["f32_d32", "f32_d4", "f32_d32_off_16", "f32_d1", "f32_d6",
         "bf16_d32", "bf16_d8", "bf16_d4", "bf16_d32_off_16", "bf16_d1"])
def test_gather_launch_plan_picks_the_instantiation(dim, dtype, ptr, kind):
    assert tgather.launch_plan(dim, dtype, ptr) == kind


# (n, dim, CTAs) of a bf16 table: a lane takes 8 bf16, at most 32 rows a
# warp (4 a lane at D=32), 8 warps a CTA
@pytest.mark.parametrize("n,dim,blocks", [
    (262_144, 32, 1024), (256, 32, 1), (257, 32, 2), (4096, 64, 16),
    (10_000, 128, 79), (4096, 1, 2), (10, 3, 1)])
def test_bf16_scatter_launch_plan(n, dim, blocks):
    width, got = tscatter.launch_plan(n, dim, 0, 0, BF16)
    assert got == blocks
    assert width == (dim if dim in tscatter.VECTOR_WIDTHS else 0)
    assert tscatter.instantiation_name(width, BF16) == (
        f"bf16_d{dim}" if width else "bf16_generic")


def test_bf16_kernels_reject_what_they_do_not_take():
    with pytest.raises(TypeError):
        tgather.gather_pool(torch.ones(4, 8, dtype=torch.float16),
                            torch.zeros(2, 1, dtype=torch.int32))
    with pytest.raises(TypeError):  # updates must be float32
        tscatter.scatter_add(torch.zeros(4, 8, dtype=BF16),
                             torch.zeros(2, dtype=torch.int32),
                             torch.ones(2, 8, dtype=BF16))
    before = (tgather.LAUNCHES.count, tscatter.LAUNCHES.count)
    with pytest.raises(ValueError, match="CUDA"):
        tgather.gather_pool(torch.ones(4, 1, dtype=BF16, device="meta"),
                            torch.zeros(2, 1, dtype=torch.int32,
                                        device="meta"))
    assert (tgather.LAUNCHES.count, tscatter.LAUNCHES.count) == before


# ------------------------------------------------------ momentum carrier

def _lazy_state(rng, R, D, step):
    table = _bf16_np(rng.normal(size=(R, D)))
    mom = _bf16_np(rng.normal(size=(R, D)) * 0.1)
    last = rng.integers(0, step + 1, R).astype(np.int32)
    last[:3] = [step, step - 1, 0]
    return table, mom, last


def test_momentum_init_takes_the_dtype():
    table = torch.zeros(256, 4, dtype=BF16)
    state = topt.momentum_init(table, lazy=True, dtype=BF16)
    want = jopt.momentum_init(jnp.zeros((256, 4), jnp.bfloat16),
                              dtype=jnp.bfloat16)
    assert state["momentum"].dtype == BF16
    assert want["momentum"].dtype == jnp.bfloat16
    assert state["last_step"].dtype == torch.int32
    assert topt.momentum_init(table)["momentum"].dtype == torch.float32


@pytest.mark.parametrize("mu", [0.9, 0.98])
@pytest.mark.parametrize("dim", [3, 32])
def test_bf16_lazy_momentum_update_matches_jax(mu, dim):
    rng = np.random.default_rng(int(mu * 100) + dim)
    R, step = 64, 40
    table, mom, last = _lazy_state(rng, R, dim, step)
    ids = np.concatenate([[0, 1, 2, 2], rng.integers(0, R, 28)]).astype(
        np.int32)
    grads = (rng.normal(size=(ids.size, dim)) * 0.1).astype(np.float32)
    jstate = {"momentum": jnp.asarray(mom, jnp.bfloat16),
              "last_step": jnp.asarray(last)}
    jt, js = jopt.lazy_momentum_update(
        jnp.asarray(table, jnp.bfloat16), jstate, jnp.asarray(ids),
        jnp.asarray(grads), lr=0.05, mu=mu, step=jnp.int32(step))
    tt = _tb(table)
    ts = {"momentum": _tb(mom), "last_step": _t(last)}
    # the catch-up rows, float32, before the update moves the state
    want = jopt.momentum_catchup_rows(jstate, jnp.asarray(ids), lr=0.05,
                                      mu=mu, step=jnp.int32(step))
    got = topt.momentum_catchup_rows(ts, _t(ids), lr=0.05, mu=mu, step=step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    topt.lazy_momentum_update(tt, ts, _t(ids), _t(grads), lr=0.05, mu=mu,
                              step=step)
    _within_one_ulp(tt, jt, "table")
    _within_one_ulp(ts["momentum"], js["momentum"], "momentum")
    np.testing.assert_array_equal(ts["last_step"].numpy(),
                                  np.asarray(js["last_step"]))


@pytest.mark.parametrize("mu", [0.9, 0.98])
def test_bf16_flush_and_settle_match_jax(mu):
    rng = np.random.default_rng(7)
    table, mom, last = _lazy_state(rng, 64, 8, 40)
    jstate = {"momentum": jnp.asarray(mom, jnp.bfloat16),
              "last_step": jnp.asarray(last)}
    jtable = jnp.asarray(table, jnp.bfloat16)
    ts = {"momentum": _tb(mom), "last_step": _t(last)}
    tt = _tb(table)
    want = jopt.momentum_flush(jtable, jstate, lr=0.05, mu=mu,
                               step=jnp.int32(40))
    got = topt.momentum_flush(tt, ts, lr=0.05, mu=mu, step=40)
    assert want.dtype == jnp.bfloat16
    _within_one_ulp(got, want, "flush")
    assert torch.equal(tt, _tb(table))  # untouched
    st, sstate = jopt.momentum_settle(jtable, jstate, lr=0.05, mu=mu,
                                      step=jnp.int32(40))
    topt.momentum_settle(tt, ts, lr=0.05, mu=mu, step=40)
    _within_one_ulp(tt, st, "settled table")
    _within_one_ulp(ts["momentum"], sstate["momentum"], "settled momentum")
    assert (ts["last_step"] == 40).all()


# --------------------------------------------------------------- LazyAdam

def test_adam_init_takes_the_dtype():
    for dtype, jdtype in ((torch.float32, jnp.float32), (BF16, jnp.bfloat16)):
        got = topt.adam_init(torch.zeros(10, 3), dtype)
        want = jopt.adam_init(jnp.zeros((10, 3)), jdtype)
        assert set(got) == set(want) == {"m", "v"}
        assert all(t.dtype == dtype and t.shape == (10, 3) and not t.any()
                   for t in got.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dup", [False, True], ids=["unique", "dups"])
def test_lazy_adam_matches_jax(dtype, dup):
    rng = np.random.default_rng(11 + dup)
    R, D = 50, 4
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, BF16)
    table = _bf16_np(rng.normal(size=(R, D)))
    jt = jnp.asarray(table, jd)
    js = {"m": jnp.asarray(_bf16_np(rng.normal(size=(R, D)) * 0.1), jd),
          "v": jnp.asarray(_bf16_np(rng.uniform(0, 0.01, (R, D))), jd)}
    tt = torch.from_numpy(table.copy()).to(td)
    ts = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(td)
          for k, v in js.items()}
    for step in range(4):
        ids = (rng.integers(0, 12, 20) if dup
               else rng.permutation(R)[:20]).astype(np.int32)
        grads = rng.normal(size=(20, D)).astype(np.float32)
        jt, js = jopt.lazy_adam_update(jt, js, jnp.asarray(ids),
                                       jnp.asarray(grads), lr=0.01,
                                       step=jnp.int32(step))
        topt.lazy_adam_update(tt, ts, _t(ids), _t(grads), lr=0.01, step=step)
    pairs = [(tt, jt, "table")] + [(ts[k], js[k], k) for k in ("m", "v")]
    for got, want, name in pairs:
        if dtype == "bfloat16":
            _within_one_ulp(got, want, name)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5 if dup else 1e-6,
                                       atol=1e-6, err_msg=name)


def test_lazy_adam_with_every_row_touched_is_dense_adam():
    """Every row touched once a step: LazyAdam is optax's Adam."""
    rng = np.random.default_rng(3)
    R, D = 16, 4
    table = rng.normal(size=(R, D)).astype(np.float32)
    tx = optax.adam(0.01)
    params = jnp.asarray(table)
    opt = tx.init(params)
    tt, ts = _t(table), topt.adam_init(_t(table))
    for step in range(5):
        ids = rng.permutation(R).astype(np.int32)
        grads = rng.normal(size=(R, D)).astype(np.float32)
        dense = np.zeros_like(grads)
        dense[ids] = grads
        upd, opt = tx.update(jnp.asarray(dense), opt)
        params = optax.apply_updates(params, upd)
        topt.lazy_adam_update(tt, ts, _t(ids), _t(grads), lr=0.01, step=step)
    np.testing.assert_allclose(tt.numpy(), np.asarray(params), rtol=1e-6,
                               atol=1e-7)


def test_dense_adam_matches_optax():
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(30, 5)).astype(np.float32)
    tx = optax.adam(5e-4)
    params = jnp.asarray(p0)
    opt = tx.init(params)
    upd_fn = jax.jit(tx.update)
    p = _t(p0)
    state = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
    for step in range(5):
        g = rng.normal(size=p0.shape).astype(np.float32)
        g[:5] = 0.0  # rows a batch did not touch
        upd, opt = upd_fn(jnp.asarray(g), opt)
        params = optax.apply_updates(params, upd)
        topt.adam_update(p, _t(g), state, lr=5e-4, step=step)
    adam = opt[0]
    for got, want in ((p, params), (state["mu"], adam.mu),
                      (state["nu"], adam.nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    assert int(adam.count) == 5


# ------------------------------------------------------------ scale_table

def test_scale_table_bf16_momentum_zero_step_matches_jax():
    """One momentum-0 step of a bf16 table: the gradient of
    ``vdot(tanh(rows), w)`` at the widened rows, ``-lr * g`` rounded to
    bf16 and added (the reference's ``(-lr * g).astype(bf16)`` and
    ``at[].add``)."""
    cfg = tst.ScaleConfig(rows=200, dim=8, ids_per_step=64, device="cpu",
                          learning_rate=0.5)
    table, state = tst.init(cfg, torch.device("cpu"))
    assert table.dtype == BF16 and state is None
    before = jnp.asarray(table.float().numpy()).astype(jnp.bfloat16)
    tst.make_step(cfg, table, state)(0)
    ids = tst.step_ids(cfg, 0, torch.Generator()).numpy()
    rows = jnp.take(before, jnp.asarray(ids), axis=0).astype(jnp.float32)
    g = 1.0 - jnp.tanh(rows) ** 2
    want = before.at[jnp.asarray(ids)].add(
        (-cfg.learning_rate * g).astype(jnp.bfloat16))
    _within_one_ulp(table, want, "table")


def test_scale_table_bf16_lazy_state_takes_the_table_dtype(capsys):
    cfg = tst.ScaleConfig(rows=300, dim=4, ids_per_step=16, momentum=0.98,
                          device="cpu")
    table, state = tst.init(cfg, torch.device("cpu"))
    assert table.dtype == state["momentum"].dtype == BF16
    out = tst.main(["--rows", "300", "--dim", "4", "--ids_per_step", "16",
                    "--steps_per_call", "2", "--calls", "2", "--momentum",
                    "0.98", "--dtype", "bfloat16", "--device", "cpu"])
    assert out["dtype"] == "bfloat16" and out["table_gb"] == 300 * 4 * 2 / 1e9
    assert np.isfinite(out["last_loss"]) and out["steps"] == 4
