"""The lazy momentum carrier in the port's playlist workload against the
JAX package: the row-sparse step, ``settled_params``,
``settle_momentum_state`` at an lr boundary, the exact and fused evals on
a lazy state, ``restore_adapt_carrier`` in both directions, and
``state_from_jax`` and the port's checkpoints carrying ``last_step``;
then the ``auto`` resolution past the byte limit, ``train()`` under the
lazy carrier, and the two tools that drive it (``scale_table``,
``flagship_quality_bench``) at tiny sizes on the CPU.

JAX params and states come from the JAX ``init_state`` and its steps and
are carried over with ``state_from_jax``; the port's steps take the
negative ids that the JAX step draws (threefry cannot be replayed in
torch). The trajectories run in float32 scoring (the bf16 ulp drift of
ROADMAP queue 3).

Tolerances: trajectories, settled tables and momentum within 1e-5
relative and 1e-6 absolute (the bounds of ``tests/test_torch_train.py``:
float32 rounding of duplicate-row sums taken in another order, and an ulp
of ``mu ** k`` between XLA's and PyTorch's ``pow``); ``last_step``
bit-equal. The port's lazy carrier against its own dense carrier, and the
adapted checkpoints against JAX's, within 1e-4 relative and 1e-6 absolute
(the bound of ``tests/test_playlist.py:549`` for the two carriers). Eval
metrics within 1e-5 relative (the bound of ``tests/test_torch_eval.py``).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.train import Checkpointer as JaxCheckpointer
from esrecsys_tpu.workloads import playlist as jpl
from esrecsys_tpu_torch.convert import state_from_jax
from esrecsys_tpu_torch.ops import optim as topt
from esrecsys_tpu_torch.tools import flagship_quality_bench as fqb
from esrecsys_tpu_torch.tools import full_scale_run as tfsr
from esrecsys_tpu_torch.tools import scale_table as tst
from esrecsys_tpu_torch.train.checkpoint import Checkpointer
from esrecsys_tpu_torch.workloads import playlist as tpl
from tests.test_torch_train import _batch, _corpus, _jax_negs

RTOL, ATOL = 1e-5, 1e-6
LAZY = dict(feature_size=4, album_hash_buckets=50, num_artists=40,
            num_negatives=6, batch_size=3, context_size=3, max_next=4,
            learning_rate=0.05, momentum=0.98, sparse_updates=True,
            momentum_carrier="lazy", compute_dtype="float32")
TABLES = ("album", "artist")


def _cfgs(**kw):
    fields = {**LAZY, **kw}
    return jpl.PlaylistConfig(**fields), tpl.PlaylistConfig(**fields)


def _close(t, j, rtol=RTOL, atol=ATOL, msg=""):
    if isinstance(t, torch.Tensor):
        t = t.detach().numpy()
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=msg)


def _table(params, t):
    """A table of a port model or of a JAX params tree."""
    if isinstance(params, torch.nn.Module):
        return getattr(params, f"{t}_embed").embedding.detach()
    return params[f"{t}_embed"]["embedding"]


def _run_both(jcfg, tcfg, steps, shared_seed=11, start=0, jstate=None,
              tstate=None):
    """``steps`` lazy steps in both packages from one JAX init (or the
    given states), on the same batches and the JAX-drawn negatives."""
    jmodel, j0 = jpl.init_state(jcfg, mesh=None)
    if jstate is None:
        jstate = j0
        tstate = state_from_jax(jstate, tcfg, device="cpu")
    jcorpus, tcorpus = _corpus(np.random.default_rng(shared_seed))
    base_key = jax.random.PRNGKey(7)
    jstep = jax.jit(jpl.make_sparse_train_step(jmodel, jcfg, jcorpus,
                                               base_key))
    tstep = tpl.make_sparse_train_step(tstate.params, tcfg, tcorpus)
    for i in range(start, start + steps):
        jb, tb = _batch(np.random.default_rng(100 + i), 3, 3, 4)
        negs = torch.from_numpy(_jax_negs(jcfg, base_key, i, 32, 3).copy())
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb, neg_ids=negs)
        _close(tm["loss"], jm["loss"], msg=f"loss, step {i}")
    return jstate, tstate


def _assert_states_match(jstate, tstate, rtol=RTOL):
    assert tstate.step == int(jstate.step)
    for t in TABLES:
        _close(_table(tstate.params, t), _table(jstate.params, t), rtol=rtol,
               msg=f"{t} table")
        _close(tstate.opt_state[t]["momentum"],
               jstate.opt_state[t]["momentum"], rtol=rtol,
               msg=f"{t} momentum")
        np.testing.assert_array_equal(
            tstate.opt_state[t]["last_step"].numpy(),
            np.asarray(jstate.opt_state[t]["last_step"]))


@pytest.mark.parametrize("shared", [False, True])
def test_lazy_sparse_step_trajectory_matches_jax(shared):
    jcfg, tcfg = _cfgs(shared_negatives=shared)
    jstate, tstate = _run_both(jcfg, tcfg, 6)
    _assert_states_match(jstate, tstate)
    # rows idle for several steps exist, so the catch-up is exercised
    last = tstate.opt_state["album"]["last_step"]
    assert int(last.max()) == 6 and bool(((last > 0) & (last < 5)).any())


def test_settled_params_match_jax_and_leave_the_state():
    jcfg, tcfg = _cfgs(shared_negatives=True)
    jstate, tstate = _run_both(jcfg, tcfg, 5)
    before = {t: _table(tstate.params, t).clone() for t in TABLES}
    settled = tpl.settled_params(tstate, tcfg)
    jsettled = jpl.settled_params(jstate, jcfg)
    assert settled is not tstate.params
    for t in TABLES:
        _close(_table(settled, t), _table(jsettled, t), msg=t)
        assert torch.equal(_table(tstate.params, t), before[t])
        assert not torch.equal(_table(settled, t), before[t])
    # the dense carrier's params are the state's own
    _, dense_cfg = _cfgs(momentum_carrier="dense")
    _, dense = tpl.init_state(dense_cfg, "cpu")
    assert tpl.settled_params(dense, dense_cfg) is dense.params


def test_settle_momentum_state_at_an_lr_boundary_matches_jax():
    """Three steps at lr 0.05, a settle at the old lr, three at 0.02: the
    two packages agree, and the port's lazy run equals its dense carrier
    run on the same stepwise schedule."""
    jcfg, tcfg = _cfgs(shared_negatives=True)
    jstate, tstate = _run_both(jcfg, tcfg, 3)
    jstate = jpl.settle_momentum_state(jstate, jcfg)
    assert tpl.settle_momentum_state(tstate, tcfg) is tstate
    _assert_states_match(jstate, tstate)
    for t in TABLES:
        assert (tstate.opt_state[t]["last_step"] == 3).all()
    jcfg2, tcfg2 = (dataclasses.replace(c, learning_rate=0.02)
                    for c in (jcfg, tcfg))
    jstate, tstate = _run_both(jcfg2, tcfg2, 3, start=3, jstate=jstate,
                               tstate=tstate)
    _assert_states_match(jstate, tstate)

    # the dense carrier over the same schedule, from the same init
    _, dcfg = _cfgs(shared_negatives=True, momentum_carrier="dense")
    jmodel, j0 = jpl.init_state(jcfg, mesh=None)
    dstate = state_from_jax(j0, dcfg, device="cpu")
    _, tcorpus = _corpus(np.random.default_rng(11))
    base_key = jax.random.PRNGKey(7)
    for lo, cfg in ((0, dcfg), (3, dataclasses.replace(dcfg,
                                                        learning_rate=0.02))):
        step = tpl.make_sparse_train_step(dstate.params, cfg, tcorpus)
        for i in range(lo, lo + 3):
            _, tb = _batch(np.random.default_rng(100 + i), 3, 3, 4)
            negs = torch.from_numpy(_jax_negs(jcfg, base_key, i, 32, 3).copy())
            dstate, _ = step(dstate, tb, neg_ids=negs)
    settled = tpl.settled_params(tstate, tcfg2)
    for t in TABLES:
        _close(_table(settled, t), _table(dstate.params, t), rtol=1e-4,
               msg=t)


def _eval_case(**kw):
    """A JAX lazy state trained 4 steps and its port copy, with an eval
    corpus of 600 items and a batch of 8 playlists."""
    rng = np.random.default_rng(7)
    n, b = 600, 8
    jcfg, tcfg = _cfgs(shared_negatives=True, eval_k=20, corpus_block=128,
                       max_next=8, batch_size=b, **kw)
    jmodel, jstate = jpl.init_state(jcfg, mesh=None)
    corpus = {"tracks": np.arange(n, dtype=np.int32),
              "albums": rng.integers(0, 150, n).astype(np.int32),
              "artists": rng.integers(0, 40, n).astype(np.int32)}
    jcorpus = {k: jnp.asarray(v) for k, v in corpus.items()}
    step = jax.jit(jpl.make_sparse_train_step(jmodel, jcfg, jcorpus,
                                              jax.random.PRNGKey(3)))
    ri = lambda hi, *s: rng.integers(0, hi, s).astype(np.int32)
    mask = np.ones((b, 8), np.float32)

    def batch():
        return {"track_context": ri(n, b, 3), "album_context": ri(150, b, 3),
                "artist_context": ri(40, b, 3), "next_track": ri(n, b, 8),
                "next_album": ri(150, b, 8), "next_artist": ri(40, b, 8),
                "next_mask": mask}

    for _ in range(4):
        jstate, _ = step(jstate, {k: jnp.asarray(v)
                                  for k, v in batch().items()})
    eb = batch()
    return (jmodel, jstate, jcfg, jcorpus, {k: jnp.asarray(v)
                                            for k, v in eb.items()},
            state_from_jax(jstate, tcfg, device="cpu"), tcfg,
            {k: torch.from_numpy(v) for k, v in corpus.items()},
            {k: torch.from_numpy(v) for k, v in eb.items()})


@pytest.mark.parametrize("kw", [{}, {"eval_fused_bins": 128}])
def test_eval_on_a_lazy_state_matches_jax(kw):
    """The exact and fused evals on a lazy state (context rows caught up,
    the corpus flushed once a round) against the JAX eval, and against the
    port's eval of the settled tables."""
    (jmodel, jstate, jcfg, jcorpus, jbatch,
     tstate, tcfg, tcorpus, tbatch) = _eval_case(**kw)
    jm = jax.jit(jpl.make_eval_step(jmodel, jcfg, jcorpus))(jstate, jbatch)
    tm = tpl.make_eval_step(tstate.params, tcfg, tcorpus)(tstate, tbatch)
    assert float(tm["track_recall"]) > 0  # hits exist; not vacuous
    for metric in ("track_recall", "track_mrr", "track_ndcg",
                   "artist_recall", "artist_mrr"):
        np.testing.assert_allclose(float(tm[metric]), float(jm[metric]),
                                   rtol=1e-5, err_msg=metric)
    # the same top-k as the settled model's under the dense carrier
    dense_cfg = dataclasses.replace(tcfg, momentum_carrier="dense")
    dense = tpl.TrainState(step=tstate.step,
                           params=tpl.settled_params(tstate, tcfg),
                           opt_state=None)
    lazy_topk = tpl.make_eval_topk(tstate.params, tcfg, tcorpus)
    dense_topk = tpl.make_eval_topk(dense.params, dense_cfg, tcorpus)
    lv, li = lazy_topk(tstate, tbatch)
    dv, di = dense_topk(dense, tbatch)
    _close(lv, dv.numpy())
    assert torch.equal(li, di)


def _lazy_and_dense_states():
    """A JAX lazy state and a JAX dense-carrier state, each trained 3
    steps."""
    out = {}
    for carrier in ("lazy", "dense"):
        jcfg, _ = _cfgs(shared_negatives=True, momentum_carrier=carrier)
        jmodel, s = jpl.init_state(jcfg, mesh=None)
        jcorpus, _ = _corpus(np.random.default_rng(11))
        step = jax.jit(jpl.make_sparse_train_step(jmodel, jcfg, jcorpus,
                                                  jax.random.PRNGKey(2)))
        for i in range(3):
            s, _ = step(s, _batch(np.random.default_rng(i), 3, 3, 4)[0])
        out[carrier] = s
    return out


@pytest.mark.parametrize("saved,target", [("lazy", "dense"),
                                          ("dense", "lazy")])
def test_restore_adapt_carrier_matches_jax(tmp_path, saved, target):
    states = _lazy_and_dense_states()
    js = states[saved]
    jcfg_s, tcfg_s = _cfgs(shared_negatives=True, momentum_carrier=saved)
    jcfg_t, tcfg_t = _cfgs(shared_negatives=True, momentum_carrier=target)
    jck = JaxCheckpointer(str(tmp_path / "jax"))
    jck.save(int(js.step), js)
    _, jtmpl = jpl.init_state(jcfg_t, mesh=None)
    want = jpl.restore_adapt_carrier(jck, jtmpl, jcfg_t, mesh=None)
    jck.close()

    ck = Checkpointer(str(tmp_path / "torch"))
    ck.save(int(js.step), state_from_jax(js, tcfg_s, device="cpu"))
    _, ttmpl = tpl.init_state(tcfg_t, "cpu")
    got = tpl.restore_adapt_carrier(ck, ttmpl, tcfg_t)
    assert got is ttmpl and got.step == int(want.step) == 3
    for t in TABLES:
        assert set(got.opt_state[t]) == set(want.opt_state[t])
        _close(_table(got.params, t), _table(want.params, t), rtol=1e-4,
               msg=f"{t} table")
        _close(got.opt_state[t]["momentum"], want.opt_state[t]["momentum"],
               rtol=1e-4, msg=f"{t} momentum")
        if target == "lazy":
            np.testing.assert_array_equal(
                got.opt_state[t]["last_step"].numpy(),
                np.asarray(want.opt_state[t]["last_step"]))
            assert (got.opt_state[t]["last_step"] == 3).all()
    # the adapted state trains on under the configured carrier
    _, tcorpus = _corpus(np.random.default_rng(11))
    _, tb = _batch(np.random.default_rng(9), 3, 3, 4)
    step = tpl.make_sparse_train_step(got.params, tcfg_t, tcorpus)
    _, m = step(got, tb)
    assert np.isfinite(float(m["loss"])) and got.step == 4


def test_state_from_jax_carries_last_step():
    js = _lazy_and_dense_states()["lazy"]
    _, tcfg = _cfgs(shared_negatives=True)
    ts = state_from_jax(js, tcfg, device="cpu")
    assert ts.step == 3
    for t in TABLES:
        for key in ("momentum", "last_step"):
            want = np.asarray(js.opt_state[t][key])
            got = ts.opt_state[t][key].numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert int(ts.opt_state[t]["last_step"].max()) == 3


def test_jax_lazy_state_restored_by_the_port_checkpointer(tmp_path):
    """A JAX lazy state's arrays, saved by the port and restored into a
    fresh lazy template, equal the JAX arrays bit for bit."""
    js = _lazy_and_dense_states()["lazy"]
    _, tcfg = _cfgs(shared_negatives=True)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state_from_jax(js, tcfg, device="cpu"))
    _, fresh = tpl.init_state(dataclasses.replace(tcfg, seed=5), "cpu")
    got = ck.restore(fresh)
    assert got.step == 3
    for t in TABLES:
        np.testing.assert_array_equal(_table(got.params, t).numpy(),
                                      np.asarray(_table(js.params, t)))
        for key in ("momentum", "last_step"):
            np.testing.assert_array_equal(
                got.opt_state[t][key].numpy(),
                np.asarray(js.opt_state[t][key]))


def test_auto_resolves_to_lazy_past_the_byte_limit(monkeypatch):
    """``auto`` picks what JAX picks; past the limit (lowered here so the
    tables stay tiny) the state and step are the lazy carrier's."""
    for kw in ({"num_artists": 8_000_000}, {"album_hash_buckets": 7_812_500},
               {"album_hash_buckets": 7_812_501}, {}):
        jc, tc = _cfgs(momentum_carrier="auto", **kw)
        assert tpl.use_dense_momentum(tc) == jpl.use_dense_momentum(jc)
        assert tpl.use_lazy_momentum(tc) == (not jpl.use_dense_momentum(jc))
    monkeypatch.setattr(tpl, "DENSE_MOMENTUM_MAX_BYTES", 100)
    _, tcfg = _cfgs(momentum_carrier="auto", shared_negatives=True)
    assert tpl.use_lazy_momentum(tcfg)
    model, state = tpl.init_state(tcfg, "cpu")
    assert set(state.opt_state["album"]) == {"momentum", "last_step"}
    _, corpus = _corpus(np.random.default_rng(1))
    step = tpl.make_sparse_train_step(model, tcfg, corpus)
    for i in range(2):
        state, m = step(state, _batch(np.random.default_rng(i), 3, 3, 4)[1])
    assert int(state.opt_state["album"]["last_step"].max()) == 2
    assert np.isfinite(float(m["loss"]))


def test_train_under_the_lazy_carrier_checkpoints_resumes_and_exports(
        tmp_path):
    """``full_scale_run --momentum_carrier lazy --feed host``: train() from
    packed shards with a checkpoint, then a resume from it, under the lazy
    carrier; the export is the settled model."""
    from esrecsys_tpu_torch.train.export import latest_artifact, load_model

    run = tfsr.TrainRunConfig(
        out_dir=str(tmp_path), num_tracks=3000, num_albums_raw=900,
        album_buckets=300, num_artists=500, device="cpu", steps=4,
        batch_size=16, max_next=8, eval_every=4, eval_playlists=16,
        log_every=2, feed="host", n_shards=1, shard_examples=128,
        ckpt_every=2, momentum_carrier="lazy")
    tr = tfsr.run_train(run)
    res, cfg = tr["result"], tr["cfg"]
    assert tpl.use_lazy_momentum(cfg) and res.state.step == 4
    assert set(res.state.opt_state["album"]) == {"momentum", "last_step"}
    params, _, meta = load_model(latest_artifact(str(tmp_path), "playlist"))
    settled = tpl.settled_params(res.state, cfg)
    for t in TABLES:
        np.testing.assert_array_equal(params[f"{t}_embed"]["embedding"],
                                      _table(settled, t).numpy())
    assert meta["step"] == 4
    resumed = tpl.train(dataclasses.replace(cfg, max_steps=6, resume=True),
                        corpus_np=tfsr.train_corpus(run), device="cpu")
    assert resumed.steps_run == 2 and resumed.state.step == 6
    last = resumed.state.opt_state["album"]["last_step"]
    assert int(last.max()) == 6


def test_full_scale_run_takes_the_momentum_carrier(tmp_path, capsys):
    tfsr.main(["--out_dir", str(tmp_path), "--device", "cpu", "--train",
               "--steps", "3", "--batch_size", "16", "--max_next", "8",
               "--eval_every", "3", "--eval_playlists", "16",
               "--momentum_carrier", "lazy", "--corpus_size", "3000",
               "--num_albums_raw", "900", "--album_buckets", "300",
               "--num_artists", "500"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 3
    assert np.isfinite(out["last_eval"]["eval_track_recall"])
    run = tfsr.TrainRunConfig(out_dir="unused", momentum_carrier="lazy")
    assert tfsr.flagship_cfg(run).momentum_carrier == "lazy"
    # 10M album buckets at D=32 are 1.28 GB: auto resolves to lazy there
    big = tfsr.TrainRunConfig(out_dir="unused", album_buckets=10_000_000)
    assert tpl.use_lazy_momentum(tfsr.flagship_cfg(big))
    assert not tpl.use_lazy_momentum(tfsr.flagship_cfg(
        tfsr.TrainRunConfig(out_dir="unused")))


def test_scale_table_lazy_steps_follow_dense_momentum():
    """The tool's lazy steps, flushed, equal dense SGD momentum on the
    same ids and gradients (replayed here in plain PyTorch)."""
    cfg = tst.ScaleConfig(rows=64, dim=4, ids_per_step=24, momentum=0.9,
                          learning_rate=0.1, device="cpu")
    table, state = tst.init(cfg, torch.device("cpu"))
    dense, m = table.clone(), torch.zeros_like(table)
    step = tst.make_step(cfg, table, state)
    gen = torch.Generator()
    for s in range(5):
        step(s)
        ids = tst.step_ids(cfg, s, gen).long()
        g = 1.0 - torch.tanh(dense[ids]).square()
        m.mul_(cfg.momentum).index_add_(0, ids, g)
        dense -= cfg.learning_rate * m
    settled = topt.momentum_flush(table, state, lr=cfg.learning_rate,
                                  mu=cfg.momentum, step=5)
    _close(settled, dense.numpy(), rtol=1e-5)


@pytest.mark.parametrize("momentum", ["0.0", "0.98"])
def test_scale_table_runs_on_the_cpu(capsys, momentum):
    out = tst.main(["--rows", "500", "--dim", "8", "--ids_per_step", "32",
                    "--steps_per_call", "2", "--calls", "2", "--momentum",
                    momentum, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == out
    assert out["steps"] == 4 and out["rows"] == 500
    assert out["layout"] == "logical" and out["platform"] == "cpu"
    assert out["value"] > 0 and np.isfinite(out["last_loss"])
    assert out["card"] is None and out["peak_memory_gb"] is None


@pytest.mark.parametrize("flag,match", [("--n_model", "queue 1 item 8"),
                                        ("--dtype", "bf16")])
def test_scale_table_refuses_what_is_not_ported(flag, match):
    value = "2" if flag == "--n_model" else "bfloat16"
    with pytest.raises(NotImplementedError, match=match):
        tst.main(["--rows", "64", "--dim", "4", flag, value,
                  "--device", "cpu"])


def test_flagship_quality_bench_runs_on_the_cpu(tmp_path, capsys):
    out_path = tmp_path / "bench.json"
    out = fqb.main(["--spc", "2", "--n_calls", "1", "--device", "cpu",
                    "--album_buckets", "300", "--num_artists", "200",
                    "--batch_size", "8", "--num_negatives", "16",
                    "--corpus_size", "500", "--out", str(out_path)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert json.loads(out_path.read_text()) == out
    names = ("m98_sparse_densecarrier_logical", "m98_lazy_logical", "m0",
             "m98_dense_step")
    for name in names:
        assert out[name] > 0
    assert out["platform"] == "cpu" and out["card"] is None
    configs = fqb.quality_configs(skip_dense=True)
    assert list(configs) == list(names[:3])
    flagship = configs["m98_sparse_densecarrier_logical"]
    assert not tpl.use_lazy_momentum(flagship)
    assert tpl.use_lazy_momentum(configs["m98_lazy_logical"])
    assert (flagship.feature_size, flagship.batch_size,
            flagship.num_negatives, flagship.compute_dtype) == \
        (32, 2048, 512, "bfloat16")
