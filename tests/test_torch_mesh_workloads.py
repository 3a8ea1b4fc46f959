"""The workloads on a mesh of two gloo ranks against the JAX package on a
virtual CPU mesh of the same shape: GloVe under both optimizers, its knn
and eval, txt2url (LSTM, margin) with its eval and probes, and
``scale_table`` at momentum 0 and 0.98, each on 1x2 (tables row-sharded
over two model shards); Shop the Look on 2x1 (two data rows, three
steps against JAX's step on the global batch on a virtual 2x1 mesh,
BatchNorm statistics and Adam's moments included); the playlist's dense
autograd step on 1x2 and 2x1. Also ``glove.train()`` on 1x2: per-rank
checkpoints put together, rank 0's export, the transfer into a sharded
txt2url word table.

All of it runs in one spawn of two ranks (``tests/torch_dist_workers.py``
``job_mesh_workloads``, joined with a deadline); the JAX package's side
runs here. Inputs from numpy seeds; states from the JAX ``init_state``
through ``convert``'s sharded functions.

Tolerances, as the single-card tests of each workload hold the same
steps (``test_torch_glove.py``, ``test_torch_txt2url.py``,
``test_torch_stl.py``, ``test_torch_train.py``): losses within 1e-5
relative; GloVe's tables and moments within 1e-5 relative and 1e-6
absolute; txt2url's parameters within 1e-5 relative and 2e-6 absolute,
its ``nu`` within 1e-4 relative and 1e-9 absolute; ``scale_table``'s
table and momentum within 1e-5 relative and 1e-6 absolute; the playlist
tables and momentum within 1e-5 relative and 1e-6 absolute; the knn and
probe ids equal (no ties here) and scores within 1e-5 relative. STL,
as ``test_torch_stl.py`` holds its three steps: parameters within 1e-5
relative and 1e-9 absolute, but the biases of ``Conv_1`` ... ``Conv_3``
(float32 noise that Adam steps by up to ``lr`` a step), held to
``|b| <= 3 lr``; running variances within 1e-5 relative; running means
within ``0.01 * 6 * 2 * 3 lr`` absolute; ``mu`` and ``nu`` within 1e-5
of each parameter's largest moment (the dead biases' ``mu`` under 1e-3
of the largest ``mu``, and their ``nu`` not compared); the eval (from
the state before the steps) within 1e-6. The two ranks' STL states and
moments are equal bit for bit (their statistics are the same
all-reduced sums).
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.core import mesh as jmesh
from esrecsys_tpu.core import prng
from esrecsys_tpu.ops import negatives as jneg
from esrecsys_tpu.ops import optim as joptim
from esrecsys_tpu.parallel import table as jtable
from esrecsys_tpu.workloads import glove as jglove
from esrecsys_tpu.workloads import playlist as jpl
from esrecsys_tpu.workloads import stl as jstl
from esrecsys_tpu.workloads import txt2url as jt2u
from esrecsys_tpu_torch import convert
from esrecsys_tpu_torch.data import recordio, vocab
from esrecsys_tpu_torch.data import protos
from esrecsys_tpu_torch.tools import scale_table as tst
from esrecsys_tpu_torch.workloads import glove as tglove
from esrecsys_tpu_torch.workloads import playlist as tpl
from esrecsys_tpu_torch.workloads import stl
from esrecsys_tpu_torch.workloads import txt2url as t2u
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_dist_workers import spawn

RTOL, ATOL = 1e-5, 1e-6
STEPS = 3
GLOVE_ROWS = 200          # padded to 256: 128 rows a shard
WORDS, URLS, B, L = 300, 40, 8, 6
STL_LR = 1e-4


def _mesh(n_data, n_model):
    return jmesh.make_mesh(n_data=n_data, n_model=n_model,
                           devices=jax.devices()[:n_data * n_model])


def _put_batch(mesh, batch):
    """A global numpy batch as the JAX step takes it: rows over ``data``."""
    def put(v):
        v = jnp.asarray(v)
        spec = P(jmesh.DATA_AXIS, *([None] * (v.ndim - 1)))
        return jax.device_put(v, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, batch)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ GloVe

def _glove_side():
    mesh = _mesh(1, 2)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(STEPS):
        t1 = rng.integers(1, GLOVE_ROWS, 16).astype(np.int32)
        t2 = rng.integers(1, GLOVE_ROWS, 16).astype(np.int32)
        t1[:3] = t1[3]   # duplicate ids in a batch
        count = rng.integers(1, 200, 16).astype(np.float32)
        batches.append(((t1, t2), count))
    probes = np.array([1, 7, 50], np.int32)
    side, jstates, cfgs = {}, {}, {}
    for opt in ("adam", "lazy_adam"):
        jcfg = jglove.GloveConfig(feature_size=8, learning_rate=0.05,
                                  optimizer=opt, steps_per_call=1,
                                  n_model_shards=2)
        jmodel, jstate = jglove.init_state(jcfg, GLOVE_ROWS, mesh)
        if opt == "adam":
            count, mu, nu = convert._optax_adam(jstate.opt_state)
            opt_np = (types.SimpleNamespace(
                count=np.asarray(count), mu=_np_tree(mu), nu=_np_tree(nu)),)
        else:
            opt_np = _np_tree(jstate.opt_state)
        jstates[opt] = types.SimpleNamespace(
            params=_np_tree(jstate.params), opt_state=opt_np, step=0)
        cfgs[opt] = tglove.GloveConfig(feature_size=8, learning_rate=0.05,
                                       optimizer=opt, n_model_shards=2)
        jstep = jax.jit(jglove.select_train_step(jmodel, jcfg))
        losses = []
        for (t1, t2), count in batches:
            jstate, jm = jstep(jstate, _put_batch(mesh, ((t1, t2), count)))
            losses.append(float(jm["loss"]))
        knn = jglove.knn(jstate, jnp.asarray(probes), k=5,
                         valid_rows=GLOVE_ROWS)
        (t1, t2), count = batches[0]
        ev = jglove.make_eval_step(jmodel)(jstate, ((jnp.asarray(t1),
                                                     jnp.asarray(t2)),
                                                    jnp.asarray(count)))
        if opt == "adam":
            _, mu, nu = convert._optax_adam(jstate.opt_state)
            opt_want = {f"{t}/{m}": np.asarray(tree[t]["embedding"])
                        for t in ("token_embedding", "bias")
                        for m, tree in (("mu", mu), ("nu", nu))}
        else:
            opt_want = {f"{t}/{m}": np.asarray(jstate.opt_state[t][m])
                        for t in ("embedding", "bias") for m in ("m", "v")}
        side[opt] = {"losses": losses, "params": _np_tree(jstate.params),
                     "opt": opt_want, "knn": knn,
                     "eval_loss": float(ev["loss"])}
    args = {"jstates": jstates, "cfgs": cfgs, "rows": GLOVE_ROWS,
            "batches": batches, "probes": probes}
    return side, args


def _glove_train_args(tmp):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(1, 21):
        others = list(range(1, i))
        if others:
            rows.append(protos.CooccurrenceRow(
                index=i, other_index=others,
                count=[float(rng.integers(1, 100)) for _ in others]))
    recordio.write_protos(str(tmp / "part-00000.bz2"), rows[:10])
    recordio.write_protos(str(tmp / "part-00001.bz2"), rows[10:])
    voc = vocab.Vocabulary([vocab.VocabEntry(token=f"t{i:02d}",
                                             frequency=100 - i)
                            for i in range(1, 21)])
    cfg = tglove.GloveConfig(
        train_pattern=str(tmp / "part-*.bz2"), feature_size=8,
        batch_size=16, learning_rate=0.05, steps_per_epoch=4, num_epochs=2,
        shuffle_buffer_size=32, terms="t02,t15", eval_steps=1,
        checkpoint_every_epochs=1, n_model_shards=2)
    return {"cfg": cfg, "vocab": voc}


# ---------------------------------------------------------------- txt2url

def _t2u_batch(rng):
    tokens = rng.integers(1, WORDS, (B, L)).astype(np.int32)
    for b, n in enumerate([0, 1, 3, L, 2, 5, L, 4]):
        tokens[b, n:] = 0
    return {"url_near_text": rng.integers(0, URLS, B).astype(np.int32),
            "tokens": tokens,
            "url1": rng.integers(0, URLS, B).astype(np.int32),
            "url2": rng.integers(0, URLS, B).astype(np.int32),
            "sqrt_dice": rng.random(B).astype(np.float32)}


def _t2u_side():
    mesh = _mesh(1, 2)
    fields = dict(word_dim=8, rnn_size=12, url_dim=16, sentence_length=L,
                  batch_size=B, encoder_type="lstm", learning_rate=0.01,
                  steps_per_epoch=2, word_max_norm=0.2, url_max_norm=0.3,
                  eval_recall_k=5, n_model_shards=2)
    jcfg = jt2u.Txt2UrlConfig(**fields)
    tcfg = t2u.Txt2UrlConfig(**fields)
    jmodel, jstate = jt2u.init_state(jcfg, WORDS, URLS, mesh=mesh)
    params0 = {k: v.numpy() for k, v in
               convert.params_from_jax(_np_tree(jstate.params)).items()}
    rng = np.random.default_rng(9)
    batches = [_t2u_batch(rng) for _ in range(STEPS)]
    jstep = jax.jit(jt2u.make_train_step(jmodel, jcfg))
    losses = []
    for b in batches:
        jstate, jm = jstep(jstate, _put_batch(mesh, b))
        losses.append(float(jm["loss"]))
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    ev = jt2u.make_eval_step(jmodel, jcfg)(jstate, jb)
    scores = jstate.apply_fn({"params": jstate.params}, jb["tokens"],
                             method=jmodel.score_text_vs_all)
    probe = jax.lax.top_k(scores, 5)
    wt = jstate.params["encoder"]["word_embedding"]["embedding"]
    words = jax.lax.top_k(wt[jnp.array([1, 2, 3])] @ wt.T, 5)
    side = {"losses": losses,
            "params": convert.params_from_jax(_np_tree(jstate.params)),
            "nu": convert.params_from_jax(_np_tree(
                jstate.opt_state[0].nu)),
            "eval": {k: float(v) for k, v in ev.items()},
            "probe": [np.asarray(t) for t in probe],
            "words": [np.asarray(t) for t in words]}
    return side, {"cfg": tcfg, "words": WORDS, "urls": URLS,
                  "params": params0, "batches": batches}


# ------------------------------------------------------------ scale_table

def _scale_cfg(momentum, n_model=2):
    return tst.ScaleConfig(rows=500, dim=8, dtype="float32",
                           ids_per_step=64, steps_per_call=4, calls=1,
                           learning_rate=0.01, momentum=momentum,
                           n_model=n_model, device="cpu")


def _scale_side():
    """The reference's ``scale_table`` step (``lookup`` over the mesh,
    ``lazy_momentum_update`` or the scatter) on a 1x2 JAX mesh, fed the
    port's ids of each step, from the port's init."""
    mesh = _mesh(1, 2)
    side, cfgs = {}, {}
    for name, mu in (("m0", 0.0), ("m98", 0.98)):
        cfg = _scale_cfg(mu)
        cfgs[name] = cfg
        table0, _ = tst.init(_scale_cfg(mu, 1), torch.device("cpu"))
        table = jax.device_put(jnp.asarray(table0.numpy()),
                               NamedSharding(mesh, P(jmesh.MODEL_AXIS,
                                                     None)))
        mstate = joptim.momentum_init(table) if mu else None
        gen = torch.Generator()
        w = jnp.ones((cfg.ids_per_step, cfg.dim), jnp.float32)
        losses = []
        for step in range(cfg.steps_per_call):
            ids = jnp.asarray(tst.step_ids(cfg, step, gen).numpy())
            rows = jtable.lookup(table, ids, mesh=mesh)
            if mu:
                rows = rows + joptim.momentum_catchup_rows(
                    mstate, ids, lr=cfg.learning_rate, mu=mu, step=step)
            loss, g = jax.value_and_grad(
                lambda r: jnp.vdot(jnp.tanh(r), w))(rows)
            if mu:
                table, mstate = joptim.lazy_momentum_update(
                    table, mstate, ids, g, lr=cfg.learning_rate, mu=mu,
                    step=step)
            else:
                table = table.at[ids].add(-cfg.learning_rate * g)
            losses.append(float(loss))
        side[name] = {"losses": losses, "table": np.asarray(table),
                      "state": None if mstate is None else
                      {k: np.asarray(v) for k, v in mstate.items()}}
    return side, cfgs


# -------------------------------------------------------------------- STL

def _stl_side():
    """JAX's STL step on a virtual 2x1 mesh (the batch's rows over
    ``data``, the state replicated), ``STEPS`` steps; the eval from the
    state before them."""
    fields = dict(image_size=32, batch_size=4, use_bf16=False,
                  learning_rate=STL_LR, output_size=8, filters=(4, 8))
    jcfg, tcfg = jstl.STLConfig(**fields), stl.STLConfig(**fields)
    _, js = jstl.init_state(jcfg)
    ts = convert.stl_state_from_jax(js, tcfg, device="cpu")
    state_dict = {k: v.numpy().copy()
                  for k, v in ts.params.state_dict().items()}
    mesh = _mesh(2, 1)
    js = jax.device_put(js, NamedSharding(mesh, P()))
    rng = np.random.default_rng(0)
    batches = [tuple((rng.normal(size=(4, 32, 32, 3)) * 0.3
                      ).astype(np.float32) for _ in range(3))
               for _ in range(STEPS)]
    ev = jstl.make_eval_step(jcfg)(js, _put_batch(mesh, batches[0]))
    step, losses = jax.jit(jstl.make_train_step(jcfg)), []
    for batch in batches:
        js, m = step(js, _put_batch(mesh, batch))
        losses.append(float(m["loss"]))
    _, mu, nu = convert._optax_adam(js.opt_state)
    opt = {key: {name: convert._stl_leaf_to_torch(name, w.numpy())
                 for name, w in convert.params_from_jax(tree).items()}
           for key, tree in (("mu", mu), ("nu", nu))}
    side = {"losses": losses,
            "state_dict": {k: v.numpy() for k, v in
                           convert.stl_state_dict_from_jax(
                               js.params, js.batch_stats).items()},
            "opt": opt, "eval": {k: float(v) for k, v in ev.items()}}
    return side, {"cfg": tcfg, "state_dict": state_dict,
                  "batches": batches}


# ------------------------------------------------------- the dense step

N_ITEMS = 64


def _dense_side():
    corpus = {"tracks": np.arange(N_ITEMS, dtype=np.int32),
              "albums": (np.arange(N_ITEMS) % 64).astype(np.int32),
              "artists": (np.arange(N_ITEMS) % 32).astype(np.int32)}
    jcorpus = {k: jnp.asarray(v) for k, v in corpus.items()}
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(STEPS):
        ri = lambda hi, *s: rng.integers(0, hi, s).astype(np.int32)  # noqa
        batches.append({
            "track_context": ri(N_ITEMS, 8, 3),
            "album_context": ri(64, 8, 3), "artist_context": ri(32, 8, 3),
            "next_track": ri(N_ITEMS, 8, 4), "next_album": ri(64, 8, 4),
            "next_artist": ri(32, 8, 4),
            "next_mask": np.ones((8, 4), np.float32)})
    base_key = jax.random.PRNGKey(3)
    side, jstates, cfgs, negs = {}, {}, {}, []
    for i in range(STEPS):
        key = prng.key_for_step(base_key, i, prng.STREAM_NEGATIVES)
        negs.append(np.asarray(jneg.sample_negative_ids(key, 8, N_ITEMS,
                                                        None)))
    for shape in ("1x2", "2x1"):
        n_data, n_model = map(int, shape.split("x"))
        mesh = _mesh(n_data, n_model)
        fields = dict(feature_size=4, album_hash_buckets=64, num_artists=32,
                      num_negatives=8, batch_size=8, context_size=3,
                      max_next=4, learning_rate=0.05, momentum=0.9,
                      shared_negatives=True, sparse_updates=False,
                      n_model_shards=n_model)
        jcfg = jpl.PlaylistConfig(**fields)
        cfgs[shape] = tpl.PlaylistConfig(**fields)
        jmodel, jstate = jpl.init_state(jcfg, mesh)
        trace = convert._optax_trace(jstate.opt_state)
        jstates[shape] = types.SimpleNamespace(
            params=_np_tree(jstate.params),
            opt_state=(types.SimpleNamespace(trace=_np_tree(trace)),),
            step=0)
        jstep = jax.jit(jpl.make_train_step(jmodel, jcfg, jcorpus,
                                            base_key))
        losses = []
        for b in batches:
            jstate, jm = jstep(jstate, _put_batch(mesh, b))
            losses.append(float(jm["loss"]))
        trace = convert._optax_trace(jstate.opt_state)
        side[shape] = {"losses": losses, "params": _np_tree(jstate.params),
                       "momentum": {k: v.numpy() for k, v in
                                    convert.params_from_jax(
                                        _np_tree(trace)).items()}}
    return side, {"jstates": jstates, "cfgs": cfgs, "corpus": corpus,
                  "batches": batches, "negs": negs}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    glove_want, glove_args = _glove_side()
    t2u_want, t2u_args = _t2u_side()
    scale_want, scale_cfgs = _scale_side()
    stl_want, stl_args = _stl_side()
    dense_want, dense_args = _dense_side()
    data = tmp_path_factory.mktemp("cooc")
    args = {"glove": glove_args, "glove_train": _glove_train_args(data),
            "txt2url": t2u_args, "scale": scale_cfgs, "stl": stl_args,
            "dense": dense_args}
    outs = spawn("job_mesh_workloads", 2,
                 str(tmp_path_factory.mktemp("ranks")), args, timeout=300)
    return {"glove": glove_want, "txt2url": t2u_want, "scale": scale_want,
            "stl": stl_want, "dense": dense_want}, outs


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam"])
def test_glove_steps_on_a_mesh_match_jax(run, optimizer):
    want, outs = run
    w = want["glove"][optimizer]
    for rank, out in enumerate(outs):
        got = out["glove"][optimizer]
        _close(got["losses"], w["losses"], atol=0, msg="losses")
        for name in ("token_embedding", "bias"):
            _close(got["tables"][name]["embedding"],
                   w["params"][name]["embedding"], msg=f"{rank} {name}")
        assert set(got["opt"]) == set(w["opt"])
        for k, v in w["opt"].items():
            _close(got["opt"][k], v, msg=f"{rank} {k}")
        _close(got["eval_loss"], w["eval_loss"], atol=0, msg="eval")
        scores, ids = got["knn"]
        np.testing.assert_array_equal(ids, np.asarray(w["knn"][1]))
        _close(scores, w["knn"][0], atol=0, msg="knn scores")


def test_glove_train_on_a_mesh(run):
    _, outs = run
    for out in outs:
        g = out["glove_train"]
        assert g["step"] == g["ckpt_step"] == 8
        assert g["ckpt_equal"] and g["transfer_equal"]
        assert np.isfinite(g["eval"]["eval_loss"])
    rank0 = outs[0]["glove_train"]
    assert rank0["export_equal"]
    assert rank0["meta"]["padded_rows"] == 65_664


def test_txt2url_steps_on_a_mesh_match_jax(run):
    want, outs = run
    w = want["txt2url"]
    for out in outs:
        got = out["txt2url"]
        _close(got["losses"], w["losses"], atol=0, msg="losses")
        for name, v in w["params"].items():
            _close(got["params"][name], v, RTOL, 2e-6, name)
        for name, v in w["nu"].items():
            _close(got["nu"][name], v, 1e-4, 1e-9, f"nu {name}")
        assert set(got["eval"]) == set(w["eval"])
        for k, v in w["eval"].items():
            _close(got["eval"][k], v, 1e-5, 1e-6, k)
        for kind in ("probe", "words"):
            np.testing.assert_array_equal(got[kind][1], w[kind][1])
            _close(got[kind][0], w[kind][0], atol=1e-6, msg=kind)


@pytest.mark.parametrize("name", ["m0", "m98"])
def test_scale_table_on_a_mesh_matches_jax(run, name):
    want, outs = run
    w = want["scale"][name]
    for out in outs:
        got = out["scale"][name]
        _close(got["losses"], w["losses"], atol=0, msg="losses")
        _close(got["table"], w["table"], msg="table")
        if w["state"] is not None:
            _close(got["state"]["momentum"], w["state"]["momentum"],
                   msg="momentum")
            np.testing.assert_array_equal(got["state"]["last_step"],
                                          w["state"]["last_step"])
    # and the port's unsharded run from the same seed
    cfg = _scale_cfg({"m0": 0.0, "m98": 0.98}[name], 1)
    table, state = tst.init(cfg, torch.device("cpu"))
    one = tst.make_step(cfg, table, state)
    for s in range(cfg.steps_per_call):
        one(s)
    _close(outs[0]["scale"][name]["table"], table.numpy(), msg="unsharded")


def _dead_bias(name: str) -> bool:
    return re.search(r"Conv_[123]\.bias$", name) is not None


def test_stl_step_on_two_data_ranks_equals_the_global_step(run):
    want, outs = run
    w = want["stl"]
    a, b = outs[0]["stl"], outs[1]["stl"]
    for key in ("state_dict", "mu", "nu"):   # every rank holds one state
        for name in a[key]:
            np.testing.assert_array_equal(a[key][name], b[key][name],
                                          err_msg=f"{key} {name}")
    _close(a["losses"], w["losses"], atol=0, msg="losses")
    dead_bound = STEPS * STL_LR * (1 + 1e-3)
    mean_bound = 0.01 * 2 * STEPS * 2 * dead_bound
    for name, v in w["state_dict"].items():
        g = a["state_dict"][name]
        if _dead_bias(name):
            assert np.abs(g).max() <= dead_bound, name
        elif name.endswith(".mean"):
            _close(g, v, 0, mean_bound, name)
        else:
            _close(g, v, RTOL, 1e-9, name)
    # the moments see the gradient's scale, which Adam's steps do not:
    # a gradient summed over the data group without its local/global
    # weight doubles mu and quadruples nu
    biggest = max(np.abs(v).max() for v in w["opt"]["mu"].values())
    for key in ("mu", "nu"):
        for name, v in w["opt"][key].items():
            g = a[key][name]
            if _dead_bias(name):
                if key == "mu":  # float32 noise against the real moments
                    assert np.abs(g).max() < 1e-3 * biggest, name
                continue
            _close(g, v, 0, 1e-5 * np.abs(v).max(), f"{key} {name}")
    for k, v in w["eval"].items():
        _close(a["eval"][k], v, 1e-6, 1e-6, k)


@pytest.mark.parametrize("shape", ["1x2", "2x1"])
def test_dense_playlist_step_on_a_mesh_matches_jax(run, shape):
    want, outs = run
    w = want["dense"][shape]
    for out in outs:
        got = out["dense"][shape]
        _close(got["losses"], w["losses"], atol=0, msg="losses")
        for name in ("album_embed", "artist_embed"):
            _close(got["params"][name]["embedding"],
                   w["params"][name]["embedding"], msg=name)
            _close(got["momentum"][f"{name}.embedding"],
                   w["momentum"][f"{name}.embedding"], msg=f"mom {name}")


def test_dense_mesh_keeps_the_fused_eval_refused():
    """The reference refuses the fused eval on a sharded mesh; the port
    does too, for the dense step's state as well."""
    fields = dict(feature_size=4, album_hash_buckets=64, num_artists=32,
                  sparse_updates=False, eval_fused_bins=128,
                  n_model_shards=2)
    mesh = types.SimpleNamespace(n_model=2, n_data=1, model_index=0)
    corpus = {"tracks": torch.arange(8), "albums": torch.arange(8),
              "artists": torch.arange(8)}
    with pytest.raises(ValueError, match="eval_fused_bins requires"):
        tpl.select_eval_step(None, tpl.PlaylistConfig(**fields), corpus,
                             mesh)
    with pytest.raises(ValueError, match="eval_fused_bins requires"):
        jpl.select_eval_step(None, jpl.PlaylistConfig(**fields),
                             {k: jnp.asarray(v.numpy())
                              for k, v in corpus.items()}, _mesh(1, 2))
