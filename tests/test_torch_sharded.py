"""The playlist workload on a mesh of gloo ranks: the sharded train step
under each momentum carrier (and at momentum 0), the catalog-sharded
eval, and ``train()`` with ``n_model_shards=2``, against the JAX
package's sharded step and eval on a virtual CPU mesh of the same shape
and against the port's own unsharded step.

Shapes: 1,000 album buckets, 700 artists, D=8, a global batch of 32
(C=3, M=4), 16 negatives (one shared pool, or per playlist for the lazy
carrier), 3,000 corpus tracks with distinct (album, artist) pairs (so no
two tracks tie), top-500. Grids: 1x2 (2 ranks) and 2x2 (4 ranks). Every
step takes the negative ids that the JAX step draws from its key, for the
global batch. The ranks run in worker processes
(``tests/torch_dist_workers.py``), joined with a deadline.

Tolerances: tables and momentum after 5 steps within 1e-5 relative and
1e-6 absolute, of the JAX package's and of the port's unsharded step
(the bounds of ``tests/test_torch_train.py``: float32 sums of duplicate
rows, and on 2x2 of the two data rows' halves, in another order). The
eval's top-500 ids are the JAX package's, in its order except where two
items' scores lie within float32 rounding of each other (measured: two
such swaps among 16,000 ranks; the two packages' dot products round
differently), its scores within 1e-5 relative and 1e-6 absolute, its
metrics within 1e-5 relative.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.core import mesh as jmesh
from esrecsys_tpu.core import prng
from esrecsys_tpu.models.playlist import affinity_scores as j_affinity
from esrecsys_tpu.ops import negatives as jneg
from esrecsys_tpu.retrieval import mips as jmips
from esrecsys_tpu.workloads import playlist as jpl
from esrecsys_tpu_torch.convert import state_from_jax
from esrecsys_tpu_torch.workloads import playlist as tpl
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_dist_workers import spawn

RTOL, ATOL = 1e-5, 1e-6
STEPS = 5
BASE = dict(feature_size=8, album_hash_buckets=1000, num_artists=700,
            num_negatives=16, batch_size=32, context_size=3, max_next=4,
            learning_rate=0.05, sparse_updates=True, eval_k=500,
            eval_group=8)
CARRIERS = {
    "dense": dict(momentum=0.98, momentum_carrier="dense",
                  shared_negatives=True),
    "lazy": dict(momentum=0.98, momentum_carrier="lazy",
                 shared_negatives=False),
    "sgd": dict(momentum=0.0, shared_negatives=True),
}
EVAL_CARRIER = "lazy"   # the eval runs on the lazy state: settled rows
N_ITEMS = 3000


def _corpus(rng):
    pairs = rng.choice(1000 * 700, N_ITEMS, replace=False)
    return {"tracks": rng.permutation(N_ITEMS).astype(np.int32),
            "albums": (pairs // 700).astype(np.int32),
            "artists": (pairs % 700).astype(np.int32)}


def _batch(rng, b, c=3, m=4):
    ri = lambda hi, *s: rng.integers(0, hi, s).astype(np.int32)  # noqa
    mask = rng.integers(0, 2, (b, m)).astype(np.float32)
    mask[:, 0] = 1.0
    return {"track_context": ri(N_ITEMS, b, c),
            "album_context": ri(1000, b, c), "artist_context": ri(700, b, c),
            "next_track": ri(N_ITEMS, b, m), "next_album": ri(1000, b, m),
            "next_artist": ri(700, b, m), "next_mask": mask}


def _numpy_state(jstate):
    """A JAX state as plain numpy trees (picklable for the ranks)."""
    opt = jstate.opt_state if isinstance(jstate.opt_state, dict) else None
    return types.SimpleNamespace(
        params=jax.tree_util.tree_map(np.asarray, jstate.params),
        opt_state=jax.tree_util.tree_map(np.asarray, opt),
        step=int(jstate.step))


def _jax_sharded_eval(jmodel, cfg, jstate, jcorpus, mesh, batch):
    """(top vals, top ids, metrics) of the reference's sharded eval."""
    num_items = N_ITEMS
    n_shards = mesh.shape[jmesh.MODEL_AXIS]
    block = min(cfg.corpus_block, jmesh.pad_to_multiple(num_items, 256))
    padded = jmesh.pad_to_multiple(num_items, n_shards * block)
    albums_p = jnp.pad(jcorpus["albums"], (0, padded - num_items))
    artists_p = jnp.pad(jcorpus["artists"], (0, padded - num_items))
    setup = jpl.make_sharded_corpus_embed_setup(jmodel, cfg, jcorpus, mesh)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def score_fn(q, ac, rc, items, ia, ir):
        return j_affinity(q, items, ia, ir, ac, rc)

    @jax.jit
    def topk(state, jb):
        # make_sharded_eval_step's body, returning its top-k as well
        ctx = jpl._settled_ctx_embed(state, cfg, jb["album_context"],
                                     jb["artist_context"])
        vals, ids = jmips.sharded_scored_topk(
            (ctx, jb["album_context"], jb["artist_context"]),
            (setup(state), albums_p, artists_p), score_fn, cfg.eval_k, mesh,
            block, valid_items=num_items, group=cfg.eval_group)
        return vals, ids, jpl._hit_metrics(
            jb, vals, ids, jcorpus["tracks"], jcorpus["artists"], cfg.eval_k)

    vals, ids, metrics = topk(jstate, jb)
    return np.asarray(vals), np.asarray(ids), {
        k: float(v) for k, v in metrics.items()}


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


@pytest.fixture(scope="module", params=[(2, 2), (4, 2)],
                ids=["1x2", "2x2"])
def grid_run(request, tmp_path_factory):
    """JAX's sharded steps and eval, the port's unsharded steps (here),
    and the port's sharded steps and eval (on the ranks)."""
    world, n_model = request.param
    n_data = world // n_model
    mesh = jmesh.make_mesh(n_data=n_data, n_model=n_model,
                           devices=jax.devices()[:world])
    rng = np.random.default_rng(world)
    corpus = _corpus(rng)
    jcorpus = {k: jnp.asarray(v) for k, v in corpus.items()}
    tcorpus = {k: torch.from_numpy(v) for k, v in corpus.items()}
    batches = [_batch(np.random.default_rng(100 + i), 32)
               for i in range(STEPS)]
    eval_batch = _batch(np.random.default_rng(7), 32)
    base_key = jax.random.PRNGKey(5)
    data_sharding = NamedSharding(mesh, P(jmesh.DATA_AXIS))
    cfgs, negs_by, jstates0 = {}, {}, {}
    want = {"jax": {}, "unsharded": {}}
    for name, kw in CARRIERS.items():
        fields = {**BASE, **kw, "n_model_shards": n_model}
        jcfg = jpl.PlaylistConfig(**fields)
        tcfg = tpl.PlaylistConfig(**fields)
        cfgs[name] = tcfg
        jmodel, jstate = jpl.init_state(jcfg, mesh)
        jstates0[name] = _numpy_state(jstate)
        tstate = state_from_jax(jstate, dataclasses.replace(
            tcfg, n_model_shards=1), device="cpu")
        jstep = jax.jit(jpl.make_sparse_train_step(jmodel, jcfg, jcorpus,
                                                   base_key))
        tstep = tpl.make_sparse_train_step(tstate.params, tcfg, tcorpus)
        name_negs = []
        jl, tl = [], []
        for i, b in enumerate(batches):
            key = prng.key_for_step(base_key, i, prng.STREAM_NEGATIVES)
            n = np.asarray(jneg.sample_negative_ids(
                key, jcfg.num_negatives, N_ITEMS,
                None if jcfg.shared_negatives else 32))
            name_negs.append(n)
            jb = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                data_sharding)
            jstate, jm = jstep(jstate, jb)
            tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                        for k, v in b.items()},
                               neg_ids=torch.from_numpy(n.copy()))
            jl.append(float(jm["loss"]))
            tl.append(float(tm["loss"]))
        want["jax"][name] = {
            "losses": jl, "params": jax.tree_util.tree_map(
                np.asarray, jstate.params),
            "opt": ({f"{t}/{k}": np.asarray(v) for t in ("album", "artist")
                     for k, v in jstate.opt_state[t].items()}
                    if kw["momentum"] else {})}
        want["unsharded"][name] = {
            "losses": tl, "params": tpl.whole_params(tstate.params),
            "opt": ({f"{t}/{k}": v.numpy() for t in ("album", "artist")
                     for k, v in tstate.opt_state[t].items()}
                    if kw["momentum"] else {})}
        negs_by[name] = name_negs
        if name == EVAL_CARRIER:
            want["eval"] = _jax_sharded_eval(jmodel, jcfg, jstate, jcorpus,
                                             mesh, eval_batch)
    args = {"n_model": n_model, "corpus": corpus, "batches": batches,
            "cfgs": cfgs, "negs_by": negs_by, "jstates": jstates0,
            "eval_cfg": EVAL_CARRIER, "eval_config": cfgs[EVAL_CARRIER],
            "eval_batch": eval_batch}
    outs = spawn("job_steps", world, str(tmp_path_factory.mktemp("ranks")),
                 args, timeout=120)
    return {"n_data": n_data, "n_model": n_model, "want": want,
            "outs": outs}


@pytest.mark.parametrize("carrier", list(CARRIERS))
@pytest.mark.parametrize("against", ["jax", "unsharded"])
def test_sharded_steps_equal_the_reference(grid_run, carrier, against):
    want = grid_run["want"][against][carrier]
    for rank, out in enumerate(grid_run["outs"]):
        got = out[carrier]
        assert got["step"] == STEPS
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                                   err_msg=f"rank {rank} losses")
        for t in ("album_embed", "artist_embed"):
            _close(got["params"][t]["embedding"],
                   want["params"][t]["embedding"], f"rank {rank} {t}")
        assert set(got["opt"]) == set(want["opt"])
        for k, v in want["opt"].items():
            if k.endswith("last_step"):
                np.testing.assert_array_equal(got["opt"][k], v)
            else:
                _close(got["opt"][k], v, f"rank {rank} {k}")


def test_sharded_eval_equals_the_jax_package(grid_run):
    wvals, wids, wmetrics = grid_run["want"]["eval"]
    n_data = grid_run["n_data"]
    rb = wids.shape[0] // n_data
    assert np.isfinite(wvals).all()
    for out in grid_run["outs"]:
        ev = out["eval"]
        d = ev["data_index"]
        want_ids, want_vals = wids[d * rb:(d + 1) * rb], wvals[
            d * rb:(d + 1) * rb]
        _close(ev["vals"], want_vals, "top-500 scores")
        for got_row, want_row, val_row in zip(ev["ids"], want_ids,
                                              want_vals):
            assert set(got_row) == set(want_row)
            # a different id at a position: the reference scores it
            # within float32 rounding of the one it ranks there
            pos = {int(i): j for j, i in enumerate(want_row)}
            for j in np.flatnonzero(got_row != want_row):
                _close(val_row[pos[int(got_row[j])]], val_row[j],
                       "a reordered near-tie")
        assert (ev["ids"] != want_ids).mean() < 1e-3
        assert set(ev["metrics"]) == set(wmetrics)
        for k, v in wmetrics.items():
            np.testing.assert_allclose(ev["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("carrier", ["dense", "lazy"])
def test_one_rank_mesh_equals_the_unsharded_code_bit_for_bit(tmp_path,
                                                             carrier):
    """A world of one rank (chip_smoke.py's mesh phase, here on gloo at a
    small width, bf16 scoring as the flagship's): the sharded steps and
    eval on a 1x1 mesh equal the unsharded ones in every bit, since a
    sum over one rank is the identity."""
    cfg = tpl.PlaylistConfig(**{**BASE, **CARRIERS[carrier],
                                "compute_dtype": "bfloat16",
                                "shared_negatives": True,
                                "corpus_block": 1024})
    rng = np.random.default_rng(9)
    args = {"cfg": cfg, "corpus": _corpus(rng),
            "batches": [_batch(rng, 32) for _ in range(STEPS)],
            "eval_batch": _batch(rng, 32)}
    (out,) = spawn("job_one_rank", 1, str(tmp_path / "rank"), args,
                   timeout=60)
    assert out["step"] == STEPS
    assert all(u == s for u, s in out["losses"]), out["losses"]
    n = 6 if carrier == "lazy" else 4   # tables, momentum (, last_step)
    assert all(out["same"].values()) and len(out["same"]) == n, out["same"]
    assert out["eval_ids_equal"] and out["eval_vals_equal"]
    assert out["finite"]


def test_mesh_check_tool_on_four_ranks(tmp_path):
    """``tools/mesh_check.py`` (the card's multi-rank check) on 4 gloo
    ranks at small widths, every path: the sparse step's 2x2 sharded eval
    equals the exact one and its 5 sharded steps stay within its bounds of
    the unsharded ones; sharded serving (1x4) in four modes, GloVe and
    txt2url (2x2), scale_table (1x4), STL (4x1) and the dense step (2x2)
    pass their checks against the unsharded code."""
    argv = ["--device", "cpu", "--batch_size", "32", "--max_next", "8",
            "--eval_playlists", "16", "--corpus_size", "3000",
            "--num_albums_raw", "900", "--album_buckets", "300",
            "--num_artists", "500", "--steps", "5", "--profile_steps", "1",
            "--catalog_items", "2000", "--catalog_dim", "16",
            "--serve_k", "10", "--serve_reps", "2", "--workload_steps", "2",
            "--glove_rows", "500", "--glove_dim", "8", "--glove_batch", "64",
            "--t2u_words", "300", "--t2u_urls", "40", "--t2u_dim", "8",
            "--t2u_batch", "8", "--scale_rows", "500", "--scale_ids", "64",
            "--stl_image_size", "32", "--stl_batch", "4",
            "--stl_filters", "4,8"]
    outs = spawn("job_mesh_check", 4, str(tmp_path / "ranks"), argv,
                 timeout=240)
    out = outs[0]
    assert out["ok"] and out["mesh"] == "2x2" and out["backend"] == "gloo"
    assert out["eval"]["scores_equal"] and out["eval"]["id_sets_equal"]
    assert set(out["diffs"]) == {"album table", "album momentum",
                                 "artist table", "artist momentum"}
    paths = out["paths"]
    assert set(paths) == {"serving", "glove", "txt2url", "scale_table",
                          "stl", "dense"}
    assert all(p["ok"] for p in paths.values()), paths
    assert paths["serving"]["exact"]["id_sets_equal"]
    assert paths["serving"]["fused"]["mode"] == \
        "sharded:4+fused:bins=4096"
    assert paths["glove"]["mesh"] == paths["txt2url"]["mesh"] == "2x2"
    assert paths["scale_table"]["mesh"] == "1x4"
    assert paths["stl"]["mesh"] == "4x1" and paths["stl"]["replicas_equal"]
    assert paths["dense"]["mesh"] == "2x2"


def test_sharded_eval_refuses_the_fused_kernel(tmp_path):
    cfg = tpl.PlaylistConfig(**{**BASE, "eval_fused_bins": 4096,
                                "n_model_shards": 2})
    mesh = types.SimpleNamespace(n_model=2, n_data=1, model_index=0)
    corpus = {k: torch.from_numpy(v)
              for k, v in _corpus(np.random.default_rng(0)).items()}
    with pytest.raises(ValueError, match="eval_fused_bins requires"):
        tpl.select_eval_step(None, cfg, corpus, mesh)


# ------------------------------------------------------------ train()

@pytest.fixture(scope="module")
def packed_mpd(tmp_path_factory):
    from tests.test_torch_train_entry import _etl

    return _etl(str(tmp_path_factory.mktemp("mpd")), pack=True)


def test_train_on_two_ranks_exports_and_stops_together(packed_mpd,
                                                       tmp_path):
    """``train()`` with ``n_model_shards=2`` on two gloo ranks completes,
    its artifact (the whole tables, written by rank 0) loads in the JAX
    package's loader; a SIGTERM to rank 1 after step 7 stops both ranks at
    step 7, each with its checkpoint of that step and no export, and the
    checkpoint restores on the same mesh bit for bit, and into the lazy
    carrier's shards (``restore_adapt_carrier``: the momentum as saved,
    ``last_step`` at the step)."""
    from esrecsys_tpu.train.export import load_model as jax_load_model
    from tests.test_torch_train_entry import _cfg

    data = packed_mpd
    cfg = _cfg(data, str(tmp_path / "wd"), n_model_shards=2,
               sparse_updates=True, max_steps=20, eval_every_steps=10,
               checkpoint_every_steps=10, log_every_steps=10,
               train_pattern=f"{data}/packed/*.npz",
               test_pattern=f"{data}/packed/*.npz")
    outs = spawn("job_train", 2, str(tmp_path / "ranks"),
                 {"cfg": cfg, "kill_rank": 1, "kill_at": 7}, timeout=120)
    for out in outs:
        assert out["steps_run"] == 20 and out["step"] == 20
        assert not out["preempted"]
        assert np.isfinite(out["train"]["train_loss"])
        assert "eval_artist_recall" in out["eval"]
        assert out["sigterm"] == {"step": 7, "preempted": True,
                                  "ckpt": [7], "artifacts": False}
        assert out["restored"] and out["adapted"]
    assert outs[0]["eval"] == outs[1]["eval"]   # metrics agree over ranks
    arts = os.listdir(f"{cfg.work_dir}/artifacts")
    assert arts == ["playlist-00000020.npz"]
    params, _, meta = jax_load_model(f"{cfg.work_dir}/artifacts/{arts[0]}")
    assert meta["valid_rows"] == {"album_embed": 16, "artist_embed": 10}
    for t in ("album_embed", "artist_embed"):
        emb = params[t]["embedding"]
        assert emb.shape == (128, 8) and np.isfinite(emb).all()
    for r in range(2):
        assert sorted(os.listdir(
            f"{cfg.work_dir}/checkpoints/rank-{r}-of-2")) == [
            "ckpt-00000010.npz", "ckpt-00000020.npz"]
