"""The port's quality-parity tools (``esrecsys_tpu_torch/tools/
parity_runs.py`` and ``playlist_parity_sweep.py``) against the JAX
package's.

  * Data and accounting: each workload's run at ``tests/
    test_parity_runs.py``'s sizes, the train steps of both packages
    replaced by recorders, feeds the same batches in the same order (the
    data generators bit-equal) and reports the same ``steps`` and
    ``examples``. The reference scans ``steps_per_call`` batches a
    dispatch; the port runs them one step at a time.
  * Evals: on a JAX-initialised state carried over by ``convert``, the
    port's eval code gives the JAX tool's metrics on the same eval data:
    playlist recall@500 within one hit (float32 sums in another order can
    move the 500th item; bf16 scoring too), GloVe's eval loss within 1e-5
    relative and the same overlap@10, STL's triplet loss within 1e-5
    relative, txt2url's recall@10 equal.
"""

import numpy as np
import pytest
import torch

import esrecsys_tpu.tools.parity_runs as jpr
from esrecsys_tpu_torch import convert
from esrecsys_tpu_torch.tools import parity_runs as tpr
from esrecsys_tpu_torch.tools import playlist_parity_sweep as tps


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return np.asarray(tree)


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture
def recorded(monkeypatch):
    """Record the batches each package's train steps receive, one entry per
    step, and skip the steps (the state stays the init). JAX's steps are
    the jitted ``multi``/``multi_fn`` scans (split per step) and
    ``train_step``; the port's are the workload step factories' steps."""
    import jax

    from esrecsys_tpu_torch.workloads import glove as tgw
    from esrecsys_tpu_torch.workloads import playlist as tpl
    from esrecsys_tpu_torch.workloads import stl as tsw
    from esrecsys_tpu_torch.workloads import txt2url as tt2u

    seen = {"jax": [], "port": []}
    real_jit = jax.jit

    def fake_jit(fn, *a, **k):
        name = getattr(fn, "__name__", "")
        if name == "multi":        # playlist: (state, stacked dict)
            def rec(state, stacked):
                st = _np(stacked)
                n = next(iter(st.values())).shape[0]
                seen["jax"] += [{k: v[i] for k, v in st.items()}
                                for i in range(n)]
                return state, None
            return rec
        if name == "multi_fn":     # glove: (state, (i, j, count) stacked)
            def rec(state, xs):
                i, j, c = _np(xs)
                seen["jax"] += [((i[s], j[s]), c[s]) for s in range(len(i))]
                return state
            return rec
        if name == "train_step":   # stl, txt2url
            def rec(state, batch):
                seen["jax"].append(_np(batch))
                return state, {}
            return rec
        return real_jit(fn, *a, **k)

    monkeypatch.setattr(jax, "jit", fake_jit)

    def factory(*a, **k):
        def rec(state, batch):
            seen["port"].append(_np(batch))
            return state, {}
        return rec

    monkeypatch.setattr(tpl, "select_train_step", factory)
    monkeypatch.setattr(tgw, "select_train_step", factory)
    monkeypatch.setattr(tsw, "make_train_step", factory)
    monkeypatch.setattr(tt2u, "make_train_step", factory)

    # the evals of the untrained states are held to JAX's below, on
    # converted states; here both packages' evals are skipped
    from esrecsys_tpu.workloads import glove as jgw
    from esrecsys_tpu.workloads import playlist as jpl
    from esrecsys_tpu.workloads import stl as jsw

    fake_eval = lambda *a, **k: (lambda state, batch: {
        "loss": 0.0, "track_recall": 0.0, "artist_recall": 0.0})
    monkeypatch.setattr(jpl, "select_eval_step", fake_eval)
    monkeypatch.setattr(jgw, "make_eval_step", fake_eval)
    monkeypatch.setattr(jsw, "make_eval_step", fake_eval)
    monkeypatch.setattr(jgw, "knn", lambda *a, **k: (None, np.zeros((100, 11))))
    monkeypatch.setattr(tpr, "playlist_eval", lambda *a: {})
    monkeypatch.setattr(tpr, "glove_eval", lambda *a: {})
    monkeypatch.setattr(tpr, "stl_eval", lambda *a: 0.0)
    return seen


CASES = {
    "playlist": (lambda m, out: m.run_playlist(
        [0], out, examples=2048, eval_playlists=64, **_dev(m))),
    "glove": (lambda m, out: m.run_glove([0], out, steps=64, vocab=512,
                                         **_dev(m))),
    "stl": (lambda m, out: m.run_stl([0], out, steps=4, size=16, **_dev(m))),
    "txt2url": (lambda m, out: m.run_txt2url([0], out, steps=12, n_urls=100,
                                             n_words=300, **_dev(m))),
}


def _dev(mod):
    return {"device": "cpu"} if mod is tpr else {}


@pytest.mark.parametrize("workload", sorted(CASES))
def test_runs_feed_the_jax_batches_and_report_its_steps(workload, recorded,
                                                        tmp_path):
    run = CASES[workload]
    jres = run(jpr, str(tmp_path / "jax"))
    tres = run(tpr, str(tmp_path / "port"))
    assert tres.keys() == jres.keys()
    for name in jres:
        for key in ("steps", "examples", "seed"):
            assert [r.get(key) for r in tres[name]] == \
                [r.get(key) for r in jres[name]], (name, key)
    assert len(recorded["port"]) == len(recorded["jax"]) > 0
    for i, (t, j) in enumerate(zip(recorded["port"], recorded["jax"])):
        assert _equal(t, j), (workload, i)
    assert (tmp_path / "port" / f"parity_{workload}.json").exists()


def test_glove_runs_whole_dispatches_but_reports_n_steps(recorded, tmp_path):
    """The reference runs (n_steps // 32) * 32 glove steps and reports
    n_steps; so does the port."""
    res = tpr.run_glove([0], str(tmp_path), steps=40, vocab=512,
                        device="cpu")
    assert [r["steps"] for r in res["reference_shape"]] == [40]
    assert [r["steps"] for r in res["fast"]] == [100]
    assert len(recorded["port"]) == 32 + 96


def test_playlist_corpus_and_eval_batch_are_the_jax_ones():
    jc = jpr._playlist_corpus(np.random.default_rng(1234))
    tc = tpr._playlist_corpus(np.random.default_rng(1234))
    assert _equal(list(tc), list(jc))
    jb = jpr._playlist_batch(np.random.default_rng(999), 1024, 5, 10, *jc[1:])
    tb = tpr._playlist_batch(np.random.default_rng(999), 1024, 5, 10, *tc[1:])
    assert _equal(tb, jb)
    d = tps._data("cpu")
    assert _equal(_np(d["eval_batch"]), jb)
    assert _equal(_np(d["corpus"]), jc[0])


def test_stl_images_are_the_jax_ones():
    assert np.array_equal(tpr._stl_images(np.random.default_rng(777), 16, 32),
                          jpr._stl_images(np.random.default_rng(777), 16, 32))


# ------------------------------------------------------------- evals

PLAYLIST_CONFIGS = {
    "reference_shape": dict(batch_size=1, num_negatives=64,
                            shared_negatives=False, sparse_updates=False,
                            momentum=0.98, learning_rate=1e-3),
    "fast": dict(batch_size=2048, num_negatives=512, shared_negatives=True,
                 sparse_updates=True, momentum=0.98, learning_rate=0.004,
                 compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("name", sorted(PLAYLIST_CONFIGS))
def test_playlist_eval_equals_jax(name):
    import jax

    from esrecsys_tpu.workloads import playlist as jpl

    ov = PLAYLIST_CONFIGS[name]
    corpus_np, pools, album_of, artist_of = jpr._playlist_corpus(
        np.random.default_rng(1234))
    batch = jpr._playlist_batch(np.random.default_rng(999), 64, 5, 10, pools,
                                album_of, artist_of)
    jcfg = jpl.PlaylistConfig(
        feature_size=32, album_hash_buckets=20_000, num_artists=5_000,
        context_size=5, max_next=10, eval_k=500, eval_group=8,
        corpus_block=65536, seed=3, **ov)
    jmodel, jstate = jpl.init_state(jcfg, mesh=None)
    jcorpus = {k: jax.numpy.asarray(v) for k, v in corpus_np.items()}
    jstate = jpl.settle_momentum_state(jstate, jcfg)
    em = jax.device_get(jax.jit(jpl.select_eval_step(
        jmodel, jcfg, jcorpus, mesh=None))(
        jstate, {k: jax.numpy.asarray(v) for k, v in batch.items()}))

    tcfg = tpr.playlist_cfg(ov, 3)
    tstate = convert.state_from_jax(jstate, tcfg, device="cpu")
    got = tpr.playlist_eval(tstate.params, tstate, tcfg,
                            {k: torch.from_numpy(v)
                             for k, v in corpus_np.items()},
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    one_hit = 1.0 / (64 * 10)
    assert abs(got["track_recall@500"] - float(em["track_recall"])) \
        <= one_hit + 1e-7
    assert abs(got["artist_recall@500"] - float(em["artist_recall"])) \
        <= one_hit + 1e-7


def test_glove_eval_equals_jax():
    import jax
    import jax.numpy as jnp

    from esrecsys_tpu.workloads import glove as jgw
    from esrecsys_tpu_torch.workloads import glove as tgw

    vocab = 512
    u, probe, gt_nn, top64 = tpr.glove_data(vocab)
    jcfg = jgw.GloveConfig(feature_size=64, batch_size=2048, seed=2,
                           optimizer="adam", learning_rate=5e-4,
                           steps_per_call=32)
    jmodel, jstate = jgw.init_state(jcfg, num_embeddings=vocab, mesh=None)
    erng = np.random.default_rng(5555)
    jes = jax.jit(jgw.make_eval_step(jmodel))
    losses = []
    for _ in range(20):
        (i, j), ct = tpr.glove_batch(erng, u, top64, vocab)
        losses.append(float(jax.device_get(jes(
            jstate, ((jnp.asarray(i), jnp.asarray(j)), jnp.asarray(ct)))[
                "loss"])))
    _, top_idx = jgw.knn(jstate, jnp.asarray(probe), k=11, valid_rows=vocab)
    overlap = np.mean([len(set(np.asarray(top_idx)[p, 1:11]) & set(gt_nn[p]))
                       / 10.0 for p in range(len(probe))])

    tcfg = tgw.GloveConfig(feature_size=64, batch_size=2048, seed=2,
                           optimizer="adam", learning_rate=5e-4)
    tstate = convert.glove_state_from_jax(jstate, tcfg, vocab, device="cpu")
    got = tpr.glove_eval(tstate.params, tstate, u, top64, probe, gt_nn, vocab,
                         torch.device("cpu"))
    assert got["eval_loss"] == pytest.approx(float(np.mean(losses)),
                                             rel=1e-5)
    assert got["probe_nn_overlap@10"] == float(overlap)


def test_stl_eval_equals_jax():
    import jax
    import jax.numpy as jnp

    from esrecsys_tpu.workloads import stl as jsw

    size, n_styles = 16, 16
    base = tpr._stl_images(np.random.default_rng(777), n_styles, size)
    ov = dict(batch_size=16, use_bf16=False)
    jcfg = jsw.STLConfig(image_size=size, output_size=64, filters=(16, 32),
                         learning_rate=1e-4, regularization=0.2, seed=1, **ov)
    jmodel, jstate = jsw.init_state(jcfg)
    ev = jax.jit(jsw.make_eval_step(jcfg))
    erng = np.random.default_rng(31337)
    losses = []
    for _ in range(16):
        s, p, n = tpr.stl_triplets(erng, base, n_styles, size, 16)
        losses.append(float(jax.device_get(ev(
            jstate, (jnp.asarray(s), jnp.asarray(p), jnp.asarray(n)))[
                "loss"])))
    tcfg = tpr.stl_cfg(ov, 1, size)
    tstate = convert.stl_state_from_jax(jstate, tcfg, device="cpu")
    got = tpr.stl_eval(tstate.params, tstate, tcfg, base, n_styles, size,
                       torch.device("cpu"))
    assert got == pytest.approx(float(np.mean(losses)), rel=1e-5)


@pytest.mark.parametrize("encoder", ["lstm", "mean"])
def test_txt2url_recall_equals_jax(encoder):
    import jax
    import jax.numpy as jnp

    from esrecsys_tpu.models.txt2url import Txt2UrlModel as JModel
    from esrecsys_tpu.workloads import txt2url as jt2u

    n_urls, n_words, L = 100, 300, 12
    url_words = tpr.txt2url_data(n_urls, n_words)
    eval_batch = tpr.txt2url_batch(np.random.default_rng(4242), url_words,
                                   n_urls, L, 512)
    ov = dict(encoder_type=encoder, batch_size=64, learning_rate=1e-3)
    jcfg = jt2u.Txt2UrlConfig(word_dim=16, rnn_size=16, url_dim=16,
                              sentence_length=L, seed=4, **ov)
    jmodel, jstate = jt2u.init_state(jcfg, word_vocab_size=n_words,
                                     url_vocab_size=n_urls, mesh=None)
    scores = np.asarray(jax.device_get(jax.jit(
        lambda s, toks: s.apply_fn({"params": s.params}, toks,
                                   method=JModel.score_text_vs_all))(
        jstate, jnp.asarray(eval_batch["tokens"]))))
    top10 = np.argsort(-scores, axis=1)[:, :10]
    want = float(np.mean([eval_batch["url_near_text"][i] in top10[i]
                          for i in range(top10.shape[0])]))
    tcfg = tpr.txt2url_cfg(ov, 4, L)
    tstate = convert.txt2url_state_from_jax(jstate, tcfg, device="cpu")
    assert tpr.txt2url_recall(tstate.params, eval_batch,
                              torch.device("cpu")) == want


# ------------------------------------------------------------- sweep tool

def test_run_fast_phases_and_settle(monkeypatch):
    """``run_fast`` steps each lr phase's share of the examples in whole
    runs of 8 batches and settles at each boundary at the outgoing lr, then
    once through the barrier before the eval."""
    from esrecsys_tpu_torch.workloads import playlist as tpl

    settles = []
    real = tpl.settle_momentum_state

    def spy(state, cfg, lr=None):
        settles.append((cfg.learning_rate, lr, state.step))
        return real(state, cfg, lr=lr)

    monkeypatch.setattr(tpl, "settle_momentum_state", spy)
    out = tps.run_fast({"momentum": 0.98, "learning_rate": 0.004,
                        "batch_size": 256, "momentum_carrier": "lazy"},
                       seed=0, examples=256 * 8 * 3,
                       lr_phases=[(2 / 3, 0.004), (1 / 3, 0.001)],
                       device="cpu")
    assert out["steps"] == 24 and out["examples"] == 24 * 256
    assert settles == [(0.004, 0.004, 16), (0.001, None, 24)]
    assert np.isfinite(out["track_recall@500"])


def test_bayes_sweeps_through_the_port_sweeper(monkeypatch, tmp_path):
    """``bayes`` runs the reference tool's spec and seed: the overrides it
    trains equal the JAX sweeper's picks for the same metrics."""
    from esrecsys_tpu.tools import sweep as jsweep

    metrics = iter([0.1, 0.3, 0.2, 0.25, 0.15, 0.4])
    tried = []

    def fake(overrides, seed, examples=0, lr_phases=None, device=None):
        tried.append(dict(overrides))
        return {"track_recall@500": next(metrics)}

    monkeypatch.setattr(tps, "run_fast", fake)
    res = tps.bayes(str(tmp_path / "port"), examples=1, max_runs=6,
                    device="cpu")
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Swept:
        learning_rate: float = 6e-3
        momentum: float = 0.98
        num_negatives: int = 512
        batch_size: int = 2048

    metrics = iter([0.1, 0.3, 0.2, 0.25, 0.15, 0.4])
    spec = jsweep.SweepSpec(
        method="bayes", metric_name="track_recall@500",
        metric_goal="maximize",
        parameters={
            "learning_rate": {"min": 1e-3, "max": 3e-2, "log": True},
            "momentum": {"values": [0.9, 0.95, 0.98]},
            "num_negatives": {"values": [256, 512, 1024]},
            "batch_size": {"values": [1024, 2048, 4096]},
        },
        max_runs=6, n_init=5, early_stop_patience=8, seed=7)
    want = jsweep.run_sweep(spec, Swept(), lambda c: next(metrics),
                            str(tmp_path / "jax"),
                            metric_from_result=lambda r: r)
    assert tried == [r["overrides"] for r in want["runs"]]
    assert res["runs"] == want["runs"]
