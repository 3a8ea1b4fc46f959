"""The txt2url trainer of the port against the JAX package's: the
pipelines (``sparse_doc_sentences``, ``url_dice_triples``,
``txt2url_batches``), the losses of ``ops/losses.py``, ``max_norm_project``,
the LSTM and mean sentence encoders, RMSprop with its staircase schedule
against ``optax.rmsprop``, the train step under each objective, the eval
step with planted ties, the GloVe transfer, ``train()`` with its hooks,
checkpoints and CLI, and txt2url artifacts crossing both ways.

Sizes: vocabularies of a few hundred words and 40 URLs (the word table
holds the minhash buckets too where a dictionary builds it), B=8, L=6,
widths 8-16. Inputs come from numpy seeds; params and optimizer states
from the JAX ``init_state`` through ``convert.txt2url_state_from_jax``.

Tolerances: the pipelines' batches bit-equal (with the shuffle off, and
on: both packages shuffle through the same streaming buffer). Each loss
and its gradients within 1e-6 relative and 1e-7 absolute (the same
float32 operations; XLA's ``logsumexp`` and ``exp`` may differ from
PyTorch's by an ulp), but the in-batch softmax's gradients within 1e-5
relative and 1e-6 absolute (each sums B softmax-weighted rows in another
order). ``max_norm_project`` within 1e-6. The encoders and
their parameter gradients within 1e-5 relative and 1e-6 absolute (the
same float32 recurrence; XLA's sigmoid and tanh and its summation orders
differ by ulps, carried through six steps). RMSprop within 1e-6 relative
and 1e-7 absolute over 25 steps. Three train steps of each objective:
losses within 1e-5 relative, parameters within 1e-5 relative and 2e-6
absolute, ``nu`` within 1e-4 relative and 1e-9 absolute (RMSprop divides
each gradient element by its own root mean square, so a gradient element
near float32 noise moves the parameter by up to ``lr * |g| / sqrt(eps)``
in either package; ``nu`` holds squares of gradients, twice their
relative error). The eval metrics equal; exports bit-equal.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esrecsys_tpu.data import pipelines as jpipelines
from esrecsys_tpu.data.protos import corpus_pb2
from esrecsys_tpu.models import txt2url as jmodels
from esrecsys_tpu.ops import losses as jlosses
from esrecsys_tpu.train import export as jexport
from esrecsys_tpu.workloads import txt2url as jt2u
from esrecsys_tpu_torch import convert
from esrecsys_tpu_torch.data import pipelines, protos, recordio
from esrecsys_tpu_torch.data.vocab import VocabEntry, Vocabulary
from esrecsys_tpu_torch.models import txt2url as models
from esrecsys_tpu_torch.ops import losses
from esrecsys_tpu_torch.ops.optim import exponential_decay, rmsprop_update
from esrecsys_tpu_torch.train import export as texport
from esrecsys_tpu_torch.train.checkpoint import Checkpointer
from esrecsys_tpu_torch.workloads import glove as tglove
from esrecsys_tpu_torch.workloads import txt2url as t2u

N_URLS = 40
N_WORDS = 300          # embedding rows of the small word tables
B, L = 8, 6
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, rtol, atol, msg=""):
    got = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(got, np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=msg)


# ------------------------------------------------------------------ data

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Sparse documents (a third shorter than L, some empty) in two
    shards, url2url rows in two, and the two dictionaries, all written by
    the port: URL u's documents draw tokens near ``10 u``, and URLs of one
    parity co-occur."""
    tmp = tmp_path_factory.mktemp("t2u")
    rng = np.random.default_rng(0)
    docs = []
    for u in range(N_URLS):
        for _ in range(3):
            n = int(rng.choice([0, 3, 5, 9, 20]))
            toks = (10 * u + rng.integers(1, 12, n)) % (N_WORDS - 1) + 1
            docs.append(protos.SparseDocument(url=f"u{u}", primary_index=u,
                                              token_index=toks))
    recordio.write_protos(str(tmp / "sdoc-00000.bz2"), docs[:50])
    recordio.write_protos(str(tmp / "sdoc-00001.bz2"), docs[50:])
    rows = [protos.CooccurrenceRow(
        index=u, other_index=[v for v in range(u) if v % 2 == u % 2],
        count=[float(rng.integers(1, 6)) for v in range(u) if v % 2 == u % 2])
        for u in range(2, N_URLS)]
    recordio.write_protos(str(tmp / "url2url-00000.gz"), rows[:20])
    recordio.write_protos(str(tmp / "url2url-00001.gz"), rows[20:])
    token_vocab = Vocabulary([VocabEntry(token=f"w{i}", frequency=500 - i)
                              for i in range(1, 50)])
    title_vocab = Vocabulary([VocabEntry(token=f"u{u}", frequency=10,
                                         doc_frequency=5 + u % 7)
                              for u in range(N_URLS)])
    token_vocab.save(str(tmp / "tok.bz2"))
    title_vocab.save(str(tmp / "title.bz2"))
    df = np.asarray([title_vocab.doc_frequency(i) for i in range(N_URLS)],
                    np.float64)
    return {"txt2url": str(tmp / "sdoc-*.bz2"),
            "url2url": str(tmp / "url2url-*.gz"),
            "tok": str(tmp / "tok.bz2"), "title": str(tmp / "title.bz2"),
            "df": df, "token_vocab": token_vocab,
            "title_vocab": title_vocab}


def test_sentences_and_dice_triples_match_the_reference(corpus):
    got = list(pipelines.sparse_doc_sentences(corpus["txt2url"], L, 3,
                                              repeat=False, seed=4))
    want = list(jpipelines.sparse_doc_sentences(corpus["txt2url"], L, 3,
                                                repeat=False, seed=4))
    assert len(got) == len(want) > N_URLS
    for (gu, gt), (wu, wt) in zip(got, want):
        assert gu == wu and gt.dtype == np.int32
        np.testing.assert_array_equal(gt, wt)
    got = list(pipelines.url_dice_triples(corpus["url2url"], corpus["df"],
                                          repeat=False, seed=2))
    want = list(jpipelines.url_dice_triples(corpus["url2url"], corpus["df"],
                                            repeat=False, seed=2))
    assert got == want and len(got) > 100


@pytest.mark.parametrize("shuffle_buffer", [0, 64])
def test_batches_match_the_reference(corpus, shuffle_buffer):
    args = (corpus["txt2url"], corpus["url2url"], corpus["df"], B, L, 2)
    got = pipelines.txt2url_batches(*args, shuffle_buffer=shuffle_buffer,
                                    seed=3)
    want = jpipelines.txt2url_batches(*args, shuffle_buffer=shuffle_buffer,
                                      seed=3)
    for _ in range(40):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _batch(rng, words=N_WORDS, urls=N_URLS):
    tokens = rng.integers(1, words, (B, L)).astype(np.int32)
    for b, n in enumerate([0, 1, 3, L, 2, 5, L, 4]):
        tokens[b, n:] = 0
    tokens[6, 2] = 0          # a hole: the length counts non-zero tokens
    return {"url_near_text": rng.integers(0, urls, B).astype(np.int32),
            "tokens": tokens,
            "url1": rng.integers(0, urls, B).astype(np.int32),
            "url2": rng.integers(0, urls, B).astype(np.int32),
            "sqrt_dice": rng.random(B).astype(np.float32)}


def _tbatch(batch):
    return t2u.to_device(batch, CPU)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------- losses

LOSSES = [
    ("triplet_hinge_sum", 2, {"margin": 0.7}),
    ("mean_triplet", 2, {"margin": 1.0}),
    ("extremal_triplet", 2, {"margin": 0.5}),
    ("self_affinity_floor", 1, {"floor": 0.3}),
    ("self_affinity_ceiling", 1, {}),
    ("norm_cap", 1, {"cap": 0.8}),
    ("embedding_norm_cap", 1, {"cap": 1.0}),
    ("margin_square_loss", 1, {"margin": 1.0}),
]


@pytest.mark.parametrize("name,nargs,kw", LOSSES)
def test_loss_and_gradients_match_jax(name, nargs, kw):
    rng = np.random.default_rng(len(name))
    shape = (B, 16) if name == "embedding_norm_cap" else (B, 5)
    args = [rng.normal(size=shape).astype(np.float32) for _ in range(nargs)]
    if name == "norm_cap":
        args = [np.abs(args[0])]
    if name == "extremal_triplet":   # tied extremes share the gradient
        args[0][1, 2] = args[0][0, 0] = args[0].min()
        args[1][3, 1] = args[1][2, 4] = args[1].max()
    targs = [_t(a).requires_grad_() for a in args]
    got = getattr(losses, name)(*targs, **kw)
    got.backward()
    jfn = lambda *xs: getattr(jlosses, name)(*xs, **kw)  # noqa: E731
    want = jfn(*map(jnp.asarray, args))
    grads = jax.grad(jfn, argnums=tuple(range(nargs)))(
        *map(jnp.asarray, args))
    _close(got, want, 1e-6, 1e-7, name)
    for t, g in zip(targs, grads):
        _close(t.grad, g, 1e-6, 1e-7, f"{name} gradient")


@pytest.mark.parametrize("log_q,temperature", [(False, 1.0), (True, 0.5)])
def test_in_batch_softmax_matches_jax(log_q, temperature):
    rng = np.random.default_rng(7)
    q, i = (rng.normal(size=(B, 16)).astype(np.float32) for _ in range(2))
    lq = rng.normal(size=B).astype(np.float32) if log_q else None
    tq, ti = _t(q).requires_grad_(), _t(i).requires_grad_()
    got = losses.in_batch_softmax(tq, ti, None if lq is None else _t(lq),
                                  temperature)
    got.backward()

    def jfn(a, b):
        return jlosses.in_batch_softmax(
            a, b, None if lq is None else jnp.asarray(lq), temperature)

    want = jfn(jnp.asarray(q), jnp.asarray(i))
    gq, gi = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(i))
    _close(got, want, 1e-6, 1e-7)
    _close(tq.grad, gq, 1e-5, 1e-6)
    _close(ti.grad, gi, 1e-5, 1e-6)


def test_max_norm_project_matches_jax():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 8)).astype(np.float32) * 2
    table[3] = 0.0
    want = jmodels.max_norm_project(jnp.asarray(table), 3.0)
    got = models.max_norm_project(_t(table), 3.0)
    _close(got, want, 1e-6, 1e-7)
    inplace = _t(table)
    models.max_norm_project(inplace, 3.0, out=inplace)
    assert torch.equal(inplace, got)
    small = np.linalg.norm(table, axis=-1) <= 3.0
    assert torch.equal(got[torch.from_numpy(small)],
                       _t(table)[torch.from_numpy(small)])


# ----------------------------------------------------------------- model

def _jax_model(encoder, words=N_WORDS, urls=N_URLS, seed=0):
    cfg = jt2u.Txt2UrlConfig(word_dim=8, rnn_size=12, url_dim=16,
                             sentence_length=L, batch_size=B,
                             encoder_type=encoder, seed=seed)
    return cfg, *jt2u.init_state(cfg, words, urls)


def _port_cfg(jcfg, **kw):
    fields = {f: getattr(jcfg, f) for f in (
        "word_dim", "rnn_size", "url_dim", "sentence_length", "batch_size",
        "encoder_type", "learning_rate", "learning_rate_decay",
        "steps_per_epoch", "margin", "word_max_norm", "url_max_norm",
        "text_objective", "eval_recall_k", "seed")}
    return t2u.Txt2UrlConfig(**{**fields, **kw})


@pytest.mark.parametrize("encoder", ["lstm", "mean"])
def test_encoder_and_gradients_match_jax(encoder):
    jcfg, jmodel, jstate = _jax_model(encoder)
    model = convert.txt2url_model_from_jax(jstate.params, jcfg, "cpu")
    batch = _batch(np.random.default_rng(2))
    assert (batch["tokens"][0] == 0).all()  # a row of length 0

    def jenc(params):
        return jmodel.apply({"params": params}, jnp.asarray(batch["tokens"]),
                            method=jmodels.Txt2UrlModel.encode_text)

    want = jenc(jstate.params)
    jgrads = jax.grad(lambda p: jnp.sum(jenc(p) * jnp.arange(16.0)))(
        jstate.params)
    got = model.encode_text(_t(batch["tokens"]))
    (got * torch.arange(16.0)).sum().backward()
    _close(got, want, 1e-5, 1e-6, encoder)
    flat = convert.params_from_jax(jgrads)
    for name, p in model.named_parameters():  # the URL table: no gradient
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        _close(grad, flat[name], 1e-5, 1e-6, f"{encoder} {name}")
    names = {n for n, _ in model.named_parameters()}
    if encoder == "lstm":
        assert {f"encoder.rnn.cell.{k}.kernel" for k in
                ("ii", "if", "ig", "io", "hi", "hf", "hg", "ho")} <= names
        assert "encoder.rnn.cell.hi.bias" in names
        assert "encoder.rnn.cell.ii.bias" not in names


def test_heads_match_jax():
    jcfg, jmodel, jstate = _jax_model("lstm")
    model = convert.txt2url_model_from_jax(jstate.params, jcfg, "cpu")
    batch = _batch(np.random.default_rng(3))
    args = [batch[k] for k in ("url_near_text", "tokens", "url1", "url2")]
    want = jmodel.apply({"params": jstate.params}, *map(jnp.asarray, args))
    got = model(*map(_t, args))
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-6)
    want = jmodel.apply({"params": jstate.params}, *map(jnp.asarray, args),
                        method=jmodels.Txt2UrlModel.all_pairs_scores)
    for g, w in zip(model.all_pairs_scores(*map(_t, args)), want):
        _close(g, w, 1e-5, 1e-6)
    want = jmodel.apply({"params": jstate.params},
                        jnp.asarray(batch["tokens"]),
                        method=jmodels.Txt2UrlModel.score_text_vs_all)
    got = model.score_text_vs_all(_t(batch["tokens"]))
    assert got.shape == (B, N_URLS)
    _close(got, want, 1e-5, 1e-6)


def test_init_shapes_and_he_normal_scale():
    cfg = t2u.Txt2UrlConfig(word_dim=8, rnn_size=12, url_dim=16)
    model, state = t2u.init_state(cfg, 5000, 3000, "cpu")
    _, _, jstate = _jax_model("lstm", 5000, 3000)
    want = {n: tuple(a.shape) for n, a in convert.params_from_jax(
        jstate.params).items()}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want
    assert set(state.opt_state["nu"]) == set(want)
    for table, rows in ((model.encoder.word_embedding.embedding, 5000),
                        (model.url_embedding.embedding, 3000)):
        t = table.detach().numpy()
        assert abs(t.std() / np.sqrt(2.0 / rows) - 1) < 0.03
        assert np.abs(t).max() <= 2 * np.sqrt(2.0 / rows) / 0.8796 + 1e-6
    h = model.encoder.rnn.cell["hf"].kernel.detach()
    torch.testing.assert_close(h.T @ h, torch.eye(12), atol=1e-5, rtol=0)


# ------------------------------------------------------------- optimizer

def test_rmsprop_with_its_schedule_matches_optax():
    rng = np.random.default_rng(5)
    param = rng.normal(size=(30, 4)).astype(np.float32)
    tx = optax.rmsprop(optax.exponential_decay(0.01, 7, 0.9,
                                               staircase=True))
    jp, jst = jnp.asarray(param), tx.init(jnp.asarray(param))
    tp, nu = _t(param), {"nu": torch.zeros(30, 4)}
    for step in range(25):
        g = rng.normal(size=(30, 4)).astype(np.float32)
        g[step % 30] = 0.0              # an untouched row
        g[(step + 1) % 30, 0] = 1e-12   # a gradient at float32 noise
        upd, jst = tx.update(jnp.asarray(g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        rmsprop_update(tp, _t(g), nu,
                       lr=exponential_decay(0.01, 7, 0.9, step))
    _close(tp, jp, 1e-6, 1e-7)
    _close(nu["nu"], jst[0].nu, 1e-6, 1e-12)


def test_torch_rmsprop_is_a_different_optimizer():
    p = torch.ones(3, requires_grad=True)
    opt = torch.optim.RMSprop([p], lr=0.1)
    p.grad = torch.full((3,), 0.5)
    opt.step()
    mine = torch.ones(3)
    rmsprop_update(mine, torch.full((3,), 0.5), {"nu": torch.zeros(3)},
                   lr=0.1)
    assert not torch.allclose(p.detach(), mine)


# ------------------------------------------------------------------ steps

@pytest.mark.parametrize("objective,encoder", [
    ("margin", "lstm"), ("softmax", "lstm"), ("reference_exact", "lstm"),
    ("margin", "mean")])
def test_three_steps_match_jax(objective, encoder):
    jcfg, jmodel, jstate = _jax_model(encoder)
    jcfg = jt2u.Txt2UrlConfig(**{**jcfg.__dict__,
                                 "text_objective": objective,
                                 "learning_rate": 0.01,
                                 "steps_per_epoch": 2,
                                 "word_max_norm": 0.2, "url_max_norm": 0.3})
    jmodel, jstate = jt2u.init_state(jcfg, N_WORDS, N_URLS)
    tcfg = _port_cfg(jcfg)
    tstate = convert.txt2url_state_from_jax(jstate, tcfg, "cpu")
    jstep = jax.jit(jt2u.make_train_step(jmodel, jcfg))
    tstep = t2u.make_train_step(tstate.params, tcfg)
    rng = np.random.default_rng(9)
    for _ in range(3):
        batch = _batch(rng)
        jstate, jm = jstep(jstate, _jbatch(batch))
        tstate, tm = tstep(tstate, _tbatch(batch))
        for k in ("loss", "text_loss", "url_loss"):
            _close(tm[k], jm[k], 1e-5, 1e-7, k)
    assert tstate.step == int(jstate.step) == 3
    want = convert.params_from_jax(jstate.params)
    for name, p in tstate.params.named_parameters():
        _close(p, want[name], 1e-5, 2e-6, name)
    want_nu = convert.params_from_jax(jstate.opt_state[0].nu)
    for name, nu in tstate.opt_state["nu"].items():
        _close(nu, want_nu[name], 1e-4, 1e-9, f"nu {name}")
    # the projections held: no row above its cap
    for table, cap in ((tstate.params.encoder.word_embedding.embedding, 0.2),
                       (tstate.params.url_embedding.embedding, 0.3)):
        assert float(table.detach().norm(dim=-1).max()) <= cap * (1 + 1e-6)


def test_eval_step_with_planted_ties_matches_jax():
    jcfg, jmodel, jstate = _jax_model("mean")
    jcfg = jt2u.Txt2UrlConfig(**{**jcfg.__dict__, "eval_recall_k": 5})
    # three URL rows equal to the planted target's: the ties go to the
    # lower rows, so some targets fall out of the top 5
    emb = np.array(jstate.params["url_embedding"]["embedding"])
    batch = _batch(np.random.default_rng(4))
    batch["url_near_text"][:4] = [7, 21, 30, 39]
    for target in (7, 21, 30, 39):
        for other in (2, 11, 35):
            emb[other] = emb[target]
    params = {**jstate.params, "url_embedding": {"embedding":
                                                 jnp.asarray(emb)}}
    jstate = jstate.replace(params=params)
    want = jt2u.make_eval_step(jmodel, jcfg)(jstate, _jbatch(batch))
    tcfg = _port_cfg(jcfg)
    tstate = convert.txt2url_state_from_jax(jstate, tcfg, "cpu")
    got = t2u.make_eval_step(tstate.params, tcfg)(tstate, _tbatch(batch))
    assert set(got) == set(want) == {"loss", "text_loss", "url_loss",
                                     "recall_at_k", "mrr_at_k"}
    for k in ("recall_at_k", "mrr_at_k"):
        assert float(got[k]) == float(want[k]), k
    for k in ("loss", "text_loss", "url_loss"):
        _close(got[k], want[k], 1e-5, 1e-7, k)
    scores = tstate.params.score_text_vs_all(_t(batch["tokens"]))
    top = t2u.top_ids_lower_index_first(scores, 5)
    _, jtop = jax.lax.top_k(jmodel.apply(
        {"params": jstate.params}, jnp.asarray(batch["tokens"]),
        method=jmodels.Txt2UrlModel.score_text_vs_all), 5)
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))


# ---------------------------------------------------------- train() e2e

def _glove_checkpoint(tmp_path, rows, optimizer="adam", dim=8):
    """A port GloVe checkpoint of a ``rows``-token table (padded to 128
    rows), its token table returned."""
    gcfg = tglove.GloveConfig(feature_size=dim, optimizer=optimizer)
    _, gstate = tglove.init_state(gcfg, rows, "cpu")
    ck = Checkpointer(str(tmp_path / f"glove_{optimizer}"))
    ck.save(3, gstate)
    return ck.directory, gstate.params.token_embedding.embedding.detach()


@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam"])
def test_glove_transfer_drops_the_pad_rows(corpus, tmp_path, optimizer):
    rows = corpus["token_vocab"].num_embeddings
    directory, table = _glove_checkpoint(tmp_path, rows, optimizer)
    assert table.shape[0] > rows  # padded to 128 rows
    step, saved = t2u.glove_checkpoint_table(directory)
    assert step == 3
    cfg = t2u.Txt2UrlConfig(word_dim=8, rnn_size=8, url_dim=8)
    model, _ = t2u.init_state(cfg, rows, N_URLS, "cpu")
    t2u.load_glove_word_embeddings(model, saved)
    assert torch.equal(model.encoder.word_embedding.embedding.detach(),
                       table[:rows])
    # the JAX package's transfer drops the same rows
    jcfg, _, jstate = _jax_model("lstm", rows)
    jparams = jt2u.load_glove_word_embeddings(
        jstate.params, {"token_embedding": {"embedding": saved}})
    np.testing.assert_array_equal(
        np.asarray(jparams["encoder"]["word_embedding"]["embedding"]),
        table[:rows].numpy())
    with pytest.raises(ValueError):
        t2u.load_glove_word_embeddings(model, saved[:, :4])


def _train_cfg(corpus, tmp_path, **kw):
    base = dict(txt2url_pattern=corpus["txt2url"],
                url2url_pattern=corpus["url2url"],
                token_dictionary=corpus["tok"],
                title_dictionary=corpus["title"],
                work_dir=str(tmp_path / "wd"), word_dim=8, rnn_size=8,
                url_dim=8, sentence_length=L, batch_size=16,
                shuffle_buffer=128, learning_rate=0.01,
                learning_rate_decay=0.95, steps_per_epoch=10, num_epochs=3,
                eval_txt2url_pattern=corpus["txt2url"], eval_every_steps=30,
                eval_steps=2, eval_recall_k=5, probe_words="w1,w2",
                probe_sentences="w1 w2 w3|w4")
    return t2u.Txt2UrlConfig(**{**base, **kw})


@pytest.mark.parametrize("objective,encoder", [("margin", "lstm"),
                                               ("softmax", "mean")])
def test_train_end_to_end(corpus, tmp_path, caplog, objective, encoder):
    rows = corpus["token_vocab"].num_embeddings
    directory, table = _glove_checkpoint(tmp_path, rows)
    cfg = _train_cfg(corpus, tmp_path, text_objective=objective,
                     encoder_type=encoder, glove_checkpoint=directory)
    with caplog.at_level(logging.INFO, logger="esrecsys_tpu_torch"):
        result = t2u.train(cfg, device="cpu")
    assert result.steps_run == 30 and result.state.step == 30
    em = result.last_eval_metrics
    assert set(em) == {"eval_loss", "eval_text_loss", "eval_url_loss",
                       "eval_recall_at_k", "eval_mrr_at_k"}
    assert 0.0 <= em["eval_mrr_at_k"] <= em["eval_recall_at_k"] <= 1.0
    assert np.isfinite(result.last_train_metrics["train_loss"])
    assert result.last_train_metrics["train_url_loss"] < 0.5
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("transferred GloVe word embeddings") for m in msgs)
    assert sum(m.startswith("word_nn step=30 ") for m in msgs) == 2
    assert sum(m.startswith("sentence_nn step=30 ") for m in msgs) == 2
    assert Checkpointer(f"{cfg.work_dir}/checkpoints").all_steps() == [10, 20,
                                                                       30]
    # a fresh template restores step 30 bit for bit
    _, fresh = t2u.init_state(cfg, rows, N_URLS, "cpu",
                              torch.Generator().manual_seed(5))
    restored = Checkpointer(f"{cfg.work_dir}/checkpoints").restore(fresh)
    assert restored.step == 30
    for name, t in result.state.params.state_dict().items():
        assert torch.equal(restored.params.state_dict()[name], t), name
    for name, t in result.state.opt_state["nu"].items():
        assert torch.equal(restored.opt_state["nu"][name], t), name
    # the export loads in the JAX package, which scores as the port does
    path = texport.latest_artifact(cfg.work_dir, "txt2url")
    jparams, _, meta = jexport.load_model(path)
    assert meta == {"name": "txt2url", "step": 30, "word_dim": 8,
                    "url_dim": 8, "rnn_size": 8, "encoder_type": encoder,
                    "sentence_length": L,
                    "valid_rows": {"word_embed": rows, "url_embed": N_URLS}}
    jmodel = jmodels.Txt2UrlModel(word_vocab_size=rows, url_vocab_size=N_URLS,
                                  word_dim=8, rnn_size=8, url_dim=8,
                                  encoder_type=encoder)
    tokens = _batch(np.random.default_rng(0), words=rows)["tokens"]
    want = jmodel.apply({"params": jparams}, jnp.asarray(tokens),
                        method=jmodels.Txt2UrlModel.score_text_vs_all)
    got = result.state.params.score_text_vs_all(_t(tokens))
    _close(got, want, 1e-5, 1e-6)


def test_resume_continues_from_the_checkpoint(corpus, tmp_path):
    cfg = _train_cfg(corpus, tmp_path, num_epochs=1, eval_txt2url_pattern="",
                     probe_words="", probe_sentences="")
    t2u.train(cfg, device="cpu")
    longer = t2u.train(t2u.Txt2UrlConfig(**{**cfg.__dict__, "num_epochs": 2,
                                            "resume": True}), device="cpu")
    assert longer.steps_run == 10 and longer.state.step == 20


def test_jax_export_loads_in_the_port(corpus, tmp_path):
    jcfg = jt2u.Txt2UrlConfig(
        txt2url_pattern=corpus["txt2url"], url2url_pattern=corpus["url2url"],
        token_dictionary=corpus["tok"], title_dictionary=corpus["title"],
        work_dir=str(tmp_path / "jwd"), word_dim=8, rnn_size=8, url_dim=8,
        sentence_length=L, batch_size=8, steps_per_epoch=2, num_epochs=1,
        shuffle_buffer=0)
    jt2u.train(jcfg)
    path = jexport.latest_artifact(jcfg.work_dir, "txt2url")
    model, meta = convert.txt2url_model_from_artifact(path, "cpu")
    jparams, _, _ = jexport.load_model(path)
    assert meta["valid_rows"]["url_embed"] == N_URLS
    rows = meta["valid_rows"]["word_embed"]
    jmodel = jmodels.Txt2UrlModel(word_vocab_size=rows, url_vocab_size=N_URLS,
                                  word_dim=8, rnn_size=8, url_dim=8)
    tokens = _batch(np.random.default_rng(1), words=rows)["tokens"]
    want = jmodel.apply({"params": jparams}, jnp.asarray(tokens),
                        method=jmodels.Txt2UrlModel.encode_text)
    _close(model.encode_text(_t(tokens)), want, 1e-5, 1e-6)


def test_probe_hooks_log_what_the_reference_logs(corpus, caplog):
    """Both hooks on one state: the same neighbours, scores to 3 places."""
    tok, titles = corpus["token_vocab"], corpus["title_vocab"]
    jcfg, jmodel, jstate = _jax_model("lstm", tok.num_embeddings)
    tstate = convert.txt2url_state_from_jax(jstate, _port_cfg(jcfg), "cpu")
    words, sentences = ["w1", "w7", "nope"], ["w1 w2 w3", "w4 nope"]

    def lines(hooks, state):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            for hook in hooks:
                hook(state, 4)
        return [r.getMessage() for r in caplog.records]

    from esrecsys_tpu.data import vocab as jvocab

    jtok = jvocab.Vocabulary.load(corpus["tok"])
    jtitles = jvocab.Vocabulary.load(corpus["title"])
    want = lines([jt2u.word_nn_hook(jmodel, jtok, words),
                  jt2u.sentence_nn_hook(jmodel, jtok, jtitles, sentences,
                                        L)], jstate)
    got = lines([t2u.word_nn_hook(tok, words),
                 t2u.sentence_nn_hook(tok, titles, sentences, L)], tstate)
    assert len(got) == 5 and got == want


def test_cli_and_unported_options(corpus, tmp_path):
    wd = str(tmp_path / "cli")
    result = t2u.main(["--txt2url_pattern", corpus["txt2url"],
                       "--url2url_pattern", corpus["url2url"],
                       "--token_dictionary", corpus["tok"],
                       "--title_dictionary", corpus["title"],
                       "--work_dir", wd, "--word_dim", "8", "--rnn_size",
                       "8", "--url_dim", "8", "--batch_size", "4",
                       "--steps_per_epoch", "2", "--num_epochs", "1",
                       "--shuffle_buffer", "0", "--encoder_type", "mean",
                       "--device", "cpu"])
    assert result.state.step == 2
    assert texport.latest_artifact(wd, "txt2url").endswith(
        "txt2url-00000002.npz")
    with pytest.raises(NotImplementedError):
        t2u.train(t2u.Txt2UrlConfig(n_model_shards=2), device="cpu")
    with pytest.raises(ValueError):
        t2u.init_state(t2u.Txt2UrlConfig(text_objective="nope"), 10, 10,
                       "cpu")
    with pytest.raises(ValueError):
        t2u.init_state(t2u.Txt2UrlConfig(encoder_type="gru"), 10, 10, "cpu")


def test_codec_writes_protobufs_sparse_documents(corpus):
    for raw in recordio.read_records(corpus["txt2url"].replace(
            "*", "00000")):
        assert corpus_pb2.SparseDocument.FromString(
            raw).SerializeToString() == raw
