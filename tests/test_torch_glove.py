"""The GloVe trainer of the port against the JAX package: the proto3 wire
codec against protobuf's ``corpus_pb2``, record files and vocabularies
written by either package read in the other, ``glove_batches``, the
losses, the ``Glove`` model, the dense and LazyAdam steps from converted
params, ``train()`` end to end on ``tests/test_glove_e2e.py``'s
two-cluster data with its export crossing packages, and checkpoints.

Inputs come from numpy seeds; params and optimizer states from the JAX
``init_state`` through ``convert.glove_state_from_jax``.

Tolerances: the codec, record files, vocabularies, ``glove_batches``,
exports and checkpoints bit-exact. The losses within 1e-6 relative (the
same float32 operations; XLA's ``pow`` and ``log10`` may differ from
PyTorch's by an ulp). The model's forward and ``score_all`` within 1e-6
relative and 1e-7 absolute (float32 dots of width 8 in another order).
The steps' losses, tables and moments after 5 steps within 1e-5 relative
and 1e-6 absolute: XLA contracts the jitted step's multiply-adds into
fused ones (one rounding), the port rounds each, and the dense
gradients' duplicate rows sum in another order; Adam's ``m / sqrt(v)``
keeps those float32 differences at float32 size.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.data import recordio as jrecordio
from esrecsys_tpu.data import pipelines as jpipelines
from esrecsys_tpu.data import vocab as jvocab
from esrecsys_tpu.data.protos import corpus_pb2
from esrecsys_tpu.models.glove import Glove as JGlove
from esrecsys_tpu.ops import losses as jlosses
from esrecsys_tpu.train import export as jexport
from esrecsys_tpu.workloads import glove as jglove
from esrecsys_tpu_torch.convert import glove_state_from_jax, params_from_jax
from esrecsys_tpu_torch.data import pipelines, protos, recordio, vocab
from esrecsys_tpu_torch.ops import losses
from esrecsys_tpu_torch.train import export as texport
from esrecsys_tpu_torch.train.checkpoint import Checkpointer
from esrecsys_tpu_torch.workloads import glove as tglove

RTOL, ATOL = 1e-5, 1e-6
N_TOKENS = 20  # embedding ids 1..20, 0 is the mask
VOCAB_ROWS = 1 + N_TOKENS + 65_536  # the mask, the tokens, the buckets


def _rows(rng, n=N_TOKENS):
    """``tests/test_glove_e2e.py``'s two clusters: tokens of a cluster
    co-occur 80-120 times, across clusters 1-2 times."""
    rows = []
    for i in range(1, n + 1):
        others, counts = [], []
        for j in range(1, i):
            same = (i <= n // 2) == (j <= n // 2)
            counts.append(float(rng.integers(80, 120)) if same
                          else float(rng.integers(1, 3)))
            others.append(j)
        if others:
            rows.append((i, others, counts))
    return rows


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The two-cluster rows in two bz2 shards written by the JAX package."""
    tmp = tmp_path_factory.mktemp("cooc")
    rows = [corpus_pb2.CooccurrenceRow(index=i, other_index=o, count=c)
            for i, o, c in _rows(np.random.default_rng(0))]
    jrecordio.write_protos(str(tmp / "part-00000.bz2"), rows[:len(rows) // 2])
    jrecordio.write_protos(str(tmp / "part-00001.bz2"), rows[len(rows) // 2:])
    return str(tmp / "part-*.bz2")


# ------------------------------------------------------------------ codec

def _messages(rng):
    n = int(rng.integers(0, 40))
    big = rng.integers(0, 2 ** 63, n, dtype=np.uint64) * 2 + 1
    return [
        ("TokenStat", dict(token="héllo wörld", url="https://x/y", frequency=7,
                           doc_frequency=3, index=2 ** 40)),
        ("TokenStat", dict(token="a")),
        ("TokenStat", dict()),
        ("CooccurrenceRow", dict(index=5,
                                 other_index=[0, 1, 127, 128, 2 ** 21],
                                 count=[1.5, -0.0, 3e38, 1e-45, 0.1])),
        ("CooccurrenceRow", dict(index=0, other_index=[int(v) for v in big],
                                 count=[float(np.float32(x)) for x in
                                        rng.normal(size=n)])),
        ("CooccurrenceRow", dict(index=2 ** 64 - 1)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_codec_matches_protobuf_both_ways(case):
    name, fields = _messages(np.random.default_rng(case))[case]
    ours = getattr(protos, name)(**fields)
    theirs = getattr(corpus_pb2, name)(**fields)
    assert ours.SerializeToString() == theirs.SerializeToString()
    back = getattr(protos, name).FromString(theirs.SerializeToString())
    assert back == ours
    again = getattr(corpus_pb2, name).FromString(ours.SerializeToString())
    assert again == theirs


def test_codec_reads_unpacked_fields_and_skips_unknown_ones():
    # other_index and count unpacked, a singular field twice (the last
    # wins), and unknown fields of every wire type
    msg = (protos._tag(1, protos.VARINT) + protos.encode_varint(3)
           + protos._tag(2, protos.VARINT) + protos.encode_varint(300)
           + protos._tag(9, protos.I64) + bytes(8)
           + protos._tag(3, protos.I32) + np.float32(2.5).tobytes()
           + protos._tag(10, protos.LEN) + protos.encode_varint(2) + b"zz"
           + protos._tag(2, protos.VARINT) + protos.encode_varint(4)
           + protos._tag(11, protos.I32) + bytes(4)
           + protos._tag(1, protos.VARINT) + protos.encode_varint(6))
    row = protos.CooccurrenceRow.FromString(msg)
    want = corpus_pb2.CooccurrenceRow.FromString(msg)
    assert (row.index, row.other_index, row.count) == (6, [300, 4], [2.5])
    assert (want.index, list(want.other_index), list(want.count)) == (
        6, [300, 4], [2.5])


@pytest.mark.parametrize("bad", [b"\x08", b"\x12\x05ab", b"\x1a\x03abc",
                                 b"\x0a\x01\xff", b"\x00", b"\x0b"])
def test_codec_rejects_malformed_bytes(bad):
    cls = (protos.TokenStat if bad.startswith(b"\x0a")
           else protos.CooccurrenceRow)
    with pytest.raises(protos.DecodeError):
        cls.FromString(bad)


# --------------------------------------------------------------- recordio

@pytest.mark.parametrize("ext", ["bz2", "gz", "b64"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_record_files_cross_packages(tmp_path, ext, writer):
    rows = _rows(np.random.default_rng(1))
    path = str(tmp_path / f"rows.{ext}")
    if writer == "jax":
        jrecordio.write_protos(path, (corpus_pb2.CooccurrenceRow(
            index=i, other_index=o, count=c) for i, o, c in rows))
    else:
        assert recordio.write_protos(path, (protos.CooccurrenceRow(
            index=i, other_index=o, count=c) for i, o, c in rows)) == len(rows)
    got = [(r.index, r.other_index, r.count)
           for r in recordio.read_protos(path, protos.CooccurrenceRow)]
    want = [(r.index, list(r.other_index), list(r.count))
            for r in jrecordio.read_protos(path, corpus_pb2.CooccurrenceRow)]
    assert got == want == [(i, o, c) for i, o, c in rows]


def test_sharded_writer_and_proto_stream_match_the_reference(tmp_path):
    rows = [protos.CooccurrenceRow(index=i, other_index=[i + 1], count=[1.0])
            for i in range(25)]
    with recordio.ShardedWriter(str(tmp_path / "out"), records_per_shard=4,
                                ext="gz") as w:
        for r in rows:
            w.write_proto(r)
    assert w.total == 25
    pattern = str(tmp_path / "out" / "part-*.gz")
    got = recordio.proto_stream(pattern, protos.CooccurrenceRow,
                                shuffle_files=True, repeat=True, seed=3)
    want = jrecordio.proto_stream(pattern, corpus_pb2.CooccurrenceRow,
                                  shuffle_files=True, repeat=True, seed=3)
    assert [next(got).index for _ in range(60)] == [
        next(want).index for _ in range(60)]


def test_shuffled_matches_the_reference():
    got = list(recordio.shuffled(iter(range(500)), 64, seed=9))
    assert got == list(jrecordio.shuffled(iter(range(500)), 64, seed=9))
    assert sorted(got) == list(range(500))


def test_skip_corrupt(tmp_path):
    path = str(tmp_path / "mixed.gz")
    good = [protos.TokenStat(token=t).SerializeToString() for t in "ab"]
    recordio.write_records(path, [good[0], b"\x0b", good[1]])
    with pytest.raises(protos.DecodeError):
        list(recordio.read_protos(path, protos.TokenStat))
    assert [m.token for m in recordio.read_protos(
        path, protos.TokenStat, skip_corrupt=True)] == ["a", "b"]


# ------------------------------------------------------------- vocabulary

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_vocabulary_crosses_packages(tmp_path, writer):
    freq = {"news": 9, "apple": 9, "math": 4, "zebra": 1, "ünï": 4}
    docs = {"news": 3, "apple": 2, "math": 1, "zebra": 1, "ünï": 2}
    mod = jvocab if writer == "jax" else vocab
    built = mod.Vocabulary.from_counts(freq, docs, min_frequency=2,
                                       urls={"news": "u"})
    path = str(tmp_path / "dict.bz2")
    built.save(path)
    ours = vocab.Vocabulary.load(path)
    theirs = jvocab.Vocabulary.load(path)
    assert len(ours) == len(theirs) == 4
    assert ours.num_embeddings == theirs.num_embeddings == 1 + 4 + 65536
    assert ours.max_doc_frequency == theirs.max_doc_frequency
    for i in range(len(ours)):
        assert (ours.token(i), ours.frequency(i), ours.doc_frequency(i)) == (
            theirs.token(i), theirs.frequency(i), theirs.doc_frequency(i))
    probes = ["news", "math", "zebra", "missing", "ab", "längerestoken", ""]
    assert ours.embedding_indices(probes) == theirs.embedding_indices(probes)
    for e in (0, 1, 4, 5, 70, ours.num_embeddings - 1):
        assert ours.token_from_embedding_index(e) == \
            theirs.token_from_embedding_index(e)
    assert [vocab.minhash(t) for t in probes] == [jvocab.minhash(t)
                                                 for t in probes]


# -------------------------------------------------------------- pipelines

def test_triples_match_the_reference(shards):
    got = list(pipelines.cooccurrence_triples(shards, repeat=False, seed=4))
    want = list(jpipelines.cooccurrence_triples(shards, repeat=False, seed=4))
    assert got == want and len(got) == sum(range(N_TOKENS))


@pytest.mark.parametrize("shuffle_buffer", [0, 64])
def test_glove_batches_bit_identical(shards, shuffle_buffer):
    got = pipelines.glove_batches(shards, 32, shuffle_buffer=shuffle_buffer,
                                  seed=7)
    want = jpipelines.glove_batches(shards, 32, shuffle_buffer=shuffle_buffer,
                                    seed=7)
    for _ in range(20):
        (a1, a2), ac = next(got)
        (b1, b2), bc = next(want)
        assert (a1.dtype, a2.dtype, ac.dtype) == (np.int32, np.int32,
                                                  np.float32)
        for a, b in ((a1, b1), (a2, b2), (ac, bc)):
            np.testing.assert_array_equal(a, b)


def test_glove_batches_drop_the_partial_batch(shards):
    batches = list(pipelines.glove_batches(shards, 32, repeat=False))
    assert len(batches) == sum(range(N_TOKENS)) // 32


# ----------------------------------------------------------------- losses

def test_glove_losses_match_jax():
    rng = np.random.default_rng(2)
    count = np.concatenate([[0.0, 1.0, 100.0, 1e6],
                            rng.uniform(0, 300, 60)]).astype(np.float32)
    pred = rng.normal(size=count.shape).astype(np.float32)
    c, p = torch.from_numpy(count), torch.from_numpy(pred)
    for t, j in ((losses.glove_weight(c), jlosses.glove_weight(count)),
                 (losses.glove_target(c), jlosses.glove_target(count)),
                 (losses.glove_loss(p, c), jlosses.glove_loss(pred, count))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


# ------------------------------------------------------------------ model

def _jax_model_and_params(rows, feature_size, seed=0):
    model = JGlove(num_embeddings=rows, features=feature_size)
    dummy = jnp.zeros((2,), jnp.int32)
    return model, model.init(jax.random.PRNGKey(seed), (dummy, dummy))


def test_glove_forward_and_score_all_match_jax():
    jmodel, params = _jax_model_and_params(32, 8)
    # trained-looking biases: the reference initialises them to zero
    params = jax.tree_util.tree_map(lambda a: a, params)
    bias = np.random.default_rng(3).normal(size=(32, 1)).astype(np.float32)
    params["params"]["bias"]["embedding"] = jnp.asarray(bias)
    model = tglove.Glove(32, 8, device="cpu")
    model.load_state_dict(params_from_jax(params["params"]))
    t1 = np.array([1, 2, 31, 0, 5], np.int32)
    t2 = np.array([3, 2, 4, 0, 30], np.int32)
    want = jmodel.apply(params, (jnp.asarray(t1), jnp.asarray(t2)))
    with torch.no_grad():
        got = model((torch.from_numpy(t1), torch.from_numpy(t2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    want = jmodel.apply(params, jnp.asarray(t1), method=JGlove.score_all)
    with torch.no_grad():
        got = model.score_all(torch.from_numpy(t1))
    assert got.shape == (5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_glove_init_pads_rows_and_zeroes_the_bias():
    cfg = tglove.GloveConfig(feature_size=8)
    model, state = tglove.init_state(cfg, N_TOKENS + 1, "cpu")
    jcfg = jglove.GloveConfig(feature_size=8)
    jmodel, jstate = jglove.init_state(jcfg, N_TOKENS + 1, mesh=None)
    assert model.token_embedding.embedding.shape == \
        jstate.params["token_embedding"]["embedding"].shape == (128, 8)
    assert model.bias.embedding.shape == (128, 1)
    assert not model.bias.embedding.detach().any()
    assert model.valid_rows == jmodel.valid_rows == N_TOKENS + 1
    assert set(state.opt_state) == {"token_embedding", "bias"}
    assert state.opt_state["bias"]["nu"].shape == (128, 1)
    with torch.no_grad():
        scores = model.score_all(torch.tensor([1, 2]))
    assert torch.isinf(scores[:, N_TOKENS + 1:]).all()


# ------------------------------------------------------------------ steps

def _step_states(optimizer, lr=0.05):
    jcfg = jglove.GloveConfig(feature_size=8, learning_rate=lr,
                              optimizer=optimizer, steps_per_call=1)
    tcfg = tglove.GloveConfig(feature_size=8, learning_rate=lr,
                              optimizer=optimizer)
    jmodel, jstate = jglove.init_state(jcfg, N_TOKENS + 1, mesh=None)
    bias = np.random.default_rng(5).normal(size=(128, 1)).astype(np.float32)
    jstate = jstate.replace(params={**jstate.params, "bias": {
        "embedding": jnp.asarray(bias) * 0.1}})
    tstate = glove_state_from_jax(jstate, tcfg, N_TOKENS + 1, device="cpu")
    return (jcfg, jmodel, jstate), (tcfg, tstate)


def _compare_states(tstate, jstate, optimizer):
    for name in ("token_embedding", "bias"):
        np.testing.assert_allclose(
            getattr(tstate.params, name).embedding.detach().numpy(),
            np.asarray(jstate.params[name]["embedding"]), rtol=RTOL,
            atol=ATOL, err_msg=name)
    if optimizer == "lazy_adam":
        for key in ("embedding", "bias"):
            for m in ("m", "v"):
                np.testing.assert_allclose(
                    tstate.opt_state[key][m].numpy(),
                    np.asarray(jstate.opt_state[key][m]), rtol=RTOL,
                    atol=ATOL, err_msg=f"{key} {m}")
    else:
        adam = jstate.opt_state[0]
        for name in ("token_embedding", "bias"):
            for m, tree in (("mu", adam.mu), ("nu", adam.nu)):
                np.testing.assert_allclose(
                    tstate.opt_state[name][m].numpy(),
                    np.asarray(tree[name]["embedding"]), rtol=RTOL,
                    atol=ATOL, err_msg=f"{name} {m}")


@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam"])
def test_steps_match_jax_from_converted_params(shards, optimizer):
    (jcfg, jmodel, jstate), (tcfg, tstate) = _step_states(optimizer)
    jstep = jax.jit(jglove.select_train_step(jmodel, jcfg))
    tstep = tglove.select_train_step(tstate.params, tcfg)
    batches = jpipelines.glove_batches(shards, 16, shuffle_buffer=64, seed=1)
    for _ in range(5):
        (t1, t2), count = next(batches)
        jstate, jm = jstep(jstate, ((jnp.asarray(t1), jnp.asarray(t2)),
                                    jnp.asarray(count)))
        tstate, tm = tstep(tstate, tglove.to_device(((t1, t2), count),
                                                   torch.device("cpu")))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL)
    assert tstate.step == int(jstate.step) == 5
    _compare_states(tstate, jstate, optimizer)


def test_eval_step_and_knn_match_jax(shards):
    (jcfg, jmodel, jstate), (tcfg, tstate) = _step_states("adam")
    (t1, t2), count = next(jpipelines.glove_batches(shards, 16, seed=2))
    want = jglove.make_eval_step(jmodel)(jstate, ((jnp.asarray(t1),
                                                   jnp.asarray(t2)),
                                                  jnp.asarray(count)))
    got = tglove.make_eval_step(tstate.params)(
        tstate, tglove.to_device(((t1, t2), count), torch.device("cpu")))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-6)
    probes = np.array([1, 2, 15], np.int32)
    js, ji = jglove.knn(jstate, jnp.asarray(probes), k=5,
                        valid_rows=N_TOKENS + 1)
    ts, ti = tglove.knn(tstate, torch.from_numpy(probes), k=5,
                        valid_rows=N_TOKENS + 1)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-6, atol=1e-7)


def test_knn_ties_go_to_the_lower_row():
    (_, _, jstate), (_, tstate) = _step_states("adam")
    with torch.no_grad():
        emb = tstate.params.token_embedding.embedding
        emb[7] = emb[3]
        emb[9] = emb[3]
    jemb = jstate.params["token_embedding"]["embedding"]
    jemb = jemb.at[7].set(jemb[3]).at[9].set(jemb[3])
    jstate = jstate.replace(params={**jstate.params, "token_embedding": {
        "embedding": jemb}})
    probe = np.array([3], np.int32)
    _, want = jglove.knn(jstate, jnp.asarray(probe), k=6, valid_rows=21)
    _, got = tglove.knn(tstate, torch.from_numpy(probe), k=6, valid_rows=21)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the three equal rows tie: they come together, lowest row first
    pos = [list(got[0]).index(i) for i in (3, 7, 9)]
    assert pos == list(range(pos[0], pos[0] + 3)), got


# ------------------------------------------------------------ train() e2e

def _vocab(n=N_TOKENS):
    """A dictionary whose ranks 1..n are tokens t01..t20, so the probe
    terms are ``t02`` (cluster 1) and ``t15`` (cluster 2); with the mask
    and the minhash buckets its tables hold 65,557 rows (65,664 padded)."""
    return vocab.Vocabulary([vocab.VocabEntry(token=f"t{i:02d}",
                                              frequency=100 - i)
                             for i in range(1, n + 1)])


@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam"])
def test_train_end_to_end(shards, tmp_path, caplog, optimizer):
    dict_path = str(tmp_path / "dict.bz2")
    _vocab().save(dict_path)
    cfg = tglove.GloveConfig(
        train_pattern=shards, token_dictionary=dict_path,
        work_dir=str(tmp_path / "wd"), feature_size=8, batch_size=64,
        learning_rate=0.05, steps_per_epoch=30, num_epochs=10,
        shuffle_buffer_size=128, terms="t02,t15", optimizer=optimizer,
        eval_steps=2, checkpoint_every_epochs=5)
    with caplog.at_level(logging.INFO, logger="esrecsys_tpu_torch"):
        result = tglove.train(cfg, device="cpu")
    assert result.steps_run == 300 and result.state.step == 300
    first = float(tglove.make_eval_step(None)(
        tglove.init_state(cfg, VOCAB_ROWS, "cpu")[1],
        tglove.to_device(next(pipelines.glove_batches(shards, 64)),
                         torch.device("cpu")))["loss"])
    assert result.last_train_metrics["train_loss"] < 0.5 * first
    assert np.isfinite(result.last_eval_metrics["eval_loss"])
    knn_lines = [r.getMessage() for r in caplog.records
                 if r.getMessage().startswith("knn step=300 ")]
    assert len(knn_lines) == 2
    # among the dictionary's rows (the minhash buckets past them are
    # never trained here) t02's nearest non-self neighbours are in its
    # cluster
    _, idx = tglove.knn(result.state, torch.tensor([2]), k=3,
                        valid_rows=N_TOKENS + 1)
    neighbours = [i for i in idx[0].tolist() if i != 2][:2]
    assert any(1 <= i <= N_TOKENS // 2 for i in neighbours), idx
    assert Checkpointer(f"{cfg.work_dir}/checkpoints").all_steps() == [150,
                                                                       300]
    # the export loads in the JAX package's loader, with its metadata
    path = texport.latest_artifact(cfg.work_dir, "glove")
    jparams, _, meta = jexport.load_model(path)
    assert meta == {"name": "glove", "step": 300, "vocab_rows": VOCAB_ROWS,
                    "padded_rows": 65_664, "feature_size": 8,
                    "valid_rows": {"token_embedding": VOCAB_ROWS,
                                   "bias": VOCAB_ROWS}}
    np.testing.assert_array_equal(
        jparams["token_embedding"]["embedding"],
        result.state.params.token_embedding.embedding.detach().numpy())
    with open(f"{cfg.work_dir}/artifacts.jsonl") as f:
        assert json.loads(f.readline())["name"] == "glove-300"


def test_jax_glove_export_loads_in_the_port(shards, tmp_path):
    jcfg = jglove.GloveConfig(
        train_pattern=shards, work_dir=str(tmp_path / "jwd"), feature_size=8,
        batch_size=32, steps_per_epoch=4, num_epochs=1, terms="",
        shuffle_buffer_size=0, steps_per_call=1, eval_steps=1)
    jvoc = jvocab.Vocabulary([jvocab.VocabEntry(token=f"t{i:02d}")
                              for i in range(1, N_TOKENS + 1)])
    jglove.train(jcfg, vocab=jvoc)
    path = jexport.latest_artifact(jcfg.work_dir, "glove")
    params, _, meta = texport.load_model(path)
    model = tglove.Glove(meta["padded_rows"], meta["feature_size"],
                         valid_rows=meta["vocab_rows"], device="cpu")
    model.load_state_dict(params_from_jax(params))
    assert model.bias.embedding.shape == (65_664, 1)
    assert meta["valid_rows"] == {"token_embedding": VOCAB_ROWS,
                                  "bias": VOCAB_ROWS}
    assert float(model.bias.embedding.detach().abs().sum()) > 0


@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam"])
def test_checkpoint_resume_is_bit_exact(shards, tmp_path, optimizer):
    dict_path = str(tmp_path / "dict.bz2")
    _vocab().save(dict_path)
    base = dict(train_pattern=shards, token_dictionary=dict_path,
                feature_size=8, batch_size=32, learning_rate=0.05,
                steps_per_epoch=4, terms="t02", optimizer=optimizer,
                shuffle_buffer_size=64, eval_steps=1,
                checkpoint_every_epochs=1)
    half = tglove.train(tglove.GloveConfig(
        **base, num_epochs=2, work_dir=str(tmp_path / "b")), device="cpu")
    # a fresh template restores step 8 bit for bit
    ck = Checkpointer(str(tmp_path / "b" / "checkpoints"))
    cfg = tglove.GloveConfig(**base)
    _, fresh = tglove.init_state(cfg, VOCAB_ROWS, "cpu",
                                 torch.Generator().manual_seed(99))
    restored = ck.restore(fresh)
    assert restored.step == 8
    for name, t in half.state.params.state_dict().items():
        assert torch.equal(restored.params.state_dict()[name], t), name
    flat = lambda s: {f"{k}/{m}": v for k, d in s.opt_state.items()
                      for m, v in d.items()}
    for k, v in flat(half.state).items():
        assert torch.equal(flat(restored)[k], v), k
    # the run resumes from step 8 (its input stream restarts from its
    # seed, as the reference's does)
    resumed = tglove.train(tglove.GloveConfig(
        **base, num_epochs=4, work_dir=str(tmp_path / "b"), resume=True),
        device="cpu")
    assert resumed.state.step == 16 and resumed.steps_run == 8
    assert all(torch.isfinite(p).all()
               for p in resumed.state.params.parameters())


def test_glove_cli_runs_on_the_cpu(shards, tmp_path):
    dict_path = str(tmp_path / "dict.bz2")
    _vocab().save(dict_path)
    res = tglove.main(["--train_pattern", shards, "--token_dictionary",
                       dict_path, "--work_dir", str(tmp_path / "wd"),
                       "--feature_size", "4", "--batch_size", "16",
                       "--steps_per_epoch", "3", "--num_epochs", "1",
                       "--shuffle_buffer_size", "0", "--terms", "t02",
                       "--eval_steps", "1", "--optimizer", "lazy_adam",
                       "--device", "cpu"])
    assert res.state.step == 3
    assert texport.latest_artifact(str(tmp_path / "wd"), "glove")


def test_unported_options_raise(tmp_path):
    # sharded tables are ported: one process without torchrun's ranks
    # refuses them rather than training on one rank
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        tglove.train(tglove.GloveConfig(n_model_shards=2), device="cpu",
                     vocab=_vocab())
    with pytest.raises(ValueError, match="optimizer"):
        tglove.init_state(tglove.GloveConfig(optimizer="sgd"), 21, "cpu")


def test_glove_state_from_jax_needs_the_adam_count_at_the_step():
    (_, _, jstate), (tcfg, _) = _step_states("adam")
    tstate = glove_state_from_jax(jstate, tcfg, N_TOKENS + 1, device="cpu")
    assert tstate.step == 0 and not tstate.opt_state["bias"]["mu"].any()
    with pytest.raises(ValueError, match="count"):
        glove_state_from_jax(jstate.replace(step=jnp.int32(3)), tcfg,
                             N_TOKENS + 1, device="cpu")
