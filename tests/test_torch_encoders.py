"""The port's query encoders (``serving/encoders.py``) against the JAX
package's on the same artifacts, and the server's raw-query requests:
``POST /v1/topk`` with ``text`` and with ``image_key`` equals the
encoder plus a brute-force top-k (the JAX package's
``tests/test_serving.py`` text test), through the exact and the fused
service, a reload keeps the encoders, and the CLI's four flags build
them.

Sizes: a 4-word dictionary (plus its minhash buckets), 32 URLs, L=6,
8-wide; STL towers with filters (4, 8), output 8, 32 px images written by
the port's writer; an index of 40 rows.

Tolerances: embeddings within 1e-5 absolute (the same float32 towers,
their sums in another order); the served ids equal the brute force's
(fused_bins 64 over 40 rows holds every row's score, so the fused
service is exact here).
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorflow as tf  # noqa: F401  (the JAX image encoder decodes with it)
import torch

from esrecsys_tpu.data.vocab import VocabEntry, Vocabulary
from esrecsys_tpu.models.cnn import STLModel as JSTLModel
from esrecsys_tpu.models.txt2url import Txt2UrlModel as JTxt2UrlModel
from esrecsys_tpu.serving import encoders as jencoders
from esrecsys_tpu.train import export as jexport
from esrecsys_tpu_torch.data import jpeg
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
from esrecsys_tpu_torch.serving import encoders, server

L, D, URLS = 6, 8, 32
TEXTS = ["deep learning music", "cats", "Deep, deep CATS!", "", "unknown"
         " words only", "music " * 10]
ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """Tensors here are tiny: one intra-op thread, so that the test
    workers sharing the host do not oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def text_artifact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("t2u")
    vocab = Vocabulary([VocabEntry(token=t, frequency=10)
                        for t in ["deep", "learning", "music", "cats"]])
    vocab.save(str(tmp / "tok.json"))
    arts = {}
    for kind in ("mean", "lstm"):
        model = JTxt2UrlModel(word_vocab_size=vocab.num_embeddings,
                              url_vocab_size=URLS, word_dim=D, rnn_size=D,
                              url_dim=D, encoder_type=kind)
        params = model.init(
            jax.random.PRNGKey(1), jnp.zeros(2, jnp.int32),
            jnp.zeros((2, L), jnp.int32), jnp.zeros(2, jnp.int32),
            jnp.zeros(2, jnp.int32))["params"]
        arts[kind] = jexport.export_model(
            str(tmp / kind), "txt2url", params, step=1,
            metadata={"word_dim": D, "url_dim": D, "rnn_size": D,
                      "encoder_type": kind, "sentence_length": L})
    return arts, str(tmp / "tok.json")


@pytest.fixture(scope="module")
def image_artifact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stl")
    img_dir = tmp / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    keys = []
    for i in range(40):
        key = f"{i:02d}cc" + "0" * 28
        arr = rng.integers(0, 256, (30 + i % 5, 36 - i % 7, 3), np.uint8)
        (img_dir / f"{key}.jpg").write_bytes(jpeg.encode(
            arr, 85, "4:2:0" if i % 2 else "4:4:4"))
        keys.append(key)
    model = JSTLModel(output_size=D, filters=(4, 8))
    x = jnp.asarray(rng.normal(size=(4, 32, 32, 3)), jnp.float32)
    variables = model.init(jax.random.PRNGKey(2), x, x, x, True)
    _, upd = model.apply(variables, x, x + 0.5, x * 2, True,
                         mutable=["batch_stats"])
    art = jexport.export_model(
        str(tmp), "stl", variables["params"], step=2,
        batch_stats=upd["batch_stats"],
        metadata={"output_size": D, "image_size": 32, "filters": [4, 8]})
    return art, str(img_dir), keys


@pytest.mark.parametrize("kind", ["mean", "lstm"])
def test_text_encoder_matches_jax(text_artifact, kind):
    arts, tok = text_artifact
    want = jencoders.txt2url_text_encoder(arts[kind], tok)
    got = encoders.txt2url_text_encoder(arts[kind], tok, device="cpu")
    for text in TEXTS:
        g = got(text)
        assert g.shape == (D,) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(want(text)), rtol=0,
                                   atol=ATOL, err_msg=text)
    short = encoders.txt2url_text_encoder(arts[kind], tok,
                                          sentence_length=2, device="cpu")
    np.testing.assert_allclose(
        short("deep learning music"),
        np.asarray(jencoders.txt2url_text_encoder(arts[kind], tok, 2)(
            "deep learning music")), rtol=0, atol=ATOL)


@pytest.mark.parametrize("tower", ["scene", "product"])
def test_image_encoder_matches_jax(image_artifact, tower):
    art, img_dir, keys = image_artifact
    want = jencoders.stl_image_encoder(art, img_dir, tower=tower)
    got = encoders.stl_image_encoder(art, img_dir, tower=tower,
                                     device="cpu")
    for key in keys[:3]:
        np.testing.assert_allclose(got(key), np.asarray(want(key)), rtol=0,
                                   atol=ATOL, err_msg=key)
    sized = encoders.stl_image_encoder(art, img_dir, image_size=36,
                                       tower=tower, device="cpu")
    np.testing.assert_allclose(
        sized(keys[0]),
        np.asarray(jencoders.stl_image_encoder(art, img_dir, 36, tower)(
            keys[0])), rtol=0, atol=ATOL)
    with pytest.raises(FileNotFoundError):
        got("ff" * 16)
    with pytest.raises(ValueError, match="tower"):
        encoders.stl_image_encoder(art, img_dir, tower="both", device="cpu")


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("fused", [False, True], ids=["exact", "fused"])
def test_raw_queries_over_http(text_artifact, image_artifact, tmp_path,
                               fused):
    arts, tok = text_artifact
    art, img_dir, keys = image_artifact
    enc = {"text": encoders.txt2url_text_encoder(arts["lstm"], tok,
                                                 device="cpu"),
           "image_key": encoders.stl_image_encoder(art, img_dir,
                                                   tower="product",
                                                   device="cpu")}
    vecs = np.stack([enc["image_key"](k) for k in keys])
    path = str(tmp_path / "products.npz")
    EmbeddingIndex(keys, vecs).save(path)
    httpd = server.serve(path, port=0, max_k=10, max_batch=2, fused=fused,
                         fused_bins=64, encoders=enc, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/topk"
    try:
        for body, vec in (
                ({"text": "deep learning music", "k": 5},
                 enc["text"]("deep learning music")),
                ({"image_key": keys[7], "k": 5}, vecs[7])):
            got = _post(url, body)
            want = np.argsort(-(vecs @ vec), kind="stable")[:5]
            assert got["ids"] == [keys[i] for i in want], body
            np.testing.assert_allclose(got["scores"], (vecs @ vec)[want],
                                       rtol=0, atol=ATOL)
        # a missing image and an unregistered kind -> 400
        for body in ({"image_key": "ff" * 16}, {"audio": "x"}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url, body)
            assert ei.value.code == 400
        # a reload keeps the encoders
        httpd.reload_index(path)
        assert _post(url, {"text": "cats", "k": 2})["ids"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_cli_flags_build_the_encoders(text_artifact, image_artifact,
                                      tmp_path, monkeypatch):
    arts, tok = text_artifact
    art, img_dir, keys = image_artifact
    path = str(tmp_path / "i.npz")
    EmbeddingIndex(keys, np.eye(40, D, dtype=np.float32)).save(path)
    captured = {}

    class Ready:
        def serve_forever(self):
            captured["served"] = True

    def fake_serve(index, *args, **kw):
        captured.update(kw, index=index)
        return Ready()

    monkeypatch.setattr(server, "serve", fake_serve)
    server.main(["--index", path, "--device", "cpu",
                 "--txt2url_artifact", arts["mean"], "--token_dictionary",
                 tok, "--stl_artifact", art, "--image_dir", img_dir])
    assert captured["served"] and captured["index"] == path
    enc = captured["encoders"]
    assert sorted(enc) == ["image_key", "text"]
    np.testing.assert_allclose(
        enc["text"]("cats"),
        np.asarray(jencoders.txt2url_text_encoder(arts["mean"], tok)("cats")),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        enc["image_key"](keys[1]),
        np.asarray(jencoders.stl_image_encoder(art, img_dir)(keys[1])),
        rtol=0, atol=ATOL)
    server.main(["--index", path, "--device", "cpu"])
    assert captured["encoders"] == {}
