"""The Shop-the-Look pipeline of the port against the JAX package's: the
towers (``models/cnn.py``), the train and eval steps, ``init_state``'s
state through ``convert``, ``generate_triplets``, the image datasets,
artifacts both ways, ``train()``/``build_catalog_indexes``/``recommend``
and the CLI on the CPU, the HTML pages, ``random_recommender`` and
``fetch_images`` (against a local ``http.server`` only).

Sizes: 32 and 36 px images (both of flax's SAME-padding cases: (0, 1) at
even sizes, (1, 1) at odd ones), filters (4, 8), output 8, B=3-4. Inputs
from numpy seeds; params from the JAX ``init``/``init_state`` through
``convert``.

Tolerances: float32 towers within 1e-5 (absolute, outputs of order 1;
the same float32 convolutions and reductions in another order). bf16
towers: the port's and the reference's bf16 outputs are two roundings of
one float32 function, so they must agree within 3x the reference's own
distance from its float32 twin on the same input (the derived bound).
Running statistics after one pos-then-neg call within 1e-5 relative.
Three float32 train steps: losses within 1e-5 relative; parameters and
running variances within 1e-5 relative (and 1e-9 absolute), Adam moments
within 1e-5 of their tensor's largest magnitude (an element of a
gradient near cancellation carries float32 noise of the tensor's scale),
but for the biases of ``Conv_1`` ... ``Conv_3``, each followed by a
BatchNorm that subtracts its batch mean: their gradient is zero in exact
arithmetic, so in either package it is float32 noise, and Adam, dividing
by its root mean square, steps them by up to ``lr`` a step; they are held
to ``|b| <= steps * lr`` in both, their moments to noise level, and the
running means (which add those biases at 0.01 a running update) to
``0.01 * updates * 2 * steps * lr`` absolute. The eval step's metrics
within 1e-6. ``generate_triplets``, the unshuffled datasets, the HTML
pages and the random baseline's page are equal; artifacts give equal
embeddings (1e-5) in both directions.
"""

import http.server
import json
import os
import re
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorflow as tf
import torch

from esrecsys_tpu.data import images as jimages
from esrecsys_tpu.models.cnn import STLModel as JSTLModel
from esrecsys_tpu.retrieval import html as jhtml
from esrecsys_tpu.tools import random_recommender as jrandom
from esrecsys_tpu.train import export as jexport
from esrecsys_tpu.workloads import stl as jstl
from esrecsys_tpu_torch import convert
from esrecsys_tpu_torch.data import images, jpeg
from esrecsys_tpu_torch.etl import fetch_images
from esrecsys_tpu_torch.models import cnn
from esrecsys_tpu_torch.retrieval import html
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
from esrecsys_tpu_torch.tools import random_recommender
from esrecsys_tpu_torch.train import export as texport
from esrecsys_tpu_torch.train.checkpoint import Checkpointer
from esrecsys_tpu_torch.workloads import stl

SMALL = dict(output_size=8, filters=(4, 8))


@pytest.fixture(autouse=True)
def one_thread():
    """Tensors here are tiny: one intra-op thread, so that the test
    workers sharing the host do not oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
ATOL = 1e-5
STEPS = 3
LR = 1e-4


def images_np(n, size, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, size, size, 3)) * 0.3 + 0.1
             ).astype(np.float32) for _ in range(3)]


def jax_model(dtype=jnp.float32, size=32, seed=0):
    model = JSTLModel(dtype=dtype, **SMALL)
    x = images_np(3, size, seed)
    variables = model.init(jax.random.PRNGKey(seed), *x, True)
    return model, variables, x


def port_model(variables, dtype=torch.float32):
    return convert.stl_model_from_jax(
        variables["params"], variables["batch_stats"], SMALL["output_size"],
        SMALL["filters"], dtype, device="cpu")


def outputs_np(out):
    return [np.asarray(o, np.float32) if not isinstance(o, torch.Tensor)
            else o.detach().float().numpy() for o in out]


# ---------------------------------------------------------------- towers

@pytest.mark.parametrize("size", [32, 36])
@pytest.mark.parametrize("train", [True, False])
def test_float32_towers_match(size, train):
    model, variables, x = jax_model(size=size, seed=size)
    want = model.apply(variables, *x, train, mutable=["batch_stats"])[0] \
        if train else model.apply(variables, *x, False)
    got = port_model(variables)(*map(torch.from_numpy, x), train)
    for w, g in zip(outputs_np(want), outputs_np(got)):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("size", [32, 36])
@pytest.mark.parametrize("train", [True, False])
def test_bf16_towers_within_derived_bound(size, train):
    model16, variables, x = jax_model(jnp.bfloat16, size, seed=size + 1)
    model32 = JSTLModel(**SMALL)

    def run(m):
        if train:
            return outputs_np(m.apply(variables, *x, True,
                                      mutable=["batch_stats"])[0])
        return outputs_np(m.apply(variables, *x, False))

    want16, want32 = run(model16), run(model32)
    got = outputs_np(port_model(variables, torch.bfloat16)(
        *map(torch.from_numpy, x), train))
    for g, w16, w32 in zip(got, want16, want32):
        bound = 3 * np.abs(w16 - w32).max()
        assert 0 < bound < 0.1
        assert np.abs(g - w16).max() <= bound, (np.abs(g - w16).max(), bound)


def test_running_statistics_after_one_call():
    """One training call updates the scene tower's statistics once and
    the product tower's twice, pos first, as flax does."""
    model, variables, x = jax_model(size=36, seed=3)
    _, upd = model.apply(variables, *x, True, mutable=["batch_stats"])
    pm = port_model(variables)
    pm(*map(torch.from_numpy, x), True)
    _, stats = convert.stl_params_to_jax(pm)
    want = jax.tree_util.tree_leaves_with_path(upd["batch_stats"])
    got = dict(jax.tree_util.tree_leaves_with_path(stats))
    assert len(want) == len(got) == 2 * 2 * 3 * 2
    for path, w in want:
        np.testing.assert_allclose(got[path], np.asarray(w), rtol=1e-5,
                                   atol=1e-7, err_msg=str(path))
    # the product tower moved twice: a concatenated 2B batch would not match
    two = pm.product_tower.ResidualStage_0.BatchNorm_0.mean
    one = pm.scene_tower.ResidualStage_0.BatchNorm_0.mean
    assert not torch.equal(two, one)


def test_same_padding_and_pool():
    assert cnn.same_pads(32, 3, 2) == (0, 1)
    assert cnn.same_pads(33, 3, 2) == (1, 1)
    assert cnn.same_pads(8, 1, 1) == (0, 0)
    x = torch.ones(1, 1, 4, 4)
    pooled = torch.nn.functional.avg_pool2d(cnn.pad_same(x, 3, 2), 3, 2)
    # the padded zeros count: the corner window holds 4 ones of 9
    np.testing.assert_allclose(pooled[0, 0].numpy(),
                               [[1.0, 6 / 9], [6 / 9, 4 / 9]], rtol=1e-6)


def test_float32_tower_on_a_card_needs_tf32_off():
    t = torch.zeros(1)
    cnn._require_full_f32(t, conv=True)  # a CPU tensor: nothing to check


# ----------------------------------------------------------- train steps

CFG = dict(image_size=32, batch_size=4, use_bf16=False, learning_rate=LR,
           **SMALL)


def _dead_bias(name: str) -> bool:
    return re.search(r"Conv_[123]\.bias$", name) is not None


def test_three_train_steps_and_eval_match_jax():
    jcfg, tcfg = jstl.STLConfig(**CFG), stl.STLConfig(**CFG)
    _, js = jstl.init_state(jcfg)
    ts = convert.stl_state_from_jax(js, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    jstep = jax.jit(jstl.make_train_step(jcfg))
    tstep = stl.make_train_step(ts.params, tcfg)
    for _ in range(STEPS):
        batch = tuple((rng.normal(size=(4, 32, 32, 3)) * 0.3
                       ).astype(np.float32) for _ in range(3))
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, tuple(map(torch.from_numpy, batch)))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert ts.step == int(js.step) == STEPS
    want = convert.stl_state_dict_from_jax(js.params, js.batch_stats)
    got = ts.params.state_dict()
    assert set(want) == set(got)
    dead_bound = STEPS * LR * (1 + 1e-3)
    updates = 2 * STEPS  # the product tower's running updates
    mean_bound = 0.01 * updates * 2 * dead_bound
    for name, w in want.items():
        w, g = w.numpy(), got[name].numpy()
        if _dead_bias(name):
            assert np.abs(w).max() <= dead_bound and \
                np.abs(g).max() <= dead_bound, name
        elif name.endswith(".mean"):
            np.testing.assert_allclose(g, w, rtol=0, atol=mean_bound,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-9,
                                       err_msg=name)
    _, mu, nu = convert._optax_adam(js.opt_state)
    biggest = max(float(np.abs(np.asarray(m)).max())
                  for m in jax.tree_util.tree_leaves(mu))
    for key, tree in (("mu", mu), ("nu", nu)):
        for name, w in convert.params_from_jax(tree).items():
            w = convert._stl_leaf_to_torch(name, w.numpy())
            g = ts.opt_state[key][name].numpy()
            if _dead_bias(name):
                if key == "mu":  # float32 noise against the real moments
                    assert np.abs(w).max() < 1e-3 * biggest
                    assert np.abs(g).max() < 1e-3 * biggest
                continue
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-5 * np.abs(w).max(),
                err_msg=f"{key} {name}")

    # the eval step from one state (the reference's after the steps)
    ts2 = convert.stl_state_from_jax(js, tcfg, device="cpu")
    batch = tuple((rng.normal(size=(4, 32, 32, 3)) * 0.3).astype(np.float32)
                  for _ in range(3))
    jeval = jstl.make_eval_step(jcfg)(js, batch)
    teval = stl.make_eval_step(ts2.params, tcfg)(
        ts2, tuple(map(torch.from_numpy, batch)))
    assert set(jeval) == set(teval)
    for k in jeval:
        np.testing.assert_allclose(float(teval[k]), float(jeval[k]),
                                   rtol=1e-6, atol=1e-6)


def test_init_state_and_checkpoint_round_trip(tmp_path):
    cfg = stl.STLConfig(**CFG)
    model, state = stl.init_state(cfg, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert set(state.opt_state["mu"]) == set(names)
    # lecun_normal: the stride-2 conv's std is sqrt(1 / (3 * 3 * 3))
    k = model.scene_tower.ResidualStage_0.Conv_1.kernel
    assert abs(float(k.detach().std()) - (1 / 27) ** 0.5) < 0.1
    step = stl.make_train_step(model, cfg)
    batch = tuple(map(torch.from_numpy, images_np(4, 32, 5)))
    state, _ = step(state, batch)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(state.step, state)
    _, fresh = stl.init_state(dataclass_replace(cfg, seed=9), device="cpu")
    ckpt.restore(fresh)
    for (n, a), (_, b) in zip(state.params.state_dict().items(),
                              fresh.params.state_dict().items()):
        assert torch.equal(a, b), n
    for key in ("mu", "nu"):
        for n in names:
            assert torch.equal(state.opt_state[key][n],
                               fresh.opt_state[key][n])


def dataclass_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


def test_generate_triplets_equal():
    pairs = [(f"s{i}", f"p{i}") for i in range(37)]
    for seed in (0, 3):
        assert stl.generate_triplets(pairs, 5, seed) == \
            jstl.generate_triplets(pairs, 5, seed)


# ------------------------------------------------------------- artifacts

def test_artifacts_cross_both_ways(tmp_path):
    model, variables, x = jax_model(size=32, seed=7)
    _, upd = model.apply(variables, *x, True, mutable=["batch_stats"])
    meta = {"output_size": 8, "image_size": 32, "filters": [4, 8]}
    jpath = jexport.export_model(str(tmp_path / "j"), "stl",
                                 variables["params"], step=3,
                                 batch_stats=upd["batch_stats"],
                                 metadata=meta)
    pm, pmeta = convert.stl_model_from_artifact(jpath, device="cpu")
    assert pmeta["filters"] == [4, 8]
    jv = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
    for method, tower in ((JSTLModel.get_scene_embed, pm.scene_embed),
                          (JSTLModel.get_product_embed, pm.product_embed)):
        want = np.asarray(model.apply(jv, x[0], method=method))
        np.testing.assert_allclose(tower(torch.from_numpy(x[0])).detach()
                                   .numpy(), want, rtol=0, atol=ATOL)
    # the port's export, read by the JAX package
    params, stats = convert.stl_params_to_jax(pm)
    tpath = texport.export_model(str(tmp_path / "t"), "stl", params, step=3,
                                 batch_stats=stats, metadata=meta)
    jparams, jstats, jmeta = jexport.load_model(tpath)
    assert jmeta["output_size"] == 8
    want = np.asarray(model.apply({"params": jparams, "batch_stats": jstats},
                                  x[1], method=JSTLModel.get_product_embed))
    np.testing.assert_allclose(pm.product_embed(torch.from_numpy(x[1]))
                               .detach().numpy(), want, rtol=0, atol=ATOL)
    flat_j = dict(np.load(jpath))
    flat_t = dict(np.load(tpath))
    assert set(flat_j) == set(flat_t)
    for k in flat_j:
        if k != "__meta__":
            assert flat_j[k].shape == flat_t[k].shape, k


# ------------------------------------------------------- corpus and data

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """20 scene/product pairs of class-coloured 32-40 px JPEGs written by
    the port's writer, and one pair whose product image is missing."""
    tmp = tmp_path_factory.mktemp("stl")
    img_dir = tmp / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    pairs, rows = [], []
    for i in range(20):
        scene, product = f"{i:02d}aa" + "0" * 28, f"{i:02d}bb" + "0" * 28
        for key, bright in ((scene, 180), (product, 200)):
            h, w = 32 + (i % 3) * 4, 40 - (i % 2) * 8
            arr = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
            arr[:, :, i % 3] = bright
            (img_dir / f"{key}.jpg").write_bytes(
                jpeg.encode(arr, 90, "4:4:4" if i % 2 else "4:2:0"))
        pairs.append((scene, product))
        rows.append(json.dumps({"scene": scene, "product": product}))
    rows.append(json.dumps({"scene": pairs[0][0], "product": "ff" * 16}))
    stl_json = tmp / "pairs.json"
    stl_json.write_text("\n".join(rows))
    return str(stl_json), str(img_dir), pairs


def test_pairs_and_keys(corpus, tmp_path):
    stl_json, img_dir, pairs = corpus
    loaded = images.load_scene_product_pairs(stl_json)
    assert loaded == jimages.load_scene_product_pairs(stl_json)
    assert images.valid_scene_product(loaded, img_dir) == \
        jimages.valid_scene_product(loaded, img_dir) == pairs
    as_list = tmp_path / "pairs_list.json"
    as_list.write_text(json.dumps([{"scene": s, "product": p}
                                   for s, p in pairs]))
    assert images.load_scene_product_pairs(str(as_list)) == pairs
    key = "abcdef" + "0" * 26
    assert images.key_to_url(key) == jimages.key_to_url(key)
    assert images.key_to_filename(key, "d") == jimages.key_to_filename(key, "d")


def test_triplet_dataset_unshuffled_equals_reference(corpus):
    _, img_dir, pairs = corpus
    trips, _ = stl.generate_triplets(pairs, 2, seed=1)
    trips = trips[:7]
    want = jimages.triplet_image_dataset(trips, img_dir, 3, 32,
                                         repeat=True, shuffle=False)
    got = images.triplet_image_dataset(trips, img_dir, 3, 32, repeat=True,
                                       shuffle=False)
    for _ in range(4):  # past the end: the repeat wraps
        for w, g in zip(next(want), next(got)):
            assert g.dtype == np.float32 and g.shape == (3, 32, 32, 3)
            np.testing.assert_array_equal(g, w)
    once = list(images.triplet_image_dataset(trips, img_dir, 3, 32,
                                             repeat=False, shuffle=False))
    assert len(once) == 2  # 7 triplets: the remainder is dropped
    shuffled = images.triplet_image_dataset(trips, img_dir, 3, 32, seed=4)
    batch = next(shuffled)
    assert all(-0.5 <= b.min() and b.max() <= 0.5 for b in batch)


def test_keyed_dataset_tail(corpus):
    _, img_dir, pairs = corpus
    keys = [s for s, _ in pairs][:5]
    want = list(jimages.keyed_image_dataset(keys, img_dir, 2, 36))
    got = list(images.keyed_image_dataset(keys, img_dir, 2, 36))
    assert [v for _, _, v in got] == [v for _, _, v in want] == [2, 2, 1]
    for (wk, wi, _), (gk, gi, _) in zip(want, got):
        assert wk == gk
        np.testing.assert_array_equal(gi, wi)


# ----------------------------------------------------------- end to end

def e2e_cfg(corpus, work_dir, **kw):
    stl_json, img_dir, _ = corpus
    fields = dict(stl_json=stl_json, image_dir=img_dir, work_dir=work_dir,
                  image_size=32, output_size=8, filters=(4, 8), batch_size=4,
                  num_negatives=2, learning_rate=3e-3, max_steps=10,
                  log_every_steps=5, eval_every_steps=5, eval_steps=2,
                  checkpoint_every_steps=5, use_bf16=False, top_k=3,
                  max_results=5)
    fields.update(kw)
    return fields


def test_train_index_recommend_end_to_end(corpus, tmp_path):
    """``train()``, ``build_catalog_indexes`` and ``recommend`` on the
    CPU (the JAX package's ``test_stl.py`` e2e); the top-k of ``recommend``
    equals the JAX ``recommend``'s over the same indexes."""
    fields = e2e_cfg(corpus, str(tmp_path / "wd"))
    cfg = stl.STLConfig(**fields)
    result = stl.train(cfg, device="cpu")
    assert result.steps_run == 10
    assert np.isfinite(result.last_train_metrics["train_loss"])
    assert set(result.last_eval_metrics) == {"eval_loss",
                                             "eval_triplet_accuracy"}
    stats = [b for n, b in result.state.params.named_buffers()
             if n.endswith(".mean")]
    assert any(float(s.abs().max()) > 0 for s in stats)
    artifact = texport.latest_artifact(cfg.work_dir, "stl")
    assert artifact.endswith("stl-00000010.npz")
    _, _, meta = jexport.load_model(artifact)
    assert meta["output_size"] == 8 and meta["filters"] == [4, 8]

    paths = stl.build_catalog_indexes(cfg, device="cpu")  # the artifact
    scene_idx = EmbeddingIndex.load(paths["scene"])
    product_idx = EmbeddingIndex.load(paths["product"])
    assert len(scene_idx) == 20 and len(product_idx) == 20
    # the indexes hold the trained towers' running-statistics embeddings
    with torch.no_grad():
        one = result.state.params.scene_embed(torch.from_numpy(
            images.decode_image(images.key_to_filename(
                scene_idx.ids[3], cfg.image_dir), 32)[None]))
    np.testing.assert_allclose(scene_idx.vectors[3], one[0].numpy(),
                               rtol=0, atol=1e-6)

    pages_dir = stl.recommend(cfg, device="cpu")
    jcfg = jstl.STLConfig(**{**fields, "work_dir": str(tmp_path / "jwd"),
                             "index_out": cfg.work_dir})
    jpages = jstl.recommend(jcfg)
    names = sorted(os.listdir(pages_dir))
    assert names == sorted(os.listdir(jpages)) and len(names) == 5
    row = re.compile(r"<td>([0-9a-f]+)</td><td>(-?[0-9.]+)</td>")
    for name in names:
        got = row.findall(open(os.path.join(pages_dir, name)).read())
        want = row.findall(open(os.path.join(jpages, name)).read())
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([float(s) for _, s in got],
                                   [float(s) for _, s in want], atol=2e-4)
        assert "i.pinimg.com" in open(os.path.join(pages_dir, name)).read()


def test_resume_and_cli(corpus, tmp_path):
    """The CLI's three modes in turn, and a resumed run that continues
    from the latest checkpoint."""
    fields = e2e_cfg(corpus, str(tmp_path / "wd"), max_steps=5)
    flags = []
    for k, v in fields.items():
        flags += [f"--{k}", ",".join(map(str, v)) if isinstance(v, tuple)
                  else str(v)]
    result = stl.main(flags + ["--mode", "train", "--device", "cpu"])
    assert result.steps_run == 5
    resumed = stl.main(flags + ["--mode", "train", "--device", "cpu",
                                "--max_steps", "8", "--resume", "true"])
    assert resumed.steps_run == 3 and resumed.state.step == 8
    paths = stl.main(flags + ["--mode", "index", "--device", "cpu"])
    assert set(paths) == {"scene", "product"}
    pages = stl.main(flags + ["--mode", "recommend", "--device", "cpu"])
    assert len(os.listdir(pages)) == 5
    with pytest.raises(SystemExit):
        stl.main(flags + ["--mode", "nope", "--device", "cpu"])


def test_index_from_the_latest_checkpoint(corpus, tmp_path):
    """Without an artifact, ``build_catalog_indexes`` restores the latest
    checkpoint, as the reference does."""
    cfg = stl.STLConfig(**e2e_cfg(corpus, str(tmp_path / "wd"),
                                  max_steps=2))
    result = stl.train(cfg, device="cpu")
    os.remove(texport.latest_artifact(cfg.work_dir, "stl"))
    model = stl.load_model(cfg, device="cpu")
    for (n, a), (_, b) in zip(result.state.params.state_dict().items(),
                              model.state_dict().items()):
        assert torch.equal(a, b), n
    paths = stl.build_catalog_indexes(cfg, device="cpu")
    assert len(EmbeddingIndex.load(paths["product"])) == 20


# ------------------------------------------------------- pages and tools

def test_html_pages_equal(tmp_path):
    results = [("s<1>", [("a&b", 0.5), ("c", -1.25)]),
               ("s2" * 20, [("d", 3.0)]), ("s3", [])]
    url = lambda k: f"http://x/{k}?q=1&r=2"  # noqa: E731
    assert html.render_results_page(*results[0], url, title="T<>") == \
        jhtml.render_results_page(*results[0], url, title="T<>")
    n = html.save_results_pages(str(tmp_path / "t"), iter(results), url, 2)
    jn = jhtml.save_results_pages(str(tmp_path / "j"), iter(results), url, 2)
    assert n == jn == 2
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


def test_random_recommender_page_equal(corpus, tmp_path):
    stl_json, _, _ = corpus
    for seed in (0, 5):
        argv = ["--stl_json", stl_json, "--num_items", "7", "--seed",
                str(seed)]
        random_recommender.main(argv + ["--output_html",
                                        str(tmp_path / "t.html")])
        jrandom.main(argv + ["--output_html", str(tmp_path / "j.html")])
        assert (tmp_path / "t.html").read_bytes() == \
            (tmp_path / "j.html").read_bytes()


class _Images(http.server.SimpleHTTPRequestHandler):
    """Serves ``<dir>/<key>.jpg`` at ``/400x/ab/cd/ef/<key>.jpg``; the keys
    in ``flaky`` fail their first two requests."""

    flaky = {}

    def translate_path(self, path):
        return os.path.join(self.directory, os.path.basename(path))

    def do_GET(self):
        key = os.path.basename(self.path)
        left = self.flaky.get(key, 0)
        if left:
            self.flaky[key] = left - 1
            self.send_error(503)
            return
        super().do_GET()

    def log_message(self, *args):
        pass


def test_fetch_images_against_a_local_server(corpus, tmp_path, monkeypatch):
    """Dedupe, skip what exists, retry with backoff, give up after
    ``max_retries``; every URL points at a local ``http.server``."""
    stl_json, img_dir, pairs = corpus
    handler = partial(_Images, directory=img_dir)
    _Images.flaky = {pairs[1][1] + ".jpg": 2}
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    seen = []
    cdn_url = images.key_to_url

    def local_url(key):
        url = cdn_url(key).replace("http://i.pinimg.com",
                                             f"http://127.0.0.1:{port}")
        seen.append(key)
        return url

    monkeypatch.setattr(fetch_images.images_lib, "key_to_url", local_url)
    out = tmp_path / "fetched"
    out.mkdir()
    (out / f"{pairs[0][0]}.jpg").write_bytes(b"x")  # resume: skipped
    try:
        stats = fetch_images.fetch_all(fetch_images.FetchConfig(
            stl_json=stl_json, image_dir=str(out), max_retries=3,
            backoff_seconds=0.0, sleep_seconds=0.0, sleep_every=7))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    keys = fetch_images.unique_keys(stl_json)
    assert len(keys) == 41 and len(set(keys)) == 41
    # 40 images served, the missing "ff..." product given up on
    assert stats == {"ok": 40, "failed": 1}
    assert pairs[0][0] not in seen
    assert seen.count(pairs[1][1]) == 1  # one URL, three attempts
    for s, p in pairs[1:]:
        for key in (s, p):
            assert (out / f"{key}.jpg").read_bytes() == \
                open(images.key_to_filename(key, img_dir), "rb").read()
