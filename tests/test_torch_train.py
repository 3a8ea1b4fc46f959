"""Playlist scoring, loss and train steps in the port against the JAX
package.

Params come from the JAX ``init_state`` and are carried over with
``convert.state_from_jax``; batches are numpy draws given to both sides;
the port's steps take the negative ids that the JAX step draws from its
key (``core/prng.key_for_step``), since threefry cannot be replayed in
torch.

Tolerances: scores, losses and gradients within 1e-5 relative and 1e-6
absolute (float32 sums of width <= 16 in another order; bf16 inputs are
rounded identically on both sides and their products are exact). Train
trajectories within 1e-5 relative and 1e-6 absolute after 5 steps: each
step adds float32 rounding of duplicate-row sums taken in another order.
The momentum trajectories run in float32 scoring: with bf16 scoring a
one-ulp float32 difference in a table value can flip the bf16 rounding of
that value, which moves one gradient element by a bf16 ulp (2^-8
relative) and the momentum carries it on (measured: one element of 512
off by 1.2e-4 after 5 steps). bf16 scoring is compared at momentum 0, and
its gradients, rounding included, in the tied-maxima test.
The port's sparse step against its own dense step: 2e-5 relative, 1e-7
absolute at momentum 0, 1e-4 / 1e-6 with momentum (the bounds of
``tests/test_playlist.py:455`` and ``:549``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.core import prng
from esrecsys_tpu.ops import negatives as jneg
from esrecsys_tpu.workloads import playlist as jpl
from esrecsys_tpu_torch.convert import state_from_jax
from esrecsys_tpu_torch.ops import negatives as tneg
from esrecsys_tpu_torch.ops.losses import relu
from esrecsys_tpu_torch.workloads import playlist as tpl

RTOL, ATOL = 1e-5, 1e-6
BASE = dict(feature_size=4, album_hash_buckets=50, num_artists=40,
            num_negatives=6, batch_size=3, context_size=3, max_next=4,
            learning_rate=0.05)
TABLES = ("album_embed", "artist_embed")


def _cfgs(**kw):
    fields = {**BASE, **kw}
    return jpl.PlaylistConfig(**fields), tpl.PlaylistConfig(**fields)


def _corpus(rng, n=32):
    c = {"tracks": rng.integers(0, 100, n).astype(np.int32),
         "albums": rng.integers(0, 150, n).astype(np.int32),
         "artists": rng.integers(0, 40, n).astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in c.items()},
            {k: torch.from_numpy(v) for k, v in c.items()})


def _batch(rng, b, c, m, pad_mask=True):
    ri = lambda hi, *s: rng.integers(0, hi, s).astype(np.int32)
    mask = (rng.integers(0, 2, (b, m)).astype(np.float32) if pad_mask
            else np.ones((b, m), np.float32))
    mask[:, 0] = 1.0
    nb = {"track_context": ri(100, b, c), "album_context": ri(150, b, c),
          "artist_context": ri(40, b, c), "next_track": ri(100, b, m),
          "next_album": ri(150, b, m), "next_artist": ri(40, b, m),
          "next_mask": mask}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _negs(rng, b, n, shared):
    shape = (n,) if shared else (b, n)
    return (rng.integers(0, 150, shape).astype(np.int32),
            rng.integers(0, 40, shape).astype(np.int32))


def _models(compute_dtype="float32", seed=3):
    jcfg, tcfg = _cfgs(compute_dtype=compute_dtype, seed=seed, momentum=0.0,
                       sparse_updates=True)
    jmodel, jstate = jpl.init_state(jcfg, mesh=None)
    tstate = state_from_jax(jstate, tcfg, device="cpu")
    return jmodel, jstate.params, tstate.params


def _args(jb, tb, neg_alb, neg_art):
    keys = ("track_context", "album_context", "artist_context",
            "next_track", "next_album", "next_artist")
    jargs = [jb[k] for k in keys] + [jnp.zeros(neg_alb.shape, jnp.int32),
                                      jnp.asarray(neg_alb),
                                      jnp.asarray(neg_art)]
    targs = [tb[k] for k in keys] + [torch.zeros(neg_alb.shape,
                                                 dtype=torch.int32),
                                     torch.from_numpy(neg_alb),
                                     torch.from_numpy(neg_art)]
    return jargs, targs


def _close(t, j, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [False, True])
def test_scores_and_loss_match_jax(compute_dtype, shared):
    jmodel, params, tmodel = _models(compute_dtype)
    rng = np.random.default_rng(1)
    jb, tb = _batch(rng, 3, 3, 4)
    jargs, targs = _args(jb, tb, *_negs(rng, 3, 6, shared))
    jres = jmodel.apply({"params": params}, *jargs)
    with torch.no_grad():
        tres = tmodel(*targs)
    for i, name in enumerate(("pos", "neg", "ctx_self", "next_self",
                              "neg_self")):
        _close(tres[i], jres[i], msg=name)
    if shared:
        _close(tres[5][0], jres[5][0])
        _close(tres[5][1], jres[5][1])
    else:
        _close(tres[5], jres[5])
    jl = jpl.playlist_loss(jres, jb["next_mask"], 0.5)
    tl = tpl.playlist_loss(tres, tb["next_mask"], 0.5)
    assert set(tl) == set(jl)
    for k in jl:
        _close(tl[k], jl[k], msg=k)


def test_loss_closed_form_full_mask():
    """B=1, full mask: the batched loss equals the reference's closed form
    (``tests/test_playlist.py:98``)."""
    _, _, tmodel = _models()
    rng = np.random.default_rng(2)
    _, tb = _batch(rng, 1, 3, 4, pad_mask=False)
    _, targs = _args({k: None for k in tb}, tb, *_negs(rng, 1, 5, False))
    with torch.no_grad():
        res = tmodel(*targs)
    pos, neg, ctx_s, next_s, neg_s, l2 = [x[0].numpy() for x in res]
    r = lambda x: np.maximum(x, 0)
    want = (r(1.0 + neg.max() - pos.min()) + r(1.0 + neg.mean() - pos.mean())
            + r(l2 - 0.5).sum() + r(0.5 - ctx_s).mean()
            + r(0.5 - next_s).mean() + r(neg_s).mean())
    got = float(tpl.playlist_loss(res, torch.ones(1, 4), 0.5)["loss"])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_loss_mask_ignores_padding():
    """Padded next rows must not change the loss (``:114``)."""
    _, _, tmodel = _models()
    rng = np.random.default_rng(3)
    _, tb = _batch(rng, 1, 3, 6)
    mask = torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0, 0.0]])
    negs = _negs(rng, 1, 5, False)
    losses = []
    for fill in (0, 17):
        b = dict(tb)
        for k in ("next_track", "next_album", "next_artist"):
            b[k] = b[k].clone()
            b[k][:, 3:] = fill
        _, targs = _args({k: None for k in b}, b, *negs)
        with torch.no_grad():
            losses.append(float(tpl.playlist_loss(tmodel(*targs), mask,
                                                  0.5)["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_gradients_with_tied_maxima_match_jax(compute_dtype):
    """Context slots 0 and 1 are one track (equal vectors), so the max
    over slots ties for every item, and two negatives are one track, so
    max(neg) can tie: the gradient must split among ties as JAX's does
    (``amax``), and through bf16 scoring it must round like JAX's."""
    jmodel, params, tmodel = _models(compute_dtype, seed=4)
    rng = np.random.default_rng(5)
    jb, tb = _batch(rng, 3, 3, 4)
    ac = np.asarray(jb["album_context"]).copy()
    rc = np.asarray(jb["artist_context"]).copy()
    ac[:, 1], rc[:, 1] = ac[:, 0], rc[:, 0]
    jb["album_context"], jb["artist_context"] = jnp.asarray(ac), jnp.asarray(rc)
    tb["album_context"], tb["artist_context"] = (torch.from_numpy(ac),
                                                 torch.from_numpy(rc))
    neg_alb, neg_art = _negs(rng, 3, 6, True)
    neg_alb[1], neg_art[1] = neg_alb[0], neg_art[0]
    jargs, targs = _args(jb, tb, neg_alb, neg_art)

    def jloss(p):
        return jpl.playlist_loss(jmodel.apply({"params": p}, *jargs),
                                 jb["next_mask"], 0.5)["loss"]

    jgrad = jax.grad(jloss)(params)
    loss = tpl.playlist_loss(tmodel(*targs), tb["next_mask"], 0.5)["loss"]
    loss.backward()
    for name in TABLES:
        _close(getattr(tmodel, name).embedding.grad,
               jgrad[name]["embedding"], atol=1e-7, msg=name)


def test_relu_splits_the_gradient_at_zero():
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    relu(x).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.maximum(v, 0)))(
        jnp.array([-1.0, 0.0, 2.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad.tolist() == [0.0, 0.5, 1.0]


def _jax_negs(cfg, base_key, step, corpus_size, b):
    key = prng.key_for_step(base_key, step, prng.STREAM_NEGATIVES)
    return np.asarray(jneg.sample_negative_ids(
        key, cfg.num_negatives, corpus_size,
        None if cfg.shared_negatives else b,
        exact_range=cfg.exact_negative_range))


@pytest.mark.parametrize("momentum,shared,compute_dtype", [
    (0.0, True, "bfloat16"), (0.0, False, "float32"),
    (0.98, True, "float32"), (0.98, False, "float32")])
def test_sparse_step_trajectory_matches_jax(momentum, shared, compute_dtype):
    jcfg, tcfg = _cfgs(momentum=momentum, shared_negatives=shared,
                       sparse_updates=True, compute_dtype=compute_dtype,
                       momentum_carrier="dense" if momentum else "auto")
    jmodel, jstate = jpl.init_state(jcfg, mesh=None)
    tstate = state_from_jax(jstate, tcfg, device="cpu")
    rng = np.random.default_rng(11)
    jcorpus, tcorpus = _corpus(rng)
    base_key = jax.random.PRNGKey(7)
    jstep = jax.jit(jpl.make_sparse_train_step(jmodel, jcfg, jcorpus,
                                               base_key))
    tstep = tpl.make_sparse_train_step(tstate.params, tcfg, tcorpus)
    for i in range(5):
        jb, tb = _batch(np.random.default_rng(100 + i), 3, 3, 4)
        negs = torch.from_numpy(_jax_negs(jcfg, base_key, i, 32, 3).copy())
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb, neg_ids=negs)
        _close(tm["loss"], jm["loss"], msg=f"loss, step {i}")
    assert tstate.step == int(jstate.step) == 5
    for name in TABLES:
        _close(getattr(tstate.params, name).embedding,
               jstate.params[name]["embedding"], msg=name)
    if momentum:
        for t in ("album", "artist"):
            _close(tstate.opt_state[t]["momentum"],
                   jstate.opt_state[t]["momentum"], msg=f"momentum {t}")


def test_dense_step_trajectory_matches_jax():
    """The dense step (autograd through the lookups, torch SGD momentum)
    against the JAX dense step (optax SGD momentum)."""
    jcfg, tcfg = _cfgs(momentum=0.98, shared_negatives=True,
                       compute_dtype="bfloat16")
    jmodel, jstate = jpl.init_state(jcfg, mesh=None)
    tstate = state_from_jax(jstate, tcfg, device="cpu")
    rng = np.random.default_rng(12)
    jcorpus, tcorpus = _corpus(rng)
    base_key = jax.random.PRNGKey(8)
    jstep = jax.jit(jpl.make_train_step(jmodel, jcfg, jcorpus, base_key))
    tstep = tpl.make_train_step(tstate.params, tcfg, tcorpus)
    for i in range(3):
        jb, tb = _batch(np.random.default_rng(200 + i), 3, 3, 4)
        negs = torch.from_numpy(_jax_negs(jcfg, base_key, i, 32, 3).copy())
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb, neg_ids=negs)
        _close(tm["loss"], jm["loss"], msg=f"loss, step {i}")
    for name in TABLES:
        _close(getattr(tstate.params, name).embedding,
               jstate.params[name]["embedding"], msg=name)


@pytest.mark.parametrize("shared", [False, True])
def test_sparse_step_matches_dense_step(shared):
    _, cfg = _cfgs(momentum=0.0, shared_negatives=shared,
                   sparse_updates=True)
    dense_cfg = dataclasses.replace(cfg, sparse_updates=False)
    model_d, state_d = tpl.init_state(dense_cfg, "cpu")
    model_s, state_s = tpl.init_state(cfg, "cpu")
    _, corpus = _corpus(np.random.default_rng(1))
    dense = tpl.make_train_step(model_d, dense_cfg, corpus, seed=7)
    sparse = tpl.make_sparse_train_step(model_s, cfg, corpus, seed=7)
    _, batch = _batch(np.random.default_rng(2), 3, 3, 4)
    for _ in range(3):
        state_d, md = dense(state_d, batch)
        state_s, ms = sparse(state_s, batch)
    np.testing.assert_allclose(float(md["loss"]), float(ms["loss"]),
                               rtol=1e-5)
    for name in TABLES:
        _close(getattr(model_s, name).embedding,
               getattr(model_d, name).embedding.detach(), rtol=2e-5,
               atol=1e-7, msg=name)


def test_dense_carrier_matches_dense_momentum():
    _, cfg = _cfgs(momentum=0.9, shared_negatives=True, sparse_updates=True)
    dense_cfg = dataclasses.replace(cfg, sparse_updates=False)
    model_d, state_d = tpl.init_state(dense_cfg, "cpu")
    model_s, state_s = tpl.init_state(cfg, "cpu")
    _, corpus = _corpus(np.random.default_rng(5))
    dense = tpl.make_train_step(model_d, dense_cfg, corpus, seed=7)
    sparse = tpl.make_sparse_train_step(model_s, cfg, corpus, seed=7)
    for i in range(4):
        _, batch = _batch(np.random.default_rng(100 + i), 3, 3, 4)
        state_d, md = dense(state_d, batch)
        state_s, ms = sparse(state_s, batch)
        np.testing.assert_allclose(float(md["loss"]), float(ms["loss"]),
                                   rtol=1e-4)
    for name in TABLES:
        _close(tpl.settled_params(state_s, cfg).get_submodule(name).embedding,
               getattr(model_d, name).embedding.detach(), rtol=1e-4,
               atol=1e-6, msg=name)


def test_init_state_and_carrier():
    jcfg, tcfg = _cfgs(momentum=0.9, sparse_updates=True)
    assert tpl.use_dense_momentum(tcfg) == jpl.use_dense_momentum(jcfg)
    model, state = tpl.init_state(tcfg, "cpu")
    assert set(state.opt_state) == {"album", "artist"}
    # rows padded to 128 at creation, as the reference pads them
    assert tuple(state.opt_state["album"]["momentum"].shape) == (128, 4)
    assert not state.opt_state["album"]["momentum"].any()
    for kw in ({"momentum_carrier": "lazy"}, {"num_artists": 500_000_000}):
        jc, tc = _cfgs(momentum=0.9, sparse_updates=True, **kw)
        assert tpl.use_dense_momentum(tc) == jpl.use_dense_momentum(jc)
    assert set(state.opt_state["album"]) == {"momentum"}
    _, sl = tpl.init_state(dataclasses.replace(tcfg, momentum_carrier="lazy"),
                           "cpu")
    for t in ("album", "artist"):
        assert set(sl.opt_state[t]) == {"momentum", "last_step"}
    last = sl.opt_state["album"]["last_step"]
    assert last.dtype == torch.int32 and tuple(last.shape) == (128,)
    assert not last.any()
    _, s0 = tpl.init_state(dataclasses.replace(tcfg, momentum=0.0), "cpu")
    assert s0.opt_state is None
    _, sd = tpl.init_state(dataclasses.replace(tcfg, sparse_updates=False),
                           "cpu")
    assert isinstance(sd.opt_state, torch.optim.SGD)


def test_state_from_jax_carries_step_params_and_momentum():
    jcfg, tcfg = _cfgs(momentum=0.98, sparse_updates=True,
                       shared_negatives=True)
    jmodel, jstate = jpl.init_state(jcfg, mesh=None)
    jcorpus, _ = _corpus(np.random.default_rng(0))
    step = jax.jit(jpl.make_sparse_train_step(jmodel, jcfg, jcorpus,
                                              jax.random.PRNGKey(0)))
    jb, _ = _batch(np.random.default_rng(1), 3, 3, 4)
    jstate, _ = step(jstate, jb)
    tstate = state_from_jax(jstate, tcfg, device="cpu")
    assert tstate.step == 1
    for name in TABLES:
        np.testing.assert_array_equal(
            getattr(tstate.params, name).embedding.detach().numpy(),
            np.asarray(jstate.params[name]["embedding"]))
    for t in ("album", "artist"):
        np.testing.assert_array_equal(
            tstate.opt_state[t]["momentum"].numpy(),
            np.asarray(jstate.opt_state[t]["momentum"]))
        assert tstate.opt_state[t]["momentum"].abs().sum() > 0


def test_negative_sampling_ranges_and_shapes():
    gen = torch.Generator().manual_seed(0)
    ids = tneg.sample_negative_ids(gen, 4000, 5, exact_range=True)
    assert ids.dtype == torch.int32 and ids.shape == (4000,)
    assert int(ids.min()) == 0 and int(ids.max()) == 3
    ids = tneg.sample_negative_ids(gen, 7, 5, batch_size=3)
    assert ids.shape == (3, 7) and int(ids.max()) <= 4
    corpus = (torch.arange(10, 20), torch.arange(30, 40))
    idx, a, b = tneg.sample_negative_rows(gen, 6, corpus)
    assert torch.equal(a, idx.long() + 10) and torch.equal(b, idx.long() + 30)


def test_sparse_step_draws_the_same_negatives_per_step():
    """Without injected ids the step's negatives depend on (seed, step)
    only, as the reference's folded key does."""
    _, cfg = _cfgs(momentum=0.0, shared_negatives=True, sparse_updates=True)
    _, corpus = _corpus(np.random.default_rng(3))
    _, batch = _batch(np.random.default_rng(4), 3, 3, 4)
    losses = []
    for _ in range(2):
        model, state = tpl.init_state(cfg, "cpu")
        step = tpl.make_sparse_train_step(model, cfg, corpus, seed=9)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]
