"""The port's checkpoints (``train/checkpoint.py``): a bit-exact round trip
of the playlist train states, keep-last-k, temporary files that never
become the latest step, async saves, row adaptation equal to the JAX
package's ``_adapt_rows``, a ``state_from_jax`` state saved and restored
equal to the JAX state, and lazy-carrier checkpoints (``last_step`` rows)
restored as they are and adapted to the dense carrier.
Tolerance: none; every comparison is bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from esrecsys_tpu.train.checkpoint import _adapt_rows as jax_adapt_rows
from esrecsys_tpu.workloads import playlist as jpl
from esrecsys_tpu_torch.convert import state_from_jax
from esrecsys_tpu_torch.train.checkpoint import Checkpointer, _adapt_rows
from esrecsys_tpu_torch.workloads import playlist as tpl

SMALL = dict(feature_size=8, album_hash_buckets=150, num_artists=40,
             num_negatives=4, batch_size=4, context_size=3, max_next=5)


def _state(seed, **kw):
    """A playlist state on the CPU whose every tensor holds random values
    (momentum buffers, ``last_step`` rows and SGD buffers included), at
    step 7 + seed."""
    cfg = tpl.PlaylistConfig(seed=seed, **{**SMALL, **kw})
    model, state = tpl.init_state(cfg, "cpu")
    gen = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():
        if isinstance(state.opt_state, torch.optim.Optimizer):
            for p in model.parameters():
                state.opt_state.state[p]["momentum_buffer"] = torch.randn(
                    p.shape, generator=gen)
        elif state.opt_state is not None:
            for t in state.opt_state.values():
                t["momentum"].copy_(torch.randn(t["momentum"].shape,
                                                generator=gen))
                if "last_step" in t:
                    t["last_step"].copy_(torch.randint(
                        0, 8, t["last_step"].shape, generator=gen))
    state.step = 7 + seed
    return cfg, state


def _tensors(state):
    out = {k: v.clone() for k, v in state.params.state_dict().items()}
    opt = state.opt_state
    if isinstance(opt, torch.optim.Optimizer):
        for n, p in state.params.named_parameters():
            out[f"sgd/{n}"] = opt.state[p]["momentum_buffer"].clone()
    elif opt is not None:
        for t, d in opt.items():
            for key, v in d.items():
                out[f"{t}/{key}"] = v.clone()
    return out


def _assert_bit_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", [
    dict(sparse_updates=True, momentum=0.9),   # dense momentum carrier
    dict(sparse_updates=True, momentum=0.0),   # no optimizer state
    dict(sparse_updates=False, momentum=0.9),  # torch.optim.SGD buffers
])
def test_round_trip_is_bit_exact(tmp_path, kind):
    cfg, state = _state(0, **kind)
    ck = Checkpointer(str(tmp_path))
    assert ck.save(state.step, state)
    _, fresh = _state(1, **kind)  # other values everywhere
    restored = ck.restore(fresh)
    assert restored is fresh and restored.step == state.step == 7
    assert isinstance(restored.step, int)
    _assert_bit_equal(_tensors(restored), _tensors(state))


def test_keeps_the_last_k_and_skips_old_steps(tmp_path):
    _, state = _state(0, sparse_updates=True, momentum=0.9)
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4, 5):
        assert ck.save(step, state)
    assert ck.all_steps() == [4, 5] and ck.latest_step() == 5
    # as the reference's Orbax manager: a step at or before the latest
    # is not written again
    assert not ck.save(5, state) and not ck.save(3, state)
    assert ck.all_steps() == [4, 5]


def test_leftover_temporary_file_is_never_the_latest(tmp_path):
    cfg, state = _state(0, sparse_updates=True, momentum=0.9)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state)
    # a save cut short by a signal leaves only its temporary file
    with open(os.path.join(str(tmp_path), "ckpt-00000009.npz.tmp-1"),
              "wb") as f:
        f.write(b"PK\x03\x04 truncated")
    assert ck.latest_step() == 3 and ck.all_steps() == [3]
    _, fresh = _state(1, sparse_updates=True, momentum=0.9)
    _assert_bit_equal(_tensors(ck.restore(fresh)), _tensors(state))


def test_async_save_copies_before_returning(tmp_path):
    _, state = _state(0, sparse_updates=True, momentum=0.9)
    want = _tensors(state)
    ck = Checkpointer(str(tmp_path), async_save=True)
    assert ck.save(state.step, state)
    with torch.no_grad():  # the next steps change the state in place
        for p in state.params.parameters():
            p.add_(1.0)
        state.opt_state["album"]["momentum"].mul_(2.0)
    ck.wait()
    assert ck.latest_step() == 7
    _, fresh = _state(1, sparse_updates=True, momentum=0.9)
    _assert_bit_equal(_tensors(ck.restore(fresh)), want)
    ck.close()


ADAPT_CASES = [((10, 4), (7, 4)), ((7, 4), (10, 4)), ((6, 3), (6, 3)),
               ((12,), (9,))]


@pytest.mark.parametrize("saved,want", ADAPT_CASES)
def test_adapt_rows_matches_the_reference(saved, want):
    raw = np.random.default_rng(0).standard_normal(saved).astype(np.float64)
    template = np.zeros(want, np.float32)
    ours = _adapt_rows({"a": {"b": template}}, {"a": {"b": raw}})["a"]["b"]
    theirs = np.asarray(jax_adapt_rows({"a": {"b": template}},
                                       {"a": {"b": raw}})["a"]["b"])
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    torch_template = torch.zeros(want)
    np.testing.assert_array_equal(_adapt_rows(torch_template, raw), theirs)


@pytest.mark.parametrize("saved,want", [((6, 3), (6, 4)), ((6, 3), (6,)),
                                        ((), (2,))])
def test_adapt_rows_refuses_other_mismatches_as_the_reference(saved, want):
    raw = np.ones(saved, np.float32)
    with pytest.raises(ValueError, match="only axis-0"):
        _adapt_rows(np.zeros(want, np.float32), raw)
    with pytest.raises(ValueError, match="only axis-0"):
        jax_adapt_rows(np.zeros(want, np.float32), raw)


def test_restore_adapts_table_rows(tmp_path):
    """A checkpoint of 150 album buckets (tables padded to 152 rows at
    D=8) restores into a template of 100 (104 rows) and of 300 (304):
    rows trimmed, or zero-padded; without adapt_rows it raises."""
    _, state = _state(0, sparse_updates=True, momentum=0.9)
    ck = Checkpointer(str(tmp_path))
    ck.save(state.step, state)
    saved = state.params.album_embed.embedding.detach().clone()
    for buckets in (100, 300):
        _, fresh = _state(1, sparse_updates=True, momentum=0.9,
                          album_hash_buckets=buckets)
        got = ck.restore(fresh).params.album_embed.embedding.detach()
        n = min(got.shape[0], saved.shape[0])
        assert torch.equal(got[:n], saved[:n])
        assert not got[n:].any()
        with pytest.raises(ValueError, match="shape"):
            ck.restore(_state(1, sparse_updates=True, momentum=0.9,
                              album_hash_buckets=buckets)[1],
                       adapt_rows=False)


def test_state_from_jax_saved_and_restored_equals_the_jax_state(tmp_path):
    jcfg = jpl.PlaylistConfig(seed=2, sparse_updates=True, momentum=0.9,
                              **SMALL)
    tcfg = tpl.PlaylistConfig(seed=2, sparse_updates=True, momentum=0.9,
                              **SMALL)
    _, jstate = jpl.init_state(jcfg, mesh=None)
    rng = np.random.default_rng(4)
    jstate = jstate.replace(step=jstate.step + 11, opt_state={
        t: {"momentum": rng.standard_normal(
            np.shape(jstate.opt_state[t]["momentum"])).astype(np.float32)}
        for t in ("album", "artist")})
    ck = Checkpointer(str(tmp_path))
    ck.save(11, state_from_jax(jstate, tcfg, device="cpu"))
    _, fresh = _state(5, sparse_updates=True, momentum=0.9)
    got = ck.restore(fresh)
    assert got.step == int(np.asarray(jstate.step)) == 11
    for table in ("album", "artist"):
        np.testing.assert_array_equal(
            getattr(got.params, f"{table}_embed").embedding.detach().numpy(),
            np.asarray(jstate.params[f"{table}_embed"]["embedding"]))
        np.testing.assert_array_equal(
            got.opt_state[table]["momentum"].numpy(),
            np.asarray(jstate.opt_state[table]["momentum"]))


def test_lazy_carrier_checkpoint_raises(tmp_path):
    """A lazy-carrier checkpoint (int32 ``last_step`` rows) restores bit
    for bit into a lazy template. Its plain restore into a dense template
    raises ``ValueError``, and ``restore_adapt_carrier`` settles it into the
    dense carrier instead; a structure of any other kind raises
    ``ValueError`` on both."""
    lazy = dict(sparse_updates=True, momentum=0.9, momentum_carrier="lazy")
    cfg, state = _state(0, **lazy)
    ck = Checkpointer(str(tmp_path))
    ck.save(state.step, state)
    with np.load(ck.path(7)) as z:
        for t in ("album", "artist"):
            assert z[f"opt_state/{t}/last_step"].dtype == np.int32
    _, fresh = _state(1, **lazy)
    _assert_bit_equal(_tensors(ck.restore(fresh)), _tensors(state))
    assert fresh.step == 7
    dense_cfg, dense = _state(1, sparse_updates=True, momentum=0.9)
    with pytest.raises(ValueError, match="unexpected"):
        ck.restore(dense)
    adapted = tpl.restore_adapt_carrier(ck, dense, dense_cfg)
    assert adapted is dense and adapted.step == 7
    assert set(adapted.opt_state["album"]) == {"momentum"}
    want = tpl.settled_params(state, cfg)
    for name in ("album_embed", "artist_embed"):
        assert torch.equal(getattr(adapted.params, name).embedding.detach(),
                           getattr(want, name).embedding)
    # a structure mismatch of any other kind is a ValueError
    none_cfg, no_momentum = _state(1, sparse_updates=True, momentum=0.0)
    with pytest.raises(ValueError, match="unexpected"):
        ck.restore(no_momentum, step=7)
    with pytest.raises(ValueError, match="unexpected"):
        tpl.restore_adapt_carrier(ck, no_momentum, none_cfg)
