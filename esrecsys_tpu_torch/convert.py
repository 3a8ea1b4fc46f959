"""Carry parameters and train states between the JAX package's nested
trees and PyTorch state dicts.

The JAX tree of ``PlaylistModel`` is ``{"album_embed": {"embedding": a},
"artist_embed": {"embedding": b}}``; the port's state dict names the same
tensors ``album_embed.embedding`` and ``artist_embed.embedding``. The
mapping is the path joined with dots, so it holds for any model whose
module names mirror the reference's (``Glove``'s ``token_embedding`` and
``bias`` too; ``Txt2UrlModel``'s LSTM names its eight ``Dense`` kernels
``encoder.rnn.cell.ii.kernel`` ... ``encoder.rnn.cell.ho.bias`` as flax's
``OptimizedLSTMCell`` does, kernels ``(in, out)`` both sides). Train
states cross with their optimizer state: the playlist's momentum
carriers and SGD trace, GloVe's optax Adam state or LazyAdam moments,
txt2url's RMSprop ``nu``. The Shop-the-Look towers cross through their
own functions (``stl_*``): their conv and Dense kernels are transposed
between flax's layouts and PyTorch's, and their BatchNorm running
statistics travel as the ``batch_stats`` tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested ``{module: {param: array}}`` -> flat state dict of tensors.
    Leaves may be numpy arrays or anything ``np.asarray`` accepts."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key in sorted(node):
            path = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(node[key], Mapping):
                walk(node[key], path)
            else:
                out[path] = torch.from_numpy(np.array(node[key]))

    walk(params, "")
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Any]:
    """Flat state dict -> nested ``{module: {param: np.ndarray}}``."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value.detach().cpu().numpy()
    return tree


def _optax_trace(opt_state):
    """The momentum tree of an optax SGD state, or None (no momentum)."""
    parts = opt_state if isinstance(opt_state, tuple) else (opt_state,)
    for part in parts:
        trace = getattr(part, "trace", None)
        if trace is not None:
            return trace
    return None


def _optax_adam(opt_state):
    """(count, mu, nu) of an optax Adam state (``ScaleByAdamState``, alone
    or in a chain), or None."""
    parts = opt_state if isinstance(opt_state, tuple) else (opt_state,)
    for part in parts:
        if all(hasattr(part, k) for k in ("count", "mu", "nu")):
            return part.count, part.mu, part.nu
    return None


def _copy_tree(dst: Mapping[str, Any], src: Mapping[str, Any]) -> None:
    """Copy the arrays of ``src`` into the tensors of ``dst`` (same keys)."""
    for key, t in dst.items():
        if isinstance(t, Mapping):
            _copy_tree(t, src[key])
        else:
            t.copy_(torch.from_numpy(np.array(src[key])))


def glove_state_from_jax(jax_state, cfg, num_embeddings: int, device=None):
    """A JAX GloVe ``TrainState`` -> the port's for the same
    ``GloveConfig`` fields and vocabulary size: params, ``step``, and the
    optimizer state, on ``device`` (default: the card). ``lazy_adam``'s
    ``{"embedding": {"m", "v"}, "bias": {"m", "v"}}`` is copied as it is;
    ``adam``'s optax ``ScaleByAdamState`` becomes the per-table ``mu`` and
    ``nu``, and its ``count`` must equal the step (the port's bias
    correction counts ``step + 1`` updates)."""
    from esrecsys_tpu_torch.workloads.glove import TABLES, init_state

    model, state = init_state(cfg, num_embeddings, device)
    model.load_state_dict(params_from_jax(jax_state.params))
    state.step = int(np.asarray(jax_state.step))
    if cfg.optimizer == "lazy_adam":
        _copy_tree(state.opt_state, jax_state.opt_state)
        return state
    adam = _optax_adam(jax_state.opt_state)
    if adam is None:
        raise ValueError("the JAX state holds no optax Adam state")
    count, mu, nu = adam
    if int(np.asarray(count)) != state.step:
        raise ValueError(f"Adam count {int(np.asarray(count))} != step "
                         f"{state.step}")
    for name in TABLES:
        state.opt_state[name]["mu"].copy_(
            torch.from_numpy(np.array(mu[name]["embedding"])))
        state.opt_state[name]["nu"].copy_(
            torch.from_numpy(np.array(nu[name]["embedding"])))
    return state


def state_from_jax(jax_state, cfg, device=None):
    """A JAX playlist ``TrainState`` -> the port's ``TrainState`` for the
    same ``PlaylistConfig`` fields: params, ``step``, and the optimizer
    state, on ``device`` (default: the card, as every entry point; pass
    ``device="cpu"`` on a host without one). The row-sparse step's
    momentum state is copied as it is: ``{"album": {"momentum"}, "artist":
    {"momentum"}}`` for the dense carrier, with each table's int32
    ``last_step`` for the lazy one; the dense step's optax trace becomes
    the SGD momentum buffers. GloVe's states cross with
    :func:`glove_state_from_jax`."""
    from esrecsys_tpu_torch.workloads.playlist import init_state

    model, state = init_state(cfg, device)
    model.load_state_dict(params_from_jax(jax_state.params))
    state.step = int(np.asarray(jax_state.step))
    if cfg.sparse_updates and cfg.momentum:
        for table in ("album", "artist"):
            for key, t in state.opt_state[table].items():
                t.copy_(torch.from_numpy(
                    np.array(jax_state.opt_state[table][key])))
    elif not cfg.sparse_updates:
        trace = _optax_trace(jax_state.opt_state)
        if trace is not None and cfg.momentum:
            bufs = params_from_jax(trace)
            for name, p in model.named_parameters():
                state.opt_state.state[p]["momentum_buffer"] = (
                    bufs[name].to(p.device).clone())
    return state


def _optax_rms_nu(opt_state):
    """The ``nu`` tree of an optax ``scale_by_rms`` state (alone or in a
    chain), or None."""
    parts = opt_state if isinstance(opt_state, tuple) else (opt_state,)
    for part in parts:
        if hasattr(part, "nu") and not hasattr(part, "mu"):
            return part.nu
    return None


def txt2url_model_from_jax(params: Mapping[str, Any], cfg,
                           device=None):
    """A ``Txt2UrlModel`` holding the JAX txt2url ``params`` (numpy or JAX
    arrays; the vocabulary sizes are the tables' row counts) for the same
    ``Txt2UrlConfig`` widths and encoder, on ``device`` (default: the
    card)."""
    from esrecsys_tpu_torch.core.device import resolve_device
    from esrecsys_tpu_torch.models.txt2url import Txt2UrlModel

    words = np.shape(params["encoder"]["word_embedding"]["embedding"])[0]
    urls = np.shape(params["url_embedding"]["embedding"])[0]
    model = Txt2UrlModel(words, urls, cfg.word_dim, cfg.rnn_size,
                         cfg.url_dim, cfg.encoder_type,
                         device=resolve_device(device))
    model.load_state_dict(params_from_jax(params))
    return model


def txt2url_state_from_jax(jax_state, cfg, device=None):
    """A JAX txt2url ``TrainState`` -> the port's for the same
    ``Txt2UrlConfig``: params (:func:`txt2url_model_from_jax`), ``step``
    (optax's schedule count) and RMSprop's ``nu`` per parameter."""
    from esrecsys_tpu_torch.train.state import TrainState

    model = txt2url_model_from_jax(jax_state.params, cfg, device)
    nu_tree = _optax_rms_nu(jax_state.opt_state)
    if nu_tree is None:
        raise ValueError("the JAX state holds no optax RMSprop state")
    by_name = dict(model.named_parameters())
    nu = params_from_jax(nu_tree)
    if set(nu) != set(by_name):
        raise ValueError(f"RMSprop state {sorted(nu)} != parameters "
                         f"{sorted(by_name)}")
    nu = {k: v.to(by_name[k].device) for k, v in nu.items()}
    return TrainState(step=int(np.asarray(jax_state.step)), params=model,
                      opt_state={"nu": nu})


def txt2url_model_from_artifact(path: str, device=None):
    """(model, metadata) of a txt2url artifact written by either package:
    the widths and the encoder from its ``__meta__`` and parameters."""
    from types import SimpleNamespace

    from esrecsys_tpu_torch.train.export import load_model

    params, _, meta = load_model(path)
    widths = SimpleNamespace(**{k: meta[k] for k in (
        "word_dim", "rnn_size", "url_dim", "encoder_type")})
    return txt2url_model_from_jax(params, widths, device), meta


# ------------------------------------------------------------ Shop the Look

def _stl_leaf_to_torch(path: str, arr: np.ndarray) -> np.ndarray:
    """A flax STL parameter in PyTorch's layout: conv kernels (kh, kw, in,
    out) -> (out, in, kh, kw), the Dense kernel (in, out) -> (out, in)."""
    if path.endswith(".kernel"):
        return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    return arr


def _stl_leaf_to_jax(path: str, arr: np.ndarray) -> np.ndarray:
    if path.endswith(".kernel"):
        return arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
    return arr


def stl_state_dict_from_jax(params: Mapping[str, Any],
                            batch_stats: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The flax ``STLModel``'s ``params`` and ``batch_stats`` trees -> a
    state dict of ``models/cnn.STLModel`` (kernels transposed to
    PyTorch's layouts, the running statistics as ``...BatchNorm_j.mean`` and
    ``.var`` buffers)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(
        _stl_leaf_to_torch(k, v.numpy())))
        for k, v in params_from_jax(params).items()}
    out.update(params_from_jax(batch_stats))
    return out


def stl_params_to_jax(model) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) trees of numpy arrays in the flax layout, from
    a ``models/cnn.STLModel`` (or one of its towers' parent modules)."""
    params = {n: torch.from_numpy(np.ascontiguousarray(
        _stl_leaf_to_jax(n, p.detach().cpu().numpy())))
        for n, p in model.named_parameters()}
    return params_to_jax(params), params_to_jax(dict(model.named_buffers()))


def stl_model_from_jax(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any], output_size: int,
                       filters, dtype=torch.float32, device=None):
    """A ``models/cnn.STLModel`` of ``dtype`` holding the flax params and
    running statistics, on ``device`` (default: the card)."""
    from esrecsys_tpu_torch.core.device import resolve_device
    from esrecsys_tpu_torch.models.cnn import STLModel

    model = STLModel(output_size, tuple(filters), dtype,
                     device=resolve_device(device))
    model.load_state_dict(stl_state_dict_from_jax(params, batch_stats))
    return model


def stl_state_from_jax(jax_state, cfg, device=None):
    """A JAX STL ``TrainState`` (params, batch_stats and optax Adam) -> the
    port's for the same ``STLConfig``: the model
    (:func:`stl_model_from_jax`), ``step``, and Adam's ``mu`` and ``nu``
    per parameter in the port's layouts. Adam's ``count`` must equal the
    step."""
    from esrecsys_tpu_torch.train.state import TrainState

    dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
    model = stl_model_from_jax(jax_state.params, jax_state.batch_stats,
                               cfg.output_size, cfg.filters, dtype, device)
    adam = _optax_adam(jax_state.opt_state)
    if adam is None:
        raise ValueError("the JAX state holds no optax Adam state")
    count, mu, nu = adam
    step = int(np.asarray(jax_state.step))
    if int(np.asarray(count)) != step:
        raise ValueError(f"Adam count {int(np.asarray(count))} != step "
                         f"{step}")
    by_name = dict(model.named_parameters())
    opt = {}
    for key, tree in (("mu", mu), ("nu", nu)):
        flat = params_from_jax(tree)
        if set(flat) != set(by_name):
            raise ValueError(f"Adam {key} {sorted(flat)} != parameters "
                             f"{sorted(by_name)}")
        opt[key] = {n: torch.from_numpy(np.ascontiguousarray(
            _stl_leaf_to_torch(n, t.numpy()))).to(by_name[n].device)
            for n, t in flat.items()}
    return TrainState(step=step, params=model, opt_state=opt)


def stl_model_from_artifact(path: str, dtype=torch.float32, device=None):
    """(model, metadata) of an ``stl`` artifact written by either package:
    ``params/...`` and ``batch_stats/...`` in the flax layout, the widths
    from ``__meta__`` (``output_size``, ``filters``)."""
    from esrecsys_tpu_torch.train.export import load_model

    params, batch_stats, meta = load_model(path)
    model = stl_model_from_jax(params, batch_stats, int(meta["output_size"]),
                               tuple(meta["filters"]), dtype, device)
    return model, meta
