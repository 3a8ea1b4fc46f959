"""Carry parameters and train states between the JAX package's nested
trees and PyTorch state dicts.

The JAX tree of ``PlaylistModel`` is ``{"album_embed": {"embedding": a},
"artist_embed": {"embedding": b}}``; the port's state dict names the same
tensors ``album_embed.embedding`` and ``artist_embed.embedding``. The
mapping is the path joined with dots, so it holds for any model whose
module names mirror the reference's (``Glove``'s ``token_embedding`` and
``bias`` too). Train states cross with their optimizer state: the
playlist's momentum carriers and SGD trace, GloVe's optax Adam state or
LazyAdam moments.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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
