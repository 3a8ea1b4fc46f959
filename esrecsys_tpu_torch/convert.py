"""Carry parameters between the JAX package's nested trees and PyTorch
state dicts.

The JAX tree of ``PlaylistModel`` is ``{"album_embed": {"embedding": a},
"artist_embed": {"embedding": b}}``; the port's state dict names the same
tensors ``album_embed.embedding`` and ``artist_embed.embedding``. The
mapping is the path joined with dots, so it holds for any model whose
module names mirror the reference's.
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
