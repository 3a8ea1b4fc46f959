"""Final-model artifact export (counterpart of ``esrecsys_tpu/train/export.py``).

One ``.npz`` per export in the reference's format, so an artifact written
by either package loads in the other: ``params/<module>/<param>`` arrays
(keys in sorted path order, as the reference's tree flatten gives them),
optional ``batch_stats/...`` arrays, and a ``__meta__`` uint8 array
holding a JSON object with at least ``name`` and ``step``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from esrecsys_tpu_torch.convert import params_to_jax


def _flatten(tree: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}"
        value = tree[key]
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        elif isinstance(value, torch.Tensor):
            flat[path] = value.detach().cpu().numpy()
        else:
            flat[path] = np.asarray(value)
    return flat


def _unflatten(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    pfx = f"{prefix}/"
    for key, value in flat.items():
        if not key.startswith(pfx):
            continue
        node = tree
        parts = key[len(pfx):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def export_model(
    work_dir: str,
    name: str,
    params: Union[nn.Module, Mapping[str, Any]],
    *,
    step: int,
    tracker: Optional[Any] = None,
    batch_stats: Optional[Mapping[str, Any]] = None,
    metadata: Optional[Dict[str, Any]] = None,
) -> str:
    """Write ``<work_dir>/artifacts/<name>-<step>.npz``, register it with
    ``tracker`` if one is given, and return its path.

    ``params``: an ``nn.Module`` (its state dict is written under the
    reference's nested names) or a nested ``{module: {param: array}}``
    mapping."""
    if isinstance(params, nn.Module):
        params = params_to_jax(params.state_dict())
    payload = _flatten(params, "params")
    if batch_stats is not None:
        payload.update(_flatten(batch_stats, "batch_stats"))
    out_dir = os.path.join(work_dir, "artifacts")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}-{int(step):08d}.npz")
    payload["__meta__"] = np.frombuffer(
        json.dumps({"name": name, "step": int(step), **(metadata or {})}).encode(),
        dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic publish
    if tracker is not None:
        tracker.log_artifact(path, name=f"{name}-{int(step)}", kind="model")
    return path


def load_model(path: str
               ) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats, metadata) from an :func:`export_model` file;
    the trees hold numpy arrays (``convert.params_from_jax`` turns params
    into a state dict)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__").tobytes()).decode())
    return _unflatten(flat, "params"), _unflatten(flat, "batch_stats"), meta


def latest_artifact(work_dir: str, name: str) -> Optional[str]:
    """Path of the newest ``<name>-*.npz`` artifact in ``work_dir``, if any."""
    out_dir = os.path.join(work_dir, "artifacts")
    if not os.path.isdir(out_dir):
        return None
    cands = sorted(
        f for f in os.listdir(out_dir)
        if f.startswith(f"{name}-") and f.endswith(".npz"))
    return os.path.join(out_dir, cands[-1]) if cands else None
