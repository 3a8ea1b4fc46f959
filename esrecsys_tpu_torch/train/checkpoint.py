"""Checkpoints and resume (counterpart of
``esrecsys_tpu/train/checkpoint.py``, which writes Orbax directories).

One ``.npz`` per step, ``<directory>/ckpt-<step>.npz``, holding the train
state under flattened keys: ``params/<module>/<param>`` as
``train/export.py`` writes them, ``opt_state/...`` (the momentum
carriers' ``opt_state/<table>/momentum``, with the lazy carrier's int32
``opt_state/<table>/last_step`` beside it, or a ``torch.optim``
optimizer's per-parameter state as ``opt_state/<module>/<param>/<key>``)
and ``step``. A save writes a temporary file and ``os.replace``s it into
place, so a save cut short (a signal, a crash) never becomes
``latest_step``; older checkpoints are pruned to ``max_to_keep`` only
after the new one is complete. A checkpoint whose keys do not match the
template raises ``ValueError`` (``workloads/playlist.restore_adapt_carrier``
converts between the two momentum carriers).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

_NAME = re.compile(r"^ckpt-(\d+)\.npz$")


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            _flatten(tree[key], f"{prefix}/{key}", out)
    elif tree is not None:
        out[prefix] = tree


def _param_names(state: Any) -> Dict[int, str]:
    """id(parameter) -> its flattened key path, for an ``nn.Module``."""
    if not isinstance(state.params, nn.Module):
        return {}
    return {id(p): n.replace(".", "/")
            for n, p in state.params.named_parameters()}


def _state_tensors(state: Any) -> Dict[str, Any]:
    """The flattened array leaves of a ``TrainState``-like object (the
    live tensors, not copies): ``params`` and ``opt_state``."""
    out: Dict[str, Any] = {}
    params = state.params
    if isinstance(params, nn.Module):
        for name, t in params.state_dict().items():
            out["params/" + name.replace(".", "/")] = t
    else:
        _flatten(params, "params", out)
    opt = state.opt_state
    if isinstance(opt, torch.optim.Optimizer):
        names = _param_names(state)
        for p, entries in opt.state.items():
            for key, value in entries.items():
                if isinstance(value, torch.Tensor):
                    out[f"opt_state/{names[id(p)]}/{key}"] = value
    else:
        _flatten(opt, "opt_state", out)
    return out


def _restore_optimizer(state: Any, saved: Dict[str, np.ndarray],
                       adapt_rows: bool) -> None:
    """Replace a ``torch.optim`` optimizer's per-parameter state with the
    saved ``opt_state/<module>/<param>/<key>`` arrays (a fresh optimizer
    has no state to copy into)."""
    opt = state.opt_state
    names = _param_names(state)
    by_name = {names[id(p)]: p for g in opt.param_groups for p in g["params"]}
    opt.state.clear()
    for k, arr in saved.items():
        name, key = k[len("opt_state/"):].rsplit("/", 1)
        if name not in by_name:
            raise ValueError(f"{k}: no such parameter in the template")
        p = by_name[name]
        if arr.shape != tuple(p.shape) and not adapt_rows:
            raise ValueError(f"{k}: checkpoint shape {arr.shape} != "
                             f"parameter {tuple(p.shape)}")
        opt.state[p][key] = torch.from_numpy(_adapt_rows(p, arr)).to(p.device)


def _adapt_rows(template: Any, raw: Any) -> Any:
    """Per leaf of two matching trees: fit the saved array ``raw`` to the
    template leaf's shape and dtype. Only axis 0 (the row count) adapts:
    extra rows are trimmed and missing ones zero-padded (padded table rows
    sit past the id guards, so zeros are exact); any other mismatch
    raises ``ValueError``."""
    if isinstance(template, Mapping):
        return {k: _adapt_rows(template[k], raw[k]) for k in template}
    want = tuple(template.shape)
    arr = np.asarray(raw)
    if arr.shape != want:
        if arr.ndim != len(want) or arr.shape[1:] != want[1:] or not want:
            raise ValueError(
                f"checkpoint leaf shape {arr.shape} cannot adapt to "
                f"template {want} (only axis-0 row padding is adaptable)")
        if arr.shape[0] > want[0]:
            arr = arr[:want[0]]
        else:
            pad = np.zeros((want[0] - arr.shape[0],) + arr.shape[1:],
                           arr.dtype)
            arr = np.concatenate([arr, pad], axis=0)
    dtype = template.dtype
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty((), dtype=dtype).numpy().dtype
    return arr.astype(dtype)


class Checkpointer:
    """Step-indexed checkpoints with bounded retention (keep-last-k)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False):
        """``async_save=True`` copies the state to the host before
        :meth:`save` returns and writes the file on a thread, so the write
        overlaps training; :meth:`wait` joins it."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{int(step):08d}.npz")

    def all_steps(self) -> List[int]:
        """The steps of the complete checkpoints, ascending."""
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> bool:
        """Write ``state`` as the checkpoint of ``step`` and return True;
        as the reference's Orbax manager does, a step at or before the
        latest saved one is skipped (False). An async save first waits for
        the one before it."""
        self.wait()
        latest = self.latest_step()
        if latest is not None and int(step) <= latest:
            return False
        # copies: an async write must not see the steps that follow
        payload = {k: (v.detach().to("cpu", copy=True).numpy()
                       if isinstance(v, torch.Tensor) else np.array(v))
                   for k, v in _state_tensors(state).items()}
        payload["step"] = np.asarray(int(state.step), np.int64)
        if not self.async_save:
            self._write(int(step), payload)
            return True
        self._thread = threading.Thread(
            target=self._write_or_record, args=(int(step), payload),
            daemon=True)
        self._thread.start()
        return True

    def _write_or_record(self, step: int, payload: Dict[str, Any]) -> None:
        try:
            self._write(step, payload)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    def _write(self, step: int, payload: Dict[str, Any]) -> None:
        path = self.path(step)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        if self.max_to_keep > 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))

    def wait(self) -> None:
        """Block until an async save is on disk; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, state_template: Any, step: Optional[int] = None,
                adapt_rows: bool = True) -> Any:
        """Copy checkpoint ``step`` (default: the latest) into
        ``state_template``'s tensors in place and set its ``step``; return
        the template. ``adapt_rows``: a saved array whose row count
        (axis 0) differs from the template's is trimmed or zero-padded to
        it (a checkpoint written under another table padding); otherwise,
        and for any other mismatch, restore raises ``ValueError``."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with np.load(self.path(step)) as z:
            saved = {k: z[k] for k in z.files}
        optimizer = isinstance(state_template.opt_state,
                               torch.optim.Optimizer)
        targets = _state_tensors(state_template)
        if optimizer:
            targets = {k: t for k, t in targets.items()
                       if not k.startswith("opt_state/")}
            saved_opt = {k: v for k, v in saved.items()
                         if k.startswith("opt_state/")}
            saved = {k: v for k, v in saved.items() if k not in saved_opt}
        missing = sorted(set(targets) - set(saved))
        extra = sorted(set(saved) - set(targets) - {"step"})
        if missing or extra:
            raise ValueError(
                f"checkpoint {self.path(step)} does not match the template: "
                f"missing {missing}, unexpected {extra}")
        arrays = {}
        for k, t in targets.items():
            if tuple(saved[k].shape) != tuple(t.shape) and not adapt_rows:
                raise ValueError(
                    f"{k}: checkpoint shape {saved[k].shape} != template "
                    f"{tuple(t.shape)}")
            arrays[k] = _adapt_rows(t, saved[k])
        with torch.no_grad():
            for k, t in targets.items():
                t.copy_(torch.from_numpy(arrays[k]))
        if optimizer:
            _restore_optimizer(state_template, saved_opt, adapt_rows)
        state_template.step = int(saved["step"])
        return state_template

    def close(self) -> None:
        self.wait()
