"""Embedding-id range guards (counterpart of ``esrecsys_tpu/ops/guards.py``).

Modes, set via :func:`set_mode` or the ``ESRECSYS_ID_CHECKS`` env var:

  * ``off``   (default) — ids pass through unchanged; the lookup then
    follows the reference's ``jnp.take`` semantics (see
    :class:`esrecsys_tpu_torch.models.layers.TableEmbed`).
  * ``clamp`` — ids are clipped into ``[0, num_rows)``.
  * ``error`` — an out-of-range id raises ``ValueError`` at once, naming
    the table. The reference defers the same check through ``checkify``;
    PyTorch runs eagerly, so the check raises where it fails.
"""

from __future__ import annotations

import os

import torch

_VALID = ("off", "clamp", "error")
_mode = os.environ.get("ESRECSYS_ID_CHECKS", "off")
if _mode not in _VALID:
    raise ValueError(f"ESRECSYS_ID_CHECKS must be one of {_VALID}, got {_mode!r}")


def set_mode(mode: str) -> None:
    global _mode
    if mode not in _VALID:
        raise ValueError(f"id-check mode must be one of {_VALID}, got {mode!r}")
    _mode = mode


def mode() -> str:
    return _mode


def check_ids(ids: torch.Tensor, num_rows: int,
              name: str = "table") -> torch.Tensor:
    """Apply the active guard to an id tensor bound for a ``num_rows`` table."""
    if _mode == "off":
        return ids
    if _mode == "clamp":
        return torch.clamp(ids, 0, num_rows - 1)
    if ids.numel():
        imin, imax = int(ids.min()), int(ids.max())
        if imin < 0 or imax >= num_rows:
            raise ValueError(
                f"id out of range for {name} ({num_rows} rows): "
                f"min={imin} max={imax}")
    return ids
