"""Partition rules: which leaves of a parameter or state tree are
row-sharded over ``model`` (counterpart of
``esrecsys_tpu/parallel/sharding.py``).

A leaf of two or more dimensions whose path matches a table pattern is
row-sharded; every other leaf (dense weights, biases, statistics) is
replicated on every rank. A spec is a tuple of axis names per dimension,
``("model", None)`` for a sharded table, ``()`` for a replicated leaf.
:func:`shard_tree` cuts a whole tree to this rank's shards and
:func:`gather_tree` puts the whole leaves back together (for export).
Trees are nested mappings (paths joined with ``/``) or flat state dicts
(their dotted names read as paths).
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Sequence, Tuple, Union

import numpy as np

from esrecsys_tpu_torch.core.mesh import MODEL_AXIS, Mesh

DEFAULT_TABLE_PATTERNS = (r"embedding", r"_table", r"embed")

Path = Union[str, Tuple]


def _path_str(path: Path) -> str:
    if isinstance(path, str):
        return path.replace(".", "/")
    return "/".join(str(p) for p in path)


def partition_spec_for(path: Path, leaf: Any,
                       table_patterns: Sequence[str] = DEFAULT_TABLE_PATTERNS
                       ) -> tuple:
    """``("model", None, ...)`` for a table leaf, ``()`` otherwise."""
    name = _path_str(path).lower()
    ndim = getattr(leaf, "ndim", 0)
    if ndim >= 2 and any(re.search(p, name) for p in table_patterns):
        return (MODEL_AXIS,) + (None,) * (ndim - 1)
    return ()


def _map(tree: Any, fn, prefix: str = "") -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def shard_tree(tree: Any, mesh: Mesh,
               table_patterns: Sequence[str] = DEFAULT_TABLE_PATTERNS) -> Any:
    """The tree with every sharded leaf (a tensor or numpy array whose
    rows divide over the model axis) cut to this rank's rows; the other
    leaves are kept as they are."""
    def cut(path, leaf):
        if partition_spec_for(path, leaf, table_patterns):
            rows = mesh.row_range(leaf.shape[0])
            return leaf[rows.start:rows.stop]
        return leaf
    return _map(tree, cut)


def gather_tree(tree: Any, mesh: Mesh,
                table_patterns: Sequence[str] = DEFAULT_TABLE_PATTERNS
                ) -> Any:
    """The inverse of :func:`shard_tree`: every sharded tensor leaf
    gathered whole from the data row's shards (a collective every rank of
    the row calls); a sharded numpy leaf raises ``TypeError``."""
    def whole(path, leaf):
        if not partition_spec_for(path, leaf, table_patterns):
            return leaf
        if isinstance(leaf, np.ndarray):
            raise TypeError(f"{path}: gather a tensor, not a numpy array")
        return mesh.gather_model(leaf.contiguous())
    return _map(tree, whole)
