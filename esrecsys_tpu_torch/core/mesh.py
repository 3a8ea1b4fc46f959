"""The ``(data, model)`` grid of ranks (counterpart of
``esrecsys_tpu/core/mesh.py``).

One process per device, PyTorch's idiom. A JAX mesh of ``n_data x
n_model`` devices becomes a grid of ``torch.distributed`` ranks of the
same shape, row-major: the rank at data index ``d`` and model index ``m``
is ``ranks[d * n_model + m]``.

  * ``model``: the ranks of one data row each hold one row-shard of every
    sharded table and one slice of a sharded catalog. Their process group
    (:attr:`Mesh.model_group`) carries the sums of the owner-computes
    lookups and the all-gather of the sharded top-k.
  * ``data``: the ranks of one model column hold replicas of the same
    shards and take different slices of the batch. Their process group
    (:attr:`Mesh.data_group`) carries the sum of the row updates and of
    the dense gradients, and BatchNorm's batch sums on a data mesh.

The reference's ``NamedSharding`` helpers (``data_sharding``,
``table_sharding``, ``replicated``) have no object counterpart: a rank
holds its own slice, and :meth:`Mesh.row_range`, :meth:`Mesh.owned` and
the group collectives below say which slice and how slices meet.

Ranks come from ``torchrun``'s environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) or from explicit
arguments; the backend is NCCL on the card and gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import socket
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from esrecsys_tpu_torch.core.device import pad_to_multiple

log = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without ``torch.distributed``)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of ranks (1 without ``torch.distributed``)."""
    return dist.get_world_size() if is_initialized() else 1


def backend_for(device: torch.device) -> str:
    """NCCL for ranks on cards, gloo for ranks on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def distributed_init_if_needed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> bool:
    """Start ``torch.distributed`` when coordinates are given, and return
    whether more than one rank runs.

    Coordinates come from the arguments or from ``torchrun``'s environment
    (``MASTER_ADDR`` and ``MASTER_PORT`` as ``env://``, ``WORLD_SIZE``,
    ``RANK``). With none of them this is a no-op (a single-process run);
    an address, a world size or a rank without the others raises
    ``ValueError``, as the reference's partial coordinates do. A process
    group started earlier (a test's ``file://`` group) is kept. The backend
    follows ``device`` (default: the card)."""
    if is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR"):
        init_method = "env://"
    world = world_size if world_size is not None else env.get("WORLD_SIZE")
    rk = rank if rank is not None else env.get("RANK")
    if init_method is None and world is None and rk is None:
        return False
    if init_method is None or world is None or rk is None:
        raise ValueError(
            "partial distributed coordinates: need MASTER_ADDR and "
            "MASTER_PORT (or init_method), WORLD_SIZE and RANK (got "
            f"init_method={init_method!r}, world_size={world!r}, "
            f"rank={rk!r})")
    device = torch.device("cuda" if device is None else device)
    dist.init_process_group(backend_for(device), init_method=init_method,
                            world_size=int(world), rank=int(rk))
    log.info("torch.distributed initialized: rank %d/%d (%s)",
             dist.get_rank(), dist.get_world_size(), dist.get_backend())
    return dist.get_world_size() > 1


def check_ranks(n_model: int, what: str, exact: bool = False) -> int:
    """The world size, after checking that it can hold ``n_model`` shards
    (a multiple of it; with ``exact``, exactly it). A single process is
    one rank. Too few or mismatched ranks raise ``ValueError`` naming
    ``torchrun``: a sharded path never falls back to one rank."""
    world = process_count()
    if (world != n_model) if exact else (world % n_model):
        want = f"{n_model}" if exact else f"a multiple of {n_model}"
        raise ValueError(
            f"{what} with {n_model} model shards needs {want} ranks, one "
            f"per card, and {world} are running: start it under torchrun "
            f"--nproc_per_node {n_model}")
    return world


def rank_device(device: torch.device) -> torch.device:
    """The card of this rank (``LOCAL_RANK``, else the rank modulo the
    cards of the host) for a CUDA ``device`` without an index, made the
    current device; any other device as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK",
                               process_index() % max(
                                   torch.cuda.device_count(), 1)))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: this
    rank's card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class CollectiveBytes:
    """Bytes the mesh's collectives return per kind (``all-reduce``,
    ``reduce``, ``broadcast``, ``all-gather``): each collective over a
    group of more than one rank adds the size of its output, as the
    reference's scaling study sums the output bytes of the partitioned
    program's collectives. ``reset`` and read like a kernel's
    ``LaunchCounter``; a count is one Python add, with no
    synchronisation."""

    def __init__(self) -> None:
        self.bytes: Dict[str, int] = {}
        self.count: Dict[str, int] = {}

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes
        self.count[kind] = self.count.get(kind, 0) + 1

    def reset(self) -> None:
        self.bytes = {}
        self.count = {}


COLLECTIVE_BYTES = CollectiveBytes()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gather(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    if group is None or size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    COLLECTIVE_BYTES.add("all-gather", size * _nbytes(t))
    return torch.cat(parts, dim=dim)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in an ``n_data x n_model`` grid, with the process
    groups of its data row (``model_group``) and model column
    (``data_group``); both are None without ``torch.distributed`` (a 1x1
    grid of one process), where every collective is the identity."""

    n_data: int
    n_model: int
    ranks: tuple           # global ranks, row-major (n_data, n_model)
    rank: int              # this process's global rank
    model_group: Any = None
    data_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def data_index(self) -> int:
        return self.ranks.index(self.rank) // self.n_model

    @property
    def model_index(self) -> int:
        return self.ranks.index(self.rank) % self.n_model

    def model_peer(self, j: int) -> int:
        """The global rank at model index ``j`` of this rank's data row."""
        return self.ranks[self.data_index * self.n_model + j]

    def row_range(self, num_rows: int) -> range:
        """The rows of a ``num_rows``-row table (a multiple of
        ``n_model``) this rank's shard holds."""
        if num_rows % self.n_model:
            raise ValueError(f"{num_rows} rows do not divide over "
                             f"{self.n_model} model shards")
        per = num_rows // self.n_model
        return range(self.model_index * per, (self.model_index + 1) * per)

    def owned(self, ids: torch.Tensor, rows_per_shard: int) -> torch.Tensor:
        """Global row ids -> int32 ids local to this rank's shard of
        ``rows_per_shard`` rows, -1 where another shard owns the row (the
        row kernels read a zero row for -1 and drop its updates)."""
        local = ids.to(torch.int64) - self.model_index * rows_per_shard
        own = (local >= 0) & (local < rows_per_shard)
        return torch.where(own, local, -1).to(torch.int32)

    def sum_model(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce SUM over the data row's shards, in place."""
        if self.model_group is not None:
            dist.all_reduce(t, group=self.model_group)
            if self.n_model > 1:
                COLLECTIVE_BYTES.add("all-reduce", _nbytes(t))
        return t

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce SUM over the replicas of this shard, in place."""
        if self.data_group is not None:
            dist.all_reduce(t, group=self.data_group)
            if self.n_data > 1:
                COLLECTIVE_BYTES.add("all-reduce", _nbytes(t))
        return t

    def mean_data(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the data rows (a new tensor)."""
        if self.data_group is None or self.n_data == 1:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.data_group)
        COLLECTIVE_BYTES.add("all-reduce", _nbytes(t))
        return t / self.n_data

    def reduce_model_to(self, t: torch.Tensor, j: int) -> torch.Tensor:
        """Reduce SUM over the data row's shards into the rank at model
        index ``j``, in place (the other ranks' ``t`` is scratch)."""
        if self.model_group is not None:
            dist.reduce(t, dst=self.model_peer(j), group=self.model_group)
            if self.n_model > 1:
                COLLECTIVE_BYTES.add("reduce", _nbytes(t))
        return t

    def broadcast_model(self, t: torch.Tensor, j: int = 0) -> torch.Tensor:
        """Broadcast ``t`` from the rank at model index ``j`` to the data
        row's other ranks, in place (their ``t`` gives the shape and
        receives the values)."""
        if self.model_group is not None:
            dist.broadcast(t, src=self.model_peer(j), group=self.model_group)
            if self.n_model > 1:
                COLLECTIVE_BYTES.add("broadcast", _nbytes(t))
        return t

    def min_model(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce MIN over the data row's shards, in place."""
        if self.model_group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.model_group)
            if self.n_model > 1:
                COLLECTIVE_BYTES.add("all-reduce", _nbytes(t))
        return t

    def local(self) -> "Mesh":
        """This rank's place without its groups: every collective is the
        identity (a shard's own part of a sharded computation, e.g. a
        warm-up that must not meet the other ranks)."""
        return dataclasses.replace(self, model_group=None, data_group=None)

    def gather_model(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """``t`` of every shard of the data row, concatenated along
        ``dim`` in model-index order."""
        return _gather(t, self.model_group, self.n_model, dim)

    def gather_data(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """``t`` of every replica of this shard, concatenated along
        ``dim`` in data-index order."""
        return _gather(t, self.data_group, self.n_data, dim)

    def place(self, batch: Dict[str, Any],
              device: torch.device) -> Dict[str, torch.Tensor]:
        """A rank's process-local batch -> its data row's batch on
        ``device``: the slices of the data row's ranks concatenated in
        model-index order (the reference assembles the global batch from
        the processes' slices, and a data row takes its part of it)."""
        from esrecsys_tpu_torch.core.device import array_to_device

        out = {}
        for k, v in batch.items():
            t = (v.to(device) if isinstance(v, torch.Tensor)
                 else array_to_device(np.asarray(v), device))
            out[k] = self.gather_model(t)
        return out


def _hostnames(ranks: Sequence[int]) -> np.ndarray:
    if not is_initialized():
        return np.asarray([socket.gethostname()])
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return np.asarray([names[r] for r in ranks])


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The framework's ``(data, model)`` grid over ``ranks`` (default:
    every rank). Every rank of the world calls it, in the same order, since
    it creates process groups; a rank outside ``ranks`` raises.

    Args:
      n_data: size of the data axis; defaults to ``len(ranks) // n_model``.
      n_model: size of the model (table-shard) axis.
    """
    world = process_count()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    n = len(ranks)
    if n_data is None:
        if n % n_model != 0:
            raise ValueError(f"{n} ranks not divisible by n_model={n_model}")
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(
            f"mesh {n_data}x{n_model} != {n} ranks; pass matching ranks")
    rank = process_index()
    if rank not in ranks:
        raise ValueError(f"rank {rank} is not in the mesh's ranks {ranks}")
    model_group = data_group = None
    if is_initialized():
        # every rank creates every group, in one order
        for d in range(n_data):
            g = dist.new_group(list(ranks[d * n_model:(d + 1) * n_model]))
            if rank in ranks[d * n_model:(d + 1) * n_model]:
                model_group = g
        for m in range(n_model):
            g = dist.new_group(list(ranks[m::n_model]))
            if rank in ranks[m::n_model]:
                data_group = g
    warn_if_model_axis_spans_slices(
        _hostnames(ranks).reshape(n_data, n_model))
    return Mesh(n_data, n_model, ranks, rank, model_group, data_group)


def warn_if_model_axis_spans_slices(hosts) -> bool:
    """Warn when a model group spans hosts: the table sums and the
    candidate all-gather run every step and are latency-bound, so a
    model group belongs on one host's NVLink; span hosts with the data
    axis instead (order ranks so each data row shares a host). ``hosts``
    is the ``(n_data, n_model)`` grid of host names. Returns True when the
    warning fired."""
    rows_spanning = sum(len(set(row)) > 1 for row in np.atleast_2d(hosts))
    if rows_spanning:
        log.warning(
            "model axis spans hosts on %d/%d data rows: its per-step "
            "collectives (table sums, candidate all-gather) would leave "
            "NVLink. Order ranks so each model group stays on one host; "
            "span hosts with the data axis instead.",
            rows_spanning, np.atleast_2d(hosts).shape[0])
    return bool(rows_spanning)


def make_mesh_for_batch(global_batch: int, n_model: int = 1) -> Mesh:
    """A grid whose data axis divides the batch: ``data = gcd(ranks //
    n_model, global_batch)``. A single process may shrink to fewer ranks
    (there is one); under several processes the ranks left out would
    break the batch's assembly, so that raises."""
    avail = process_count()
    if avail % n_model:
        raise ValueError(f"{avail} ranks not divisible by n_model={n_model}")
    n_data = math.gcd(avail // n_model, max(1, global_batch))
    if avail > 1 and n_data * n_model != avail:
        raise ValueError(
            f"global batch {global_batch} does not divide over {avail} "
            f"ranks; choose a batch divisible by {avail // n_model}")
    return make_mesh(n_data=n_data, n_model=n_model,
                     ranks=range(n_data * n_model))


def single_device_mesh() -> Mesh:
    """A 1x1 grid on rank 0, so every code path can be mesh-shaped."""
    return make_mesh(n_data=1, n_model=1, ranks=[0])


def round_up_rows(num_rows: int, mesh: Mesh) -> int:
    """A table's row count padded to divide over the model axis."""
    return pad_to_multiple(num_rows, mesh.n_model)


def local_batch(global_batch: int, mesh: Mesh) -> int:
    """A data row's batch."""
    if global_batch % mesh.n_data:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data={mesh.n_data}")
    return global_batch // mesh.n_data


def shard_files_for_process(files: Sequence[str]) -> list:
    """Rank p of n takes files p, p+n, p+2n, ... of the sorted list."""
    return sorted(files)[process_index()::process_count()]


def process_local_files(files: Sequence[str]) -> list:
    """:func:`shard_files_for_process` with a starvation guard: a rank
    whose slice is empty (fewer files than ranks) reads every file, so
    its collectives do not hang; the per-rank seed keeps its stream apart,
    and the warning asks for more shards."""
    mine = shard_files_for_process(files)
    if not mine and files:
        log.warning(
            "process %d/%d got 0 of %d input files: reading all files on "
            "this rank; write >= process_count shards to fix",
            process_index(), process_count(), len(files))
        return sorted(files)
    return mine


def process_local_slice(items: Sequence) -> list:
    """Rank p of n takes items p, p+n, ... in the given order (datasets
    that are lists of examples); an empty slice falls back to all items,
    as :func:`process_local_files` does."""
    mine = list(items)[process_index()::process_count()]
    if not mine and items:
        log.warning("process %d/%d got 0 of %d examples: using all",
                    process_index(), process_count(), len(items))
        return list(items)
    return mine


def process_local_batch(global_batch: int) -> int:
    """A rank's batch: the global batch over the ranks (a data row
    gathers its ranks' slices, :meth:`Mesh.place`)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n
