"""Fused scan+select: the CUDA kernel's wrapper and its plain PyTorch version.

``fused_scan`` replaces the TPU kernel ``_kernel`` of
``esrecsys_tpu/retrieval/fused.py`` (launched by ``binned_candidates``).
For each query and catalog item g < ``bound`` that the optional mask
admits, it scores ``q . item_g`` with bf16 inputs and float32 sums; item g
falls in bin ``g mod L`` and each bin keeps its top two (value, id) pairs,
folded over the catalog blocks in ascending order with a strict ``>``
(the earlier block wins ties; slots never filled keep (-inf, 0)).

``fused_scan_int8`` is the TPU kernel's int8 branch (quantized serving):
the catalog is (D, Mp) int8 codes with a flat (Mp,) float32 scale per
item; each code widens to bf16 exactly (|v| <= 127), and the float32 dot
is multiplied by the item's scale before the bound, the mask and the fold.

A CPU tensor takes the plain version (:func:`fused_scan_plain`,
:func:`fused_scan_int8_plain`); a CUDA tensor launches a kernel or raises.
:func:`variant` picks it from the width: the tuned kernel in
``csrc/fused_scan.cu`` (bf16) or ``csrc/fused_scan_int8.cu`` (int8) at
the dims it is built for, ``SUPPORTED_DIMS``, and the kernel of
``csrc/fused_generic.cu`` at every other D
(:mod:`~esrecsys_tpu_torch.kernels.fused_generic`). ``LAUNCHES.count``
counts the tuned bf16 kernel's launches, ``LAUNCHES_INT8.count`` the tuned
int8 kernel's; the generic ones count in ``fused_generic``.
:func:`launch_plan` gives the tuned bf16 kernel's grid and cluster size: a
cluster of up to eight CTAs along the query axis reads each catalog block
once for up to 64 queries.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from esrecsys_tpu_torch.kernels import fused_generic
from esrecsys_tpu_torch.kernels.build import LaunchCounter, load_library

NEG_INF = float("-inf")
SUPPORTED_DIMS = (16, 32, 64, 128)  # the tuned kernels' instantiations

LAUNCHES = LaunchCounter()
LAUNCHES_INT8 = LaunchCounter()

QUERIES_PER_CTA = 8   # the bf16 kernel's query tile (the mma's N)
BINS_PER_CTA = 32     # its bin tile
MAX_CLUSTER = 8       # CTAs of a cluster, at most


def variant(dim: int) -> str:
    """The kernel a CUDA scan (bf16 or int8) launches at width ``dim``:
    ``"tuned"`` at the tuned kernels' dims, ``"generic"`` at every other
    positive dim."""
    if dim < 1:
        raise ValueError(f"no fused scan kernel for dim {dim}")
    return "tuned" if dim in SUPPORTED_DIMS else "generic"


class ScanPlan(NamedTuple):
    """The bf16 kernel's launch: ``grid`` is (query tiles, bin tiles),
    query tiles padded to a multiple of ``cluster``; CTA (x, y) holds
    queries 8x..8x+7 (those below B) and bins 32y..32y+31. ``passes`` is
    the number of clusters along the query axis, each reading the catalog
    once."""
    cluster: int
    grid: Tuple[int, int]
    passes: int


def launch_plan(batch: int, num_bins: int) -> ScanPlan:
    """Clusters of ``min(8, ceil(B/8))`` CTAs along the query axis; the
    last cluster holds CTAs without queries when ceil(B/8) is not a
    multiple of the cluster size."""
    if batch < 1 or num_bins < BINS_PER_CTA or num_bins % BINS_PER_CTA:
        raise ValueError(f"no launch for batch {batch}, {num_bins} bins")
    tiles = -(-batch // QUERIES_PER_CTA)
    cluster = min(MAX_CLUSTER, tiles)
    passes = -(-tiles // cluster)
    return ScanPlan(cluster, (passes * cluster, num_bins // BINS_PER_CTA),
                    passes)


def _check(q: torch.Tensor, items_packed: torch.Tensor, num_bins: int,
           bound: int, mask: Optional[torch.Tensor],
           scales: Optional[torch.Tensor] = None) -> None:
    if q.dim() != 2 or items_packed.dim() != 2:
        raise ValueError(f"q {tuple(q.shape)} and items_packed "
                         f"{tuple(items_packed.shape)} must be 2-D")
    kind = torch.bfloat16 if scales is None else torch.int8
    if q.dtype != torch.bfloat16 or items_packed.dtype != kind:
        raise TypeError(f"q ({q.dtype}) must be bfloat16 and items_packed "
                        f"({items_packed.dtype}) {kind}")
    D, Mp = items_packed.shape
    if scales is not None and (scales.shape != (Mp,)
                               or scales.dtype != torch.float32):
        raise ValueError(f"scales must be ({Mp},) float32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    if q.shape[1] != D:
        raise ValueError(f"q dim {q.shape[1]} != catalog dim {D}")
    if num_bins < 1 or num_bins % 128 or Mp % num_bins:
        raise ValueError(f"num_bins {num_bins} must be a positive multiple "
                         f"of 128 dividing Mp={Mp}")
    if not 0 <= bound <= Mp:
        raise ValueError(f"bound {bound} outside [0, {Mp}]")
    if mask is not None and (mask.shape != (Mp,) or mask.dtype not in
                             (torch.bool, torch.uint8)):
        raise ValueError(f"mask must be ({Mp},) bool or uint8, got "
                         f"{tuple(mask.shape)} {mask.dtype}")


def _scan_plain(q: torch.Tensor, items_packed: torch.Tensor, num_bins: int,
                bound: int, mask: Optional[torch.Tensor],
                scales: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both kernels' function in plain PyTorch, one catalog block at a time
    (the reference's per-grid-step fold): (vals (B, 2L) float32, ids
    (B, 2L) int32). Scores are float32 products of the bf16 (or int8)
    inputs, times ``scales`` for an int8 catalog, so on a card this needs
    TF32 off."""
    _check(q, items_packed, num_bins, bound, mask, scales)
    B = q.shape[0]
    L = num_bins
    dev = q.device
    m1 = torch.full((B, L), NEG_INF, device=dev)
    m2 = torch.full((B, L), NEG_INF, device=dev)
    id1 = torch.zeros((B, L), dtype=torch.int32, device=dev)
    id2 = torch.zeros((B, L), dtype=torch.int32, device=dev)
    qf = q.float()
    lane = torch.arange(L, dtype=torch.int32, device=dev)
    for b in range(-(-bound // L)):  # later blocks score -inf: no effect
        s = qf @ items_packed[:, b * L:(b + 1) * L].float()
        if scales is not None:
            s = s * scales[b * L:(b + 1) * L]
        gid = b * L + lane
        ok = gid < bound
        if mask is not None:
            ok = ok & mask[b * L:(b + 1) * L].bool()
        s = torch.where(ok, s, NEG_INF)
        better1 = s > m1
        loser_v = torch.where(better1, m1, s)
        loser_i = torch.where(better1, id1, gid)
        m1 = torch.where(better1, s, m1)
        id1 = torch.where(better1, gid, id1)
        better2 = loser_v > m2
        m2 = torch.where(better2, loser_v, m2)
        id2 = torch.where(better2, loser_i, id2)
    return torch.cat([m1, m2], dim=-1), torch.cat([id1, id2], dim=-1)


def fused_scan_plain(q: torch.Tensor, items_packed: torch.Tensor,
                     num_bins: int, bound: int,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's function in plain PyTorch."""
    return _scan_plain(q, items_packed, num_bins, bound, mask, None)


def typed_library(name: str = "fused_scan") -> ctypes.CDLL:
    """The built kernel library ``name`` (``fused_scan``, the bf16 scan, or
    ``fused_scan_int8``) with its C signatures declared."""
    lib = load_library(name)
    if not getattr(lib, "_esr_typed", False):
        ptr = ctypes.c_void_p
        # (device, q, items[, scales], mask, vals, ids, B, D, Mp, L, nblk,
        #  bound[, cluster], stream): the bf16 scan takes its cluster size
        int8 = name == "fused_scan_int8"
        fn = getattr(lib, f"esr_{name}")
        fn.argtypes = [ctypes.c_int, *[ptr] * (6 if int8 else 5),
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       *([] if int8 else [ctypes.c_int]), ptr]
        fn.restype = ctypes.c_int
        lib.esr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.esr_cuda_error_string.restype = ctypes.c_char_p
        lib._esr_typed = True
    return lib


def _launch(q: torch.Tensor, items_packed: torch.Tensor, num_bins: int,
            bound: int, mask: Optional[torch.Tensor],
            scales: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs and launch the bf16 (``scales`` None) or the int8
    kernel on the current stream, the tuned one or the generic one by
    :func:`variant`; no synchronisation."""
    _check(q, items_packed, num_bins, bound, mask, scales)
    tensors = [t for t in (q, items_packed, mask, scales) if t is not None]
    dev = items_packed.device
    if any(not t.is_cuda or t.device != dev for t in tensors):
        raise ValueError("the fused scan kernel needs every tensor on one "
                         "CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("the fused scan kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (items_packed, mask, scales)
           if t is not None):
        raise ValueError("items_packed, mask and scales must be 16-byte "
                         "aligned")
    B, D = q.shape
    L = num_bins
    Mp = items_packed.shape[1]
    if B == 0:
        return (torch.empty((0, 2 * L), dtype=torch.float32, device=dev),
                torch.empty((0, 2 * L), dtype=torch.int32, device=dev))
    if variant(D) == "generic":
        return fused_generic.scan_cuda(q, items_packed, L, bound, mask,
                                       scales)
    if q.data_ptr() % 4:  # the tuned kernels read q as pairs of bf16
        raise ValueError("q must be 4-byte aligned")
    vals = torch.empty((B, 2 * L), dtype=torch.float32, device=dev)
    ids = torch.empty((B, 2 * L), dtype=torch.int32, device=dev)
    name, counter = (("fused_scan", LAUNCHES) if scales is None
                     else ("fused_scan_int8", LAUNCHES_INT8))
    lib = typed_library(name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    head = [index, q.data_ptr(), items_packed.data_ptr()]
    tail = [launch_plan(B, L).cluster] if scales is None else []
    if scales is not None:
        head.append(scales.data_ptr())
    rc = getattr(lib, f"esr_{name}")(
        *head, mask.data_ptr() if mask is not None else None, vals.data_ptr(),
        ids.data_ptr(), B, D, Mp, L, -(-bound // L), bound, *tail, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.esr_cuda_error_string(rc).decode()})")
    counter.count += 1
    return vals, ids


def fused_scan_cuda(q: torch.Tensor, items_packed: torch.Tensor,
                    num_bins: int, bound: int,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the bf16 kernel (tuned or generic, by :func:`variant`) on the
    current stream; no synchronisation."""
    return _launch(q, items_packed, num_bins, bound, mask, None)


def fused_scan(q: torch.Tensor, items_packed: torch.Tensor, num_bins: int,
               bound: int, mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin top-2 candidates: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (raising when it cannot launch)."""
    if items_packed.device.type == "cpu":
        return fused_scan_plain(q, items_packed, num_bins, bound, mask)
    return fused_scan_cuda(q, items_packed, num_bins, bound, mask)


def fused_scan_int8_plain(q: torch.Tensor, codes: torch.Tensor,
                          scales: torch.Tensor, num_bins: int, bound: int,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 kernel's function in plain PyTorch."""
    return _scan_plain(q, codes, num_bins, bound, mask, scales)


def fused_scan_int8_cuda(q: torch.Tensor, codes: torch.Tensor,
                         scales: torch.Tensor, num_bins: int, bound: int,
                         mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the int8 kernel (tuned or generic, by :func:`variant`) on the
    current stream; no synchronisation."""
    if scales is None:
        raise ValueError("the int8 scan needs the per-item scales")
    return _launch(q, codes, num_bins, bound, mask, scales)


def fused_scan_int8(q: torch.Tensor, codes: torch.Tensor,
                    scales: torch.Tensor, num_bins: int, bound: int,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin top-2 candidates over an int8 catalog: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors (raising when it
    cannot launch)."""
    if codes.device.type == "cpu":
        return fused_scan_int8_plain(q, codes, scales, num_bins, bound, mask)
    return fused_scan_int8_cuda(q, codes, scales, num_bins, bound, mask)
