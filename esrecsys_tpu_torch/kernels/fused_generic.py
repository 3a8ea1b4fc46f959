"""The fused scans and the fused affinity at any width: the wrappers of
``csrc/fused_generic.cu``.

The tuned kernels are built for a few widths: ``fused_scan`` and
``fused_scan_int8`` for D in {16, 32, 64, 128}, ``fused_affinity`` for D
in {32, 64, 128} with at most 8 context slots. The TPU kernels they replace
(``esrecsys_tpu/retrieval/fused.py`` ``_kernel`` :191, its int8 branch
:212-225, ``_affinity_kernel`` :453) take any D and C. These wrappers
launch the kernels of ``csrc/fused_generic.cu`` that do too; the
dispatchers of :mod:`~esrecsys_tpu_torch.kernels.fused_scan` and
:mod:`~esrecsys_tpu_torch.kernels.fused_affinity` call them for every shape
the tuned kernels lack (their ``variant`` functions), and only for CUDA
tensors whose other checks have passed there.

The kernels read the (D, Mp) catalog as it lies (their TMA copies fill
rows past D with zeros); the queries are padded here to ``ceil16(D)``
columns with zeros (B x C x D values, cheap), which add exactly 0 to a
float32 sum, and the affinity's are laid out slots first, (C, B, Dq), so
that a tile's rows of one slot are neighbours.
Each entry has its own launch counter: ``LAUNCHES_SCAN``,
``LAUNCHES_SCAN_INT8``, ``LAUNCHES_AFFINITY``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from esrecsys_tpu_torch.kernels.build import LaunchCounter, load_library

LAUNCHES_SCAN = LaunchCounter()
LAUNCHES_SCAN_INT8 = LaunchCounter()
LAUNCHES_AFFINITY = LaunchCounter()


def padded_dim(dim: int) -> int:
    """The kernels' query width: ``dim`` rounded up to a multiple of 16."""
    return -(-dim // 16) * 16


def pad_queries(q: torch.Tensor) -> torch.Tensor:
    """``q`` (..., D) bf16 as the kernels read it: (..., ceil16(D)),
    contiguous and 16-byte aligned, the added columns zero. A tensor that
    already is comes back as it is."""
    D = q.shape[-1]
    Dq = padded_dim(D)
    if Dq == D and q.is_contiguous() and q.data_ptr() % 16 == 0:
        return q
    out = q.new_zeros(q.shape[:-1] + (Dq,))
    out[..., :D] = q
    return out


def typed_library() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = load_library("fused_generic")
    if not getattr(lib, "_esr_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # (device, q, items[, scales], mask, vals, ids, B, D, Dq, Mp, L,
        #  nblk, bound, stream)
        lib.esr_fused_scan_generic.argtypes = [
            i32, *[ptr] * 5, i32, i32, i32, i64, i32, i32, i32, ptr]
        lib.esr_fused_scan_int8_generic.argtypes = [
            i32, *[ptr] * 6, i32, i32, i32, i64, i32, i32, i32, ptr]
        # (device, q, items, album, artist, album_ctx, artist_ctx, vals,
        #  ids, B, C, D, Dq, Mp, L, nblk, bound, stream)
        lib.esr_fused_affinity_generic.argtypes = [
            i32, *[ptr] * 8, i32, i32, i32, i32, i64, i32, i32, i32, ptr]
        for fn in (lib.esr_fused_scan_generic,
                   lib.esr_fused_scan_int8_generic,
                   lib.esr_fused_affinity_generic):
            fn.restype = ctypes.c_int
        lib.esr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.esr_cuda_error_string.restype = ctypes.c_char_p
        lib._esr_typed = True
    return lib


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _raise_on(lib: ctypes.CDLL, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.esr_cuda_error_string(rc).decode()})")


def scan_cuda(q: torch.Tensor, items_packed: torch.Tensor, num_bins: int,
              bound: int, mask: Optional[torch.Tensor],
              scales: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``fused_scan_generic`` (``scales`` None: a bf16 catalog) or
    ``fused_scan_int8_generic`` on the current stream; no synchronisation.
    The caller has checked shapes, types, the device, contiguity and the
    catalog's, mask's and scales' 16-byte alignment; B >= 1."""
    B, D = q.shape
    L = num_bins
    Mp = items_packed.shape[1]
    dev = items_packed.device
    qp = pad_queries(q)
    vals = torch.empty((B, 2 * L), dtype=torch.float32, device=dev)
    ids = torch.empty((B, 2 * L), dtype=torch.int32, device=dev)
    lib = typed_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    mask_ptr = mask.data_ptr() if mask is not None else None
    tail = (vals.data_ptr(), ids.data_ptr(), B, D, qp.shape[1], Mp, L,
            -(-bound // L), bound, stream)
    if scales is None:
        rc = lib.esr_fused_scan_generic(
            _device_index(dev), qp.data_ptr(), items_packed.data_ptr(),
            mask_ptr, *tail)
        _raise_on(lib, "fused_scan_generic", rc)
        LAUNCHES_SCAN.count += 1
    else:
        rc = lib.esr_fused_scan_int8_generic(
            _device_index(dev), qp.data_ptr(), items_packed.data_ptr(),
            scales.data_ptr(), mask_ptr, *tail)
        _raise_on(lib, "fused_scan_int8_generic", rc)
        LAUNCHES_SCAN_INT8.count += 1
    return vals, ids


def affinity_cuda(q: torch.Tensor, items_packed: torch.Tensor,
                  album: torch.Tensor, artist: torch.Tensor,
                  album_ctx: torch.Tensor, artist_ctx: torch.Tensor,
                  num_bins: int, bound: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``fused_affinity_generic`` on the current stream; no
    synchronisation. The caller has checked shapes, types, the device,
    contiguity and the catalog's 16-byte alignment; B >= 1."""
    B, C, D = q.shape
    L = num_bins
    Mp = items_packed.shape[1]
    dev = items_packed.device
    qp = pad_queries(q.transpose(0, 1))  # (C, B, Dq)
    vals = torch.empty((B, 2 * L), dtype=torch.float32, device=dev)
    ids = torch.empty((B, 2 * L), dtype=torch.int32, device=dev)
    lib = typed_library()
    rc = lib.esr_fused_affinity_generic(
        _device_index(dev), qp.data_ptr(), items_packed.data_ptr(),
        album.data_ptr(), artist.data_ptr(), album_ctx.data_ptr(),
        artist_ctx.data_ptr(), vals.data_ptr(), ids.data_ptr(), B, C, D,
        qp.shape[2], Mp, L, -(-bound // L), bound,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, "fused_affinity_generic", rc)
    LAUNCHES_AFFINITY.count += 1
    return vals, ids
