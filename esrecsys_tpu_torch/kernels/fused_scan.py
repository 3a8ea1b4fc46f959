"""Fused scan+select: the CUDA kernel's wrapper and its plain PyTorch version.

``fused_scan`` replaces the TPU kernel ``_kernel`` of
``esrecsys_tpu/retrieval/fused.py`` (launched by ``binned_candidates``).
For each query and catalog item g < ``bound`` that the optional mask
admits, it scores ``q . item_g`` with bf16 inputs and float32 sums; item g
falls in bin ``g mod L`` and each bin keeps its top two (value, id) pairs,
folded over the catalog blocks in ascending order with a strict ``>``
(the earlier block wins ties; slots never filled keep (-inf, 0)).

A CPU tensor takes :func:`fused_scan_plain`; a CUDA tensor launches the
kernel in ``csrc/fused_scan.cu`` or raises. ``LAUNCHES.count`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from esrecsys_tpu_torch.kernels.build import load_library

NEG_INF = float("-inf")
SUPPORTED_DIMS = (16, 32, 64, 128)  # the kernel's instantiations


class LaunchCounter:
    """Launches of one kernel: ``count`` grows by one per launch."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


LAUNCHES = LaunchCounter()


def _check(q: torch.Tensor, items_packed: torch.Tensor, num_bins: int,
           bound: int, mask: Optional[torch.Tensor]) -> None:
    if q.dim() != 2 or items_packed.dim() != 2:
        raise ValueError(f"q {tuple(q.shape)} and items_packed "
                         f"{tuple(items_packed.shape)} must be 2-D")
    if q.dtype != torch.bfloat16 or items_packed.dtype != torch.bfloat16:
        raise TypeError(f"q ({q.dtype}) and items_packed "
                        f"({items_packed.dtype}) must be bfloat16")
    D, Mp = items_packed.shape
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


def fused_scan_plain(q: torch.Tensor, items_packed: torch.Tensor,
                     num_bins: int, bound: int,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, one catalog block at a time
    (the reference's per-grid-step fold): (vals (B, 2L) float32, ids
    (B, 2L) int32). Scores are float32 products of the bf16 inputs, so on
    a card this needs TF32 off."""
    _check(q, items_packed, num_bins, bound, mask)
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


def typed_library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("fused_scan")
    if not getattr(lib, "_esr_typed", False):
        ptr = ctypes.c_void_p
        lib.esr_fused_scan.argtypes = [
            ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ptr]
        lib.esr_fused_scan.restype = ctypes.c_int
        lib.esr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.esr_cuda_error_string.restype = ctypes.c_char_p
        lib._esr_typed = True
    return lib


def fused_scan_cuda(q: torch.Tensor, items_packed: torch.Tensor,
                    num_bins: int, bound: int,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream; no synchronisation."""
    _check(q, items_packed, num_bins, bound, mask)
    tensors = [q, items_packed] + ([mask] if mask is not None else [])
    dev = items_packed.device
    if any(not t.is_cuda or t.device != dev for t in tensors):
        raise ValueError("fused_scan_cuda needs every tensor on one CUDA "
                         "device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("fused_scan_cuda needs contiguous tensors")
    if items_packed.data_ptr() % 16 or (mask is not None
                                        and mask.data_ptr() % 16):
        raise ValueError("items_packed and mask must be 16-byte aligned")
    if q.data_ptr() % 4:  # the kernel reads q as pairs of bf16
        raise ValueError("q must be 4-byte aligned")
    B, D = q.shape
    if D not in SUPPORTED_DIMS:
        raise ValueError(f"the CUDA kernel is built for dims "
                         f"{SUPPORTED_DIMS}, not {D}")
    L = num_bins
    Mp = items_packed.shape[1]
    vals = torch.empty((B, 2 * L), dtype=torch.float32, device=dev)
    ids = torch.empty((B, 2 * L), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, ids
    lib = typed_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.esr_fused_scan(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        q.data_ptr(), items_packed.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        vals.data_ptr(), ids.data_ptr(), B, D, Mp, L, -(-bound // L), bound,
        stream)
    if rc != 0:
        raise RuntimeError(f"fused_scan launch failed: CUDA error {rc} "
                           f"({lib.esr_cuda_error_string(rc).decode()})")
    LAUNCHES.count += 1
    return vals, ids


def fused_scan(q: torch.Tensor, items_packed: torch.Tensor, num_bins: int,
               bound: int, mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin top-2 candidates: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (raising when it cannot launch)."""
    if items_packed.device.type == "cpu":
        return fused_scan_plain(q, items_packed, num_bins, bound, mask)
    return fused_scan_cuda(q, items_packed, num_bins, bound, mask)
