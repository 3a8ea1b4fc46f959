"""Fused playlist-affinity scan+select: the CUDA kernel's wrapper and its
plain PyTorch version.

``fused_affinity`` replaces the TPU kernel ``_affinity_kernel`` of
``esrecsys_tpu/retrieval/fused.py`` (launched by
``binned_affinity_candidates``). For each query b, with context slots
``q[b, c]``, and each catalog item g < ``bound``:

    score = max_c (q[b, c] . item_g) + 0.1 [album[g] in album_ctx[b]]
                                      + 0.1 [artist[g] in artist_ctx[b]]

with bf16 inputs and float32 sums, the boosts added in float32 after the
max; items at or past ``bound`` score -inf. Item g falls in bin
``g mod L`` and each bin keeps its top two (value, id) pairs, folded over
the catalog blocks in ascending order with a strict ``>`` (the earlier
block wins ties; slots never filled keep (-inf, 0)).

A CPU tensor takes :func:`fused_affinity_plain`; a CUDA tensor launches the
kernel in ``csrc/fused_affinity.cu`` or raises. ``LAUNCHES.count`` counts
the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from esrecsys_tpu_torch.kernels.build import LaunchCounter, load_library

NEG_INF = float("-inf")
SUPPORTED_DIMS = (32, 64, 128)  # the kernel's instantiations
MAX_SLOTS = 8                   # context slots the kernel takes

LAUNCHES = LaunchCounter()


def _check(q: torch.Tensor, items_packed: torch.Tensor, album: torch.Tensor,
           artist: torch.Tensor, album_ctx: torch.Tensor,
           artist_ctx: torch.Tensor, num_bins: int, bound: int) -> None:
    if q.dim() != 3 or items_packed.dim() != 2:
        raise ValueError(f"q {tuple(q.shape)} must be (B, C, D) and "
                         f"items_packed {tuple(items_packed.shape)} (D, Mp)")
    if q.dtype != torch.bfloat16 or items_packed.dtype != torch.bfloat16:
        raise TypeError(f"q ({q.dtype}) and items_packed "
                        f"({items_packed.dtype}) must be bfloat16")
    B, C, D = q.shape
    Dc, Mp = items_packed.shape
    if D != Dc:
        raise ValueError(f"q dim {D} != catalog dim {Dc}")
    if album.shape != (Mp,) or artist.shape != (Mp,):
        raise ValueError(f"album {tuple(album.shape)} and artist "
                         f"{tuple(artist.shape)} must be ({Mp},)")
    if album_ctx.shape != (B, C) or artist_ctx.shape != (B, C):
        raise ValueError(f"album_ctx {tuple(album_ctx.shape)} and "
                         f"artist_ctx {tuple(artist_ctx.shape)} must be "
                         f"({B}, {C})")
    if any(t.dtype != torch.int32
           for t in (album, artist, album_ctx, artist_ctx)):
        raise TypeError("album, artist, album_ctx and artist_ctx must be "
                        "int32")
    if num_bins < 1 or num_bins % 128 or Mp % num_bins:
        raise ValueError(f"num_bins {num_bins} must be a positive multiple "
                         f"of 128 dividing Mp={Mp}")
    if not 0 <= bound <= Mp:
        raise ValueError(f"bound {bound} outside [0, {Mp}]")


def fused_affinity_plain(q: torch.Tensor, items_packed: torch.Tensor,
                         album: torch.Tensor, artist: torch.Tensor,
                         album_ctx: torch.Tensor, artist_ctx: torch.Tensor,
                         num_bins: int, bound: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, one catalog block at a time
    (the reference's per-grid-step fold): (vals (B, 2L) float32, ids
    (B, 2L) int32). Scores are float32 products of the bf16 inputs, so on
    a card this needs TF32 off."""
    _check(q, items_packed, album, artist, album_ctx, artist_ctx, num_bins,
           bound)
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
        cols = slice(b * L, (b + 1) * L)
        s = torch.matmul(qf, items_packed[:, cols].float()).amax(1)
        in_alb = (album_ctx[:, :, None] == album[None, None, cols]).any(1)
        in_art = (artist_ctx[:, :, None] == artist[None, None, cols]).any(1)
        s = s + in_alb.float() * 0.1
        s = s + in_art.float() * 0.1
        gid = b * L + lane
        s = torch.where(gid < bound, s, NEG_INF)
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
    lib = load_library("fused_affinity")
    if not getattr(lib, "_esr_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.esr_fused_affinity.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
            ctypes.c_longlong, i32, i32, i32, ptr]
        lib.esr_fused_affinity.restype = ctypes.c_int
        lib.esr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.esr_cuda_error_string.restype = ctypes.c_char_p
        lib._esr_typed = True
    return lib


def fused_affinity_cuda(q: torch.Tensor, items_packed: torch.Tensor,
                        album: torch.Tensor, artist: torch.Tensor,
                        album_ctx: torch.Tensor, artist_ctx: torch.Tensor,
                        num_bins: int, bound: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream; no synchronisation."""
    _check(q, items_packed, album, artist, album_ctx, artist_ctx, num_bins,
           bound)
    tensors = (q, items_packed, album, artist, album_ctx, artist_ctx)
    dev = items_packed.device
    if any(not t.is_cuda or t.device != dev for t in tensors):
        raise ValueError("fused_affinity_cuda needs every tensor on one "
                         "CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("fused_affinity_cuda needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (items_packed, album, artist)):
        raise ValueError("items_packed, album and artist must be 16-byte "
                         "aligned")
    if q.data_ptr() % 4:  # the kernel reads q as pairs of bf16
        raise ValueError("q must be 4-byte aligned")
    B, C, D = q.shape
    if D not in SUPPORTED_DIMS:
        raise ValueError(f"the CUDA kernel is built for dims "
                         f"{SUPPORTED_DIMS}, not {D}")
    if not 1 <= C <= MAX_SLOTS:
        raise ValueError(f"the CUDA kernel takes 1 to {MAX_SLOTS} context "
                         f"slots, not {C}")
    L = num_bins
    Mp = items_packed.shape[1]
    vals = torch.empty((B, 2 * L), dtype=torch.float32, device=dev)
    ids = torch.empty((B, 2 * L), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, ids
    lib = typed_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.esr_fused_affinity(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        q.data_ptr(), items_packed.data_ptr(), album.data_ptr(),
        artist.data_ptr(), album_ctx.data_ptr(), artist_ctx.data_ptr(),
        vals.data_ptr(), ids.data_ptr(), B, C, D, Mp, L, -(-bound // L),
        bound, stream)
    if rc != 0:
        raise RuntimeError(f"fused_affinity launch failed: CUDA error {rc} "
                           f"({lib.esr_cuda_error_string(rc).decode()})")
    LAUNCHES.count += 1
    return vals, ids


def fused_affinity(q: torch.Tensor, items_packed: torch.Tensor,
                   album: torch.Tensor, artist: torch.Tensor,
                   album_ctx: torch.Tensor, artist_ctx: torch.Tensor,
                   num_bins: int, bound: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin top-2 affinity candidates: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (raising when it cannot
    launch)."""
    if items_packed.device.type == "cpu":
        return fused_affinity_plain(q, items_packed, album, artist,
                                    album_ctx, artist_ctx, num_bins, bound)
    return fused_affinity_cuda(q, items_packed, album, artist, album_ctx,
                               artist_ctx, num_bins, bound)
