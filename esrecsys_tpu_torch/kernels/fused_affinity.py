"""Fused playlist-affinity scan+select: the CUDA kernel's wrapper and its
plain PyTorch version.

``fused_affinity`` replaces the TPU kernel ``_affinity_kernel`` of
``esrecsys_tpu/retrieval/fused.py:453`` (launched by
``binned_affinity_candidates``). For each query b, with context slots
``q[b, c]``, and each catalog item g < ``bound``:

    score = max_c (q[b, c] . item_g) + 0.1 [album[g] in album_ctx[b]]
                                      + 0.1 [artist[g] in artist_ctx[b]]

with bf16 inputs and float32 sums, the boosts added in float32 after the
max; items at or past ``bound`` score -inf. Item g falls in bin
``g mod L`` and each bin keeps its top two (value, id) pairs, folded over
the catalog blocks in ascending order with a strict ``>`` (the earlier
block wins ties; slots never filled keep (-inf, 0)).

The kernel (``csrc/fused_affinity.cu``) is bound by operations: 2.965e12
bf16 operations at the eval shape, 3.0 ms at the H100's 989 TFLOP/s. A
CTA scores 64 bins against 64 queries with ``wgmma`` (the TMA-copied
catalog tile as A, all context slots' queries as B, both read from shared
memory), takes the max over the slots inside each thread, reads the
boosts as one bit of a per-item mask of the CTA's queries (a hash table of
the CTA's context ids, looked up once per item by the producer warps:
:func:`membership_masks` is its plain twin) and folds branch-free while
the next block's products run. The header of the source and PERF.md hold
its measured time.

A CPU tensor takes :func:`fused_affinity_plain`; a CUDA tensor launches a
kernel or raises. :func:`variant` picks it: the tuned kernel above at D in
``SUPPORTED_DIMS`` with 1 to ``MAX_SLOTS`` context slots, the kernel of
``csrc/fused_generic.cu`` at any other D and C
(:mod:`~esrecsys_tpu_torch.kernels.fused_generic`, whose
``LAUNCHES_AFFINITY`` counts its launches). ``LAUNCHES.count`` counts the
tuned kernel's launches. The kernels allocate nothing: the wrappers
allocate the outputs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from esrecsys_tpu_torch.kernels import fused_generic
from esrecsys_tpu_torch.kernels.build import LaunchCounter, load_library

NEG_INF = float("-inf")
SUPPORTED_DIMS = (32, 64, 128)  # the tuned kernel's instantiations
MAX_SLOTS = 8                   # context slots the tuned kernel takes
TILE_QUERIES = 64               # queries per CTA: the bits of a mask
TABLE_BITS = 10                 # the kernel's hash table: 2^10 slots a kind
_HASH = 2654435761              # the table's multiplicative hash

LAUNCHES = LaunchCounter()


def variant(dim: int, slots: int) -> str:
    """The kernel a CUDA affinity scan launches at width ``dim`` with
    ``slots`` context slots: ``"tuned"`` at the tuned kernel's dims with 1
    to ``MAX_SLOTS`` slots, ``"generic"`` at every other positive dim and
    slot count."""
    if dim < 1 or slots < 1:
        raise ValueError(f"no fused affinity kernel for dim {dim}, "
                         f"{slots} context slots")
    if dim in SUPPORTED_DIMS and slots <= MAX_SLOTS:
        return "tuned"
    return "generic"


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


def table_slot(ids: torch.Tensor) -> torch.Tensor:
    """The kernel's hash of int32 ids (int64 out): the top ``TABLE_BITS``
    bits of ``uint32(id) * 2654435761 mod 2^32``."""
    u = ids.to(torch.int64) & 0xFFFFFFFF
    return ((u * _HASH) & 0xFFFFFFFF) >> (32 - TABLE_BITS)


def colliding_ids(n: int, slot: int = 0) -> torch.Tensor:
    """``n`` (<= 2^22) distinct int32 ids that all hash to ``slot``: the
    table's worst case, one probe chain."""
    inv = pow(_HASH, -1, 1 << 32)
    u = torch.tensor([(inv * ((slot << (32 - TABLE_BITS)) + r)) % (1 << 32)
                      for r in range(n)], dtype=torch.int64)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def membership_masks(ctx: torch.Tensor, item_ids: torch.Tensor
                     ) -> torch.Tensor:
    """The kernel's membership lookup in plain PyTorch, one id kind:
    (ceil(B / 64), M) int64 whose entry [t, g] has bit i set when query
    64 t + i holds ``item_ids[g]`` among its context ids ``ctx`` (B, C).

    As in the kernel, each 64-query tile's ids go into an open-addressing
    table of 2^TABLE_BITS slots keyed by the id tagged with bit 32 (so
    every int32 is a key and 0 marks an empty slot), probed linearly from
    :func:`table_slot`, whose value ORs the holders' query bits; each item
    id is then looked up the same way. The table holds at most 64 x 8 =
    512 keys, so every probe meets an empty slot."""
    B, C = ctx.shape
    T = 1 << TABLE_BITS
    ctx = ctx.cpu()
    tags = (item_ids.cpu().to(torch.int64) & 0xFFFFFFFF) | (1 << 32)
    start = table_slot(item_ids.cpu())
    out = []
    for t0 in range(0, B, TILE_QUERIES):
        keys, masks = [0] * T, [0] * T
        tile = ctx[t0:t0 + TILE_QUERIES]
        for qi, (row, slots) in enumerate(zip(tile.tolist(),
                                              table_slot(tile).tolist())):
            for key, s in zip(row, slots):
                tag = (key & 0xFFFFFFFF) | (1 << 32)
                while keys[s] not in (0, tag):
                    s = (s + 1) % T
                keys[s] = tag
                masks[s] |= 1 << qi
        keys_t = torch.tensor(keys, dtype=torch.int64)
        masks_t = torch.tensor([m - (1 << 64) if m >= 1 << 63 else m
                                for m in masks], dtype=torch.int64)
        found = torch.zeros(tags.shape, dtype=torch.int64)
        live = torch.ones(tags.shape, dtype=torch.bool)
        s = start.clone()
        while bool(live.any()):
            k = keys_t[s]
            hit = live & (k == tags)
            found = torch.where(hit, masks_t[s], found)
            live = live & ~hit & (k != 0)
            s = torch.where(live, (s + 1) % T, s)
        out.append(found)
    return torch.stack(out) if out else torch.zeros((0, tags.shape[0]),
                                                    dtype=torch.int64)


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
    """Launch a CUDA kernel (tuned or generic, by :func:`variant`) on the
    current stream; no synchronisation."""
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
    B, C, D = q.shape
    L = num_bins
    Mp = items_packed.shape[1]
    if B == 0:
        return (torch.empty((0, 2 * L), dtype=torch.float32, device=dev),
                torch.empty((0, 2 * L), dtype=torch.int32, device=dev))
    if variant(D, C) == "generic":
        return fused_generic.affinity_cuda(q, items_packed, album, artist,
                                           album_ctx, artist_ctx, L, bound)
    if q.data_ptr() % 4:  # the tuned kernel reads q as pairs of bf16
        raise ValueError("q must be 4-byte aligned")
    vals = torch.empty((B, 2 * L), dtype=torch.float32, device=dev)
    ids = torch.empty((B, 2 * L), dtype=torch.int32, device=dev)
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
