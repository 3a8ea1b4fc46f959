"""Row gather and pooled lookup: the CUDA kernel's wrapper and its plain
PyTorch version.

``gather_pool`` replaces the TPU kernel ``_pool_kernel`` of
``esrecsys_tpu/ops/lookup.py``. For each row b of ``ids`` (B, K) it sums
``table[clamp(ids[b, k], 0, R-1)]`` over the K slots whose id is not
``mask_id``, in float32; ``mean`` divides by ``max(count, 1)``. K=1 with
``mask_id=-1`` is the plain row gather of the train step. The table is
float32 or bf16; bf16 rows are widened exactly to float32 before the sum,
as the reference's callers widen ``take`` of bf16 rows.

The kernel (``csrc/gather_pool.cu``) has four instantiations, which
:func:`launch_plan` picks: float32 rows read as 16-byte pieces (D a
multiple of 4, table 16-byte aligned), bf16 rows read as 16-byte pieces of
8 (D a multiple of 8, table 16-byte aligned), and narrow rows (any D, any
alignment) of float32 or bf16, read one element a lane. The plan also
gives the grid, from the card's SM count: passes of rows with U rows a
lane in flight, one pass a warp, and, for a small launch, one-warp CTAs
and a smaller U so that it spans min(warps needed, SMs) CTAs.

A CPU tensor takes :func:`gather_pool_plain`; a CUDA tensor launches the
kernel in ``csrc/gather_pool.cu`` or raises. ``LAUNCHES.count`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from esrecsys_tpu_torch.kernels.build import LaunchCounter, load_library

LAUNCHES = LaunchCounter()

# the instantiations, as csrc/gather_pool.cu numbers them
F32X4, BF16X8, NARROW_F32, NARROW_BF16 = 0, 1, 2, 3
INSTANTIATIONS = {F32X4: "f32x4", BF16X8: "bf16x8", NARROW_F32: "narrow_f32",
                  NARROW_BF16: "narrow_bf16"}
DTYPES = (torch.float32, torch.bfloat16)
# elements a lane reads at once, by instantiation
PIECE_ELEMS = {F32X4: 4, BF16X8: 8, NARROW_F32: 1, NARROW_BF16: 1}

# the kernel's limits, as csrc/gather_pool.cu has them
MAX_THREADS = 256          # threads a CTA
MAX_ROWS_PER_LANE = 8      # U
# rows a warp keeps in flight a pass: 32, or 16 where a row is under 128
# bytes (random rows of 64 bytes ran faster at 16 than at 32 on an H100,
# rows of 128 bytes slower: PERF.md)
ROWS_IN_FLIGHT = 32
NARROW_ROWS_IN_FLIGHT = 16
ROW_BYTES_FULL = 128


def _check(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table {tuple(table.shape)} and ids "
                         f"{tuple(ids.shape)} must be 2-D")
    if table.dtype not in DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if table.shape[0] < 1:
        raise ValueError("table has no rows")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device}, ids on {ids.device}")


def gather_pool_plain(table: torch.Tensor, ids: torch.Tensor, mean: bool,
                      mask_id: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (B, D) float32."""
    _check(table, ids)
    valid = ids != mask_id
    rows = table[ids.clamp(0, table.shape[0] - 1).long()].float()  # (B, K, D)
    acc = torch.where(valid[..., None], rows, 0.0).sum(1)
    if mean:
        acc = acc / valid.sum(1, keepdim=True).clamp(min=1).float()
    return acc


class GatherPlan(NamedTuple):
    """One launch. ``kind`` is the instantiation; the grid is ``ctas`` CTAs
    of ``threads``. A row of ``pieces`` pieces is read by ``lanes`` =
    min(pieces, 32) lanes side by side and cut into ``segments`` =
    ceil(pieces / 32) virtual rows; a warp instruction covers ``groups`` =
    32 // lanes of them. Warp w (CTA c's warp i is w = c * threads / 32 +
    i) takes pass w, if w < ``passes``; pass p covers virtual rows [p * rows_per_pass, (p + 1) *
    rows_per_pass), ``rows_per_lane`` (U) of them a lane: lane l's u-th
    is p * rows_per_pass + u * groups + l // lanes (for l // lanes <
    groups), its piece (v % segments) * lanes + l % lanes of row v //
    segments. U is 1, 2, 4 or 8; a pooled launch (K != 1) has U = 1."""
    kind: int
    ctas: int
    threads: int
    rows_per_lane: int
    pieces: int
    lanes: int
    segments: int
    groups: int
    rows_per_pass: int
    passes: int


def instantiation(dim: int, dtype: torch.dtype, table_ptr: int) -> int:
    """The instantiation for rows of ``dim`` elements of ``dtype``: a
    16-byte piece a lane where the rows cut into whole pieces and the
    table is 16-byte aligned, one element a lane otherwise."""
    aligned = table_ptr % 16 == 0
    if dtype == torch.bfloat16:
        return BF16X8 if dim % 8 == 0 and aligned else NARROW_BF16
    return F32X4 if dim % 4 == 0 and aligned else NARROW_F32


def launch_plan(dim: int, dtype: torch.dtype, table_ptr: int,
                batch: int = 1, pool: int = 1, sms: int = 132) -> GatherPlan:
    """The launch over ``batch`` rows of ``pool`` ids each on a card of
    ``sms`` SMs. U, a power of two, starts at the most a lane holds (8;
    at most ROWS_IN_FLIGHT rows a pass, NARROW_ROWS_IN_FLIGHT for rows
    under ROW_BYTES_FULL bytes; 1 for rows of one piece and for pooled
    launches) and halves while the launch needs fewer warps than the card
    has SMs. A CTA takes passes // sms warps (1 to 8), one pass a warp.
    A pure function of its arguments."""
    if batch < 1 or dim < 1 or sms < 1:
        raise ValueError(f"no launch for batch {batch}, dim {dim} on {sms} "
                         f"SMs")
    kind = instantiation(dim, dtype, table_ptr)
    pieces = dim // PIECE_ELEMS[kind]
    lanes = min(pieces, 32)
    segments = -(-pieces // 32)
    groups = 32 // lanes
    vrows = batch * segments
    if pool != 1 or groups == 32:
        u = 1
    else:  # a power of two: ROWS_IN_FLIGHT rows a pass at most
        row_bytes = dim * (2 if dtype == torch.bfloat16 else 4)
        rows = (ROWS_IN_FLIGHT if row_bytes >= ROW_BYTES_FULL
                else NARROW_ROWS_IN_FLIGHT)
        cap = max(1, min(MAX_ROWS_PER_LANE, rows // groups))
        u = 1 << (cap.bit_length() - 1)
    while u > 1 and -(-vrows // (groups * u)) < sms:
        u //= 2
    per_pass = groups * u
    passes = -(-vrows // per_pass)
    warps_per_cta = max(1, min(MAX_THREADS // 32, passes // sms))
    return GatherPlan(kind, -(-passes // warps_per_cta), 32 * warps_per_cta,
                      u, pieces, lanes, segments, groups, per_pass, passes)


def typed_library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("gather_pool")
    if not getattr(lib, "_esr_typed", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.esr_gather_pool.argtypes = [i32, ptr, ptr, ptr, i64, i32, i32,
                                        i64, i32, i32, i32, i32, i32, i32,
                                        ptr]
        lib.esr_gather_pool.restype = ctypes.c_int
        lib.esr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.esr_cuda_error_string.restype = ctypes.c_char_p
        lib._esr_typed = True
    return lib


def gather_pool_cuda(table: torch.Tensor, ids: torch.Tensor, mean: bool,
                     mask_id: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; no synchronisation."""
    _check(table, ids)
    dev = table.device
    if not table.is_cuda:
        raise ValueError("gather_pool_cuda needs CUDA tensors")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("gather_pool_cuda needs contiguous tensors")
    R, D = table.shape
    B, K = ids.shape
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if B == 0 or D == 0:
        return out
    lib = typed_library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    plan = launch_plan(D, table.dtype, table.data_ptr(), B, K, sms)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.esr_gather_pool(
        index, table.data_ptr(), ids.data_ptr(), out.data_ptr(), B, K, D, R,
        mask_id, int(mean), plan.kind, plan.ctas, plan.threads,
        plan.rows_per_lane, stream)
    if rc != 0:
        raise RuntimeError(f"gather_pool launch failed: CUDA error {rc} "
                           f"({lib.esr_cuda_error_string(rc).decode()})")
    LAUNCHES.add(INSTANTIATIONS[plan.kind])
    return out


def gather_pool(table: torch.Tensor, ids: torch.Tensor, mean: bool = False,
                mask_id: int = -1) -> torch.Tensor:
    """Pooled row lookup: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (raising when it cannot launch)."""
    if table.device.type == "cpu":
        return gather_pool_plain(table, ids, mean, mask_id)
    return gather_pool_cuda(table, ids, mean, mask_id)
