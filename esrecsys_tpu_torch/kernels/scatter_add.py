"""Row scatter-add: the CUDA kernel's wrapper and its plain PyTorch version.

``scatter_add`` replaces the TPU kernel ``_kernel`` of
``esrecsys_tpu/ops/scatter.py``: ``table.at[ids].add(updates)`` with
unsorted ids and duplicates summed. A float32 table sums in float32; a
bf16 table takes float32 updates and adds each one rounded to bf16, as the
reference's ``table.at[ids].add(updates.astype(table.dtype))`` does.
Both versions update ``table`` IN PLACE and return it (the train step adds
into its tables and momentum buffers, so no second table-sized buffer is
made). Ids outside ``[0, R)`` are dropped.

The kernel (``csrc/scatter_add.cu``) adds by float32 reductions in the L2
cache. Rows of 32, 64 or 128 floats with 16-byte aligned ``table`` and
``updates`` take its vector instantiation: a float4 load and one 16-byte
reduction per lane, eight rows per lane in flight, equal ids within a warp
summed in registers first. Every other width, and misaligned pointers,
take its generic instantiation (one float and one scalar reduction per
lane). :func:`launch_plan` picks the instantiation and the grid. Measured
on an NVIDIA H100 80GB HBM3 at a 700 W limit (``chip_smoke.py``), at the
train step's shapes with the L2 cache flushed: about 12.5 us a launch
against 15.6 for the previous design and 22.4 for ``index_add_``.

bf16 tables take the same two shapes of instantiation: 16-byte pieces of
8 bf16 and one ``red.global.add.noftz.v4.bf16x2`` per lane for rows of 32,
64 or 128, with equal ids within a warp merged in float32 (of the
bf16-rounded updates) and rounded once, else a scalar bf16 atomic per
element.

Duplicates are summed in an order that changes from run to run; the plain
version sums them in PyTorch's order. In float32 the two agree to float32
rounding of each duplicate sum. In bf16 a row hit once is bit-equal; a row
hit more than once may differ by a bf16 rounding at each of its adds.

A CPU tensor takes :func:`scatter_add_plain`; a CUDA tensor launches the
kernel or raises. ``LAUNCHES.count`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from esrecsys_tpu_torch.kernels.build import LaunchCounter, load_library

LAUNCHES = LaunchCounter()

# the kernel's CTA size and the rows (vector) or floats (generic) each lane
# takes, as csrc/scatter_add.cu has them
THREADS = 256
PER_LANE = 8
# row widths with a vector instantiation
VECTOR_WIDTHS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def instantiation_name(width: int, dtype: torch.dtype) -> str:
    """The name a launch counts under: ``f32_d64``, ``bf16_generic``..."""
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    return f"{kind}_d{width}" if width else f"{kind}_generic"


def launch_plan(n: int, dim: int, table_ptr: int, updates_ptr: int,
                dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(instantiation, CTAs) of one launch over ``n`` rows of ``dim``
    elements of a ``dtype`` table: the instantiation is ``dim`` for a
    vector one (``dim`` in :data:`VECTOR_WIDTHS`, both pointers 16-byte
    aligned), else 0 for the generic one; the CTAs give each warp one pass
    over its rows. A lane takes a 16-byte piece of a row: 4 floats or 8
    bf16, and at most 32 rows a warp."""
    if dim in VECTOR_WIDTHS and table_ptr % 16 == 0 and updates_ptr % 16 == 0:
        per_piece = 8 if dtype == torch.bfloat16 else 4
        groups = 32 // (dim // per_piece)
        rows_per_lane = min(PER_LANE, 32 // groups)
        rows_per_cta = THREADS // 32 * groups * rows_per_lane
        return dim, -(-n // rows_per_cta)
    return 0, -(-(n * dim) // (THREADS * PER_LANE))


def _check(table: torch.Tensor, ids: torch.Tensor,
           updates: torch.Tensor) -> None:
    if table.dim() != 2 or ids.dim() != 1 or updates.dim() != 2:
        raise ValueError(f"table {tuple(table.shape)} must be 2-D, ids "
                         f"{tuple(ids.shape)} 1-D, updates "
                         f"{tuple(updates.shape)} 2-D")
    if table.dtype not in DTYPES or updates.dtype != torch.float32:
        raise TypeError(f"table ({table.dtype}) must be float32 or bfloat16 "
                        f"and updates ({updates.dtype}) float32")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if updates.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(f"updates {tuple(updates.shape)} must be "
                         f"({ids.shape[0]}, {table.shape[1]})")
    if not table.device == ids.device == updates.device:
        raise ValueError("table, ids and updates must share a device")


def scatter_add_plain(table: torch.Tensor, ids: torch.Tensor,
                      updates: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in place on ``table``: an
    accumulating ``index_put_`` of the updates in the table's dtype."""
    _check(table, ids, updates)
    keep = (ids >= 0) & (ids < table.shape[0])
    idx = ids.long()
    if not bool(keep.all()):
        idx, updates = idx[keep], updates[keep]
    return table.index_put_((idx,), updates.to(table.dtype),
                            accumulate=True)


def typed_library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("scatter_add")
    if not getattr(lib, "_esr_typed", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.esr_scatter_add.argtypes = [i32, ptr, ptr, ptr, i64, i32, i64,
                                        i32, i32, i32, ptr]
        lib.esr_scatter_add.restype = ctypes.c_int
        lib.esr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.esr_cuda_error_string.restype = ctypes.c_char_p
        lib._esr_typed = True
    return lib


def scatter_add_cuda(table: torch.Tensor, ids: torch.Tensor,
                     updates: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream, in place on
    ``table``; no synchronisation."""
    _check(table, ids, updates)
    dev = table.device
    if not table.is_cuda:
        raise ValueError("scatter_add_cuda needs CUDA tensors")
    if not (table.is_contiguous() and ids.is_contiguous()
            and updates.is_contiguous()):
        raise ValueError("scatter_add_cuda needs contiguous tensors")
    R, D = table.shape
    n = ids.shape[0]
    if n == 0 or D == 0 or R == 0:
        return table
    width, blocks = launch_plan(n, D, table.data_ptr(), updates.data_ptr(),
                                table.dtype)
    lib = typed_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.esr_scatter_add(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        table.data_ptr(), ids.data_ptr(), updates.data_ptr(), n, D, R,
        width, blocks, int(table.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"scatter_add launch failed: CUDA error {rc} "
                           f"({lib.esr_cuda_error_string(rc).decode()})")
    LAUNCHES.add(instantiation_name(width, table.dtype))
    return table


def scatter_add(table: torch.Tensor, ids: torch.Tensor,
                updates: torch.Tensor) -> torch.Tensor:
    """In-place row scatter-add: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (raising when it cannot launch)."""
    if table.device.type == "cpu":
        return scatter_add_plain(table, ids, updates)
    return scatter_add_cuda(table, ids, updates)
