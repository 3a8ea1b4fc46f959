"""Row scatter-add: the CUDA kernel's wrapper and its plain PyTorch version.

``scatter_add`` replaces the TPU kernel ``_kernel`` of
``esrecsys_tpu/ops/scatter.py``: ``table.at[ids].add(updates)`` with
unsorted ids and duplicates summed, in float32. Both versions update
``table`` IN PLACE and return it (the train step adds into its tables and
momentum buffers, so no second table-sized buffer is made). Ids outside
``[0, R)`` are dropped.

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

Duplicates are summed in an order that changes from run to run; the plain
version sums them in PyTorch's order. The two agree to float32 rounding of
each duplicate sum.

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


def launch_plan(n: int, dim: int, table_ptr: int,
                updates_ptr: int) -> Tuple[int, int]:
    """(instantiation, CTAs) of one launch over ``n`` rows of ``dim``
    floats: the instantiation is ``dim`` for a vector one (``dim`` in
    :data:`VECTOR_WIDTHS`, both pointers 16-byte aligned), else 0 for the
    generic one; the CTAs give each warp one pass over its rows."""
    if dim in VECTOR_WIDTHS and table_ptr % 16 == 0 and updates_ptr % 16 == 0:
        rows_per_cta = THREADS // 32 * (32 // (dim // 4)) * PER_LANE
        return dim, -(-n // rows_per_cta)
    return 0, -(-(n * dim) // (THREADS * PER_LANE))


def _check(table: torch.Tensor, ids: torch.Tensor,
           updates: torch.Tensor) -> None:
    if table.dim() != 2 or ids.dim() != 1 or updates.dim() != 2:
        raise ValueError(f"table {tuple(table.shape)} must be 2-D, ids "
                         f"{tuple(ids.shape)} 1-D, updates "
                         f"{tuple(updates.shape)} 2-D")
    if table.dtype != torch.float32 or updates.dtype != torch.float32:
        raise TypeError(f"table ({table.dtype}) and updates "
                        f"({updates.dtype}) must be float32")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if updates.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(f"updates {tuple(updates.shape)} must be "
                         f"({ids.shape[0]}, {table.shape[1]})")
    if not table.device == ids.device == updates.device:
        raise ValueError("table, ids and updates must share a device")


def scatter_add_plain(table: torch.Tensor, ids: torch.Tensor,
                      updates: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in place on ``table``."""
    _check(table, ids, updates)
    keep = (ids >= 0) & (ids < table.shape[0])
    idx = ids.long()
    if not bool(keep.all()):
        idx, updates = idx[keep], updates[keep]
    return table.index_put_((idx,), updates, accumulate=True)


def typed_library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("scatter_add")
    if not getattr(lib, "_esr_typed", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.esr_scatter_add.argtypes = [i32, ptr, ptr, ptr, i64, i32, i64,
                                        i32, i32, ptr]
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
    width, blocks = launch_plan(n, D, table.data_ptr(), updates.data_ptr())
    lib = typed_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.esr_scatter_add(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        table.data_ptr(), ids.data_ptr(), updates.data_ptr(), n, D, R,
        width, blocks, stream)
    if rc != 0:
        raise RuntimeError(f"scatter_add launch failed: CUDA error {rc} "
                           f"({lib.esr_cuda_error_string(rc).decode()})")
    LAUNCHES.count += 1
    return table


def scatter_add(table: torch.Tensor, ids: torch.Tensor,
                updates: torch.Tensor) -> torch.Tensor:
    """In-place row scatter-add: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (raising when it cannot launch)."""
    if table.device.type == "cpu":
        return scatter_add_plain(table, ids, updates)
    return scatter_add_cuda(table, ids, updates)
