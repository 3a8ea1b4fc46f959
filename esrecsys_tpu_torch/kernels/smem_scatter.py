"""Shared-memory row scatter-add: the CUDA kernel's wrapper and its plain
PyTorch version.

``smem_scatter`` replaces the TPU kernel ``_vmem_scatter_kernel`` of
``esrecsys_tpu/ops/scatter.py:240`` (launched by ``vmem_scatter_add_phys``):
``table.at[ids].add(updates)`` in float32, IN PLACE. The table is the
logical (R, D) float32 array; the reference's 128-lane packed layout is TPU
layout and has no counterpart here. Ids outside ``[0, R)`` are dropped (the
TPU kernel does not guard them).

The kernel (``csrc/smem_scatter.cu``) cuts the table by row range over one
wave of CTAs, one per SM, each range's sums held in shared memory. Two
launches: the first bins the ids by owning CTA (every id read once, not by
every CTA) into int32 scratch the wrapper allocates (:func:`scratch_size`:
``n`` pairs and a ``2 x ctas x ctas`` table of counts and offsets); the
second sums each owner's update rows into its slice, which starts at -0.0,
and adds the slice into the touched table elements only: no untouched row
is read or written. What bounds it is bytes: the touched rows read and
written, the update rows and ids read once.

The range of one CTA must fit one block's opt-in shared memory, read from
``torch.cuda.get_device_properties`` on the card. The plain version on the
CPU applies an H100 SXM's figures, so a table the card refuses is refused
there too. The flagship album table (100,096 x 32 float32, 12.8 MB) fits;
the artist table (295,936 x 32, 37.9 MB) does not.

Tolerance: an element with one update comes out bit-equal to the plain
version (``table + u``). An element with duplicates comes out as ``table +
(sum of its updates)``, the sum taken in registers and by shared-memory
atomics in an order that changes from run to run, where the plain version
adds in PyTorch's order: the two agree to float32 rounding of each
duplicate sum.

A CPU tensor takes :func:`smem_scatter_plain`; a CUDA tensor launches the
kernel or raises. ``LAUNCHES.count`` counts calls that launch it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from esrecsys_tpu_torch.kernels.build import LaunchCounter, load_library
from esrecsys_tpu_torch.kernels.scatter_add import _check, scatter_add_plain

LAUNCHES = LaunchCounter()

# an H100 SXM: streaming multiprocessors, and the opt-in shared memory of
# one block in bytes (227 KB of the SM's 256 KB)
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232_448


def smem_budget(device: torch.device) -> Tuple[int, int]:
    """(SMs, opt-in shared-memory bytes per block) of ``device``'s card;
    an H100 SXM's for a device that is not a card."""
    if device.type != "cuda":
        return H100_SMS, H100_SMEM_PER_BLOCK
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def smem_plan(rows: int, dim: int, sms: int, smem_per_block: int
              ) -> Tuple[int, int]:
    """(CTAs, rows per CTA) that hold an (rows, dim) float32 table in one
    wave of CTAs, one per SM. Raises ValueError when the table does not
    fit the shared memory of ``sms`` blocks of ``smem_per_block`` bytes."""
    per_cta = max(1, -(-rows // sms))
    if per_cta * dim * 4 > smem_per_block:
        raise ValueError(
            f"table ({rows} x {dim} float32, {rows * dim * 4 / 2**20:.1f} "
            f"MiB) does not fit the card's shared memory ({sms} SMs x "
            f"{smem_per_block:,} B = {sms * smem_per_block / 2**20:.1f} "
            f"MiB); use scatter_add")
    return -(-rows // per_cta), per_cta


def scratch_size(n: int, ctas: int) -> int:
    """int32 elements of the kernel's scratch for ``n`` ids over ``ctas``
    owners: ``n`` (update index, row within the owner's range) pairs,
    sorted by owner within each of ``ctas`` chunks of ids, then the
    (2, ctas, ctas) counts and offsets of each owner's list in each chunk.
    The kernel writes all of it before it reads it."""
    return 2 * n + 2 * ctas * ctas


def smem_scatter_plain(table: torch.Tensor, ids: torch.Tensor,
                       updates: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in place on ``table``,
    refusing what the kernel refuses."""
    _check(table, ids, updates)
    smem_plan(table.shape[0], table.shape[1], *smem_budget(table.device))
    return scatter_add_plain(table, ids, updates)


def typed_library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("smem_scatter")
    if not getattr(lib, "_esr_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.esr_smem_scatter.argtypes = [i32, ptr, ptr, ptr, ptr, i32, i32,
                                         i32, i32, i32, ptr]
        lib.esr_smem_scatter.restype = ctypes.c_int
        lib.esr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.esr_cuda_error_string.restype = ctypes.c_char_p
        lib._esr_typed = True
    return lib


def smem_scatter_cuda(table: torch.Tensor, ids: torch.Tensor,
                      updates: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream, in place on
    ``table``; no synchronisation."""
    _check(table, ids, updates)
    dev = table.device
    if not table.is_cuda:
        raise ValueError("smem_scatter_cuda needs CUDA tensors")
    if not (table.is_contiguous() and ids.is_contiguous()
            and updates.is_contiguous()):
        raise ValueError("smem_scatter_cuda needs contiguous tensors")
    R, D = table.shape
    n = ids.shape[0]
    if D % 4 == 0 and (table.data_ptr() % 16 or updates.data_ptr() % 16):
        raise ValueError("smem_scatter_cuda reads rows of a width divisible "
                         "by 4 as float4: table and updates must be 16-byte "
                         "aligned")
    ctas, per_cta = smem_plan(R, D, *smem_budget(dev))
    if n == 0 or D == 0 or R == 0:
        return table
    if R * D >= 2**31 or n * D >= 2**31:
        raise ValueError("smem_scatter_cuda takes fewer than 2^31 elements")
    lib = typed_library()
    scratch = torch.empty(scratch_size(n, ctas), dtype=torch.int32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.esr_smem_scatter(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        table.data_ptr(), ids.data_ptr(), updates.data_ptr(),
        scratch.data_ptr(), n, D, R, per_cta, ctas, stream)
    if rc != 0:
        raise RuntimeError(f"smem_scatter launch failed: CUDA error {rc} "
                           f"({lib.esr_cuda_error_string(rc).decode()})")
    LAUNCHES.count += 1
    return table


def smem_scatter(table: torch.Tensor, ids: torch.Tensor,
                 updates: torch.Tensor) -> torch.Tensor:
    """In-place row scatter-add through per-CTA shared-memory sums: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors
    (raising when it cannot launch)."""
    if table.device.type == "cpu":
        return smem_scatter_plain(table, ids, updates)
    return smem_scatter_cuda(table, ids, updates)
