"""Row gather and pooled lookup: the CUDA kernel's wrapper and its plain
PyTorch version.

``gather_pool`` replaces the TPU kernel ``_pool_kernel`` of
``esrecsys_tpu/ops/lookup.py``. For each row b of ``ids`` (B, K) it sums
``table[clamp(ids[b, k], 0, R-1)]`` over the K slots whose id is not
``mask_id``, in float32; ``mean`` divides by ``max(count, 1)``. K=1 with
``mask_id=-1`` is the plain row gather of the train step. The table is
float32 or bf16; bf16 rows are widened exactly to float32 before the sum,
as the reference's callers widen ``take`` of bf16 rows.

The kernel (``csrc/gather_pool.cu``) has three instantiations, which
:func:`launch_plan` picks: float32 rows read as 16-byte pieces (D a
multiple of 4, table 16-byte aligned), bf16 rows read as 16-byte pieces of
8 (D a multiple of 8, table 16-byte aligned), and narrow rows (any D, any
alignment, either dtype) read one element a thread.

A CPU tensor takes :func:`gather_pool_plain`; a CUDA tensor launches the
kernel in ``csrc/gather_pool.cu`` or raises. ``LAUNCHES.count`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from esrecsys_tpu_torch.kernels.build import LaunchCounter, load_library

LAUNCHES = LaunchCounter()

# the instantiations, as csrc/gather_pool.cu numbers them
F32X4, BF16X8, NARROW_F32, NARROW_BF16 = 0, 1, 2, 3
INSTANTIATIONS = {F32X4: "f32x4", BF16X8: "bf16x8", NARROW_F32: "narrow_f32",
                  NARROW_BF16: "narrow_bf16"}
DTYPES = (torch.float32, torch.bfloat16)


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


def launch_plan(dim: int, dtype: torch.dtype, table_ptr: int) -> int:
    """The instantiation of one launch over rows of ``dim`` elements of
    ``dtype``: a 16-byte piece a thread where the rows cut into whole
    pieces and the table is 16-byte aligned, one element a thread
    otherwise."""
    aligned = table_ptr % 16 == 0
    if dtype == torch.bfloat16:
        return BF16X8 if dim % 8 == 0 and aligned else NARROW_BF16
    return F32X4 if dim % 4 == 0 and aligned else NARROW_F32


def typed_library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("gather_pool")
    if not getattr(lib, "_esr_typed", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.esr_gather_pool.argtypes = [i32, ptr, ptr, ptr, i64, i32, i32,
                                        i64, i32, i32, i32, ptr]
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
    kind = launch_plan(D, table.dtype, table.data_ptr())
    lib = typed_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.esr_gather_pool(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), B, K, D, R,
        mask_id, int(mean), kind, stream)
    if rc != 0:
        raise RuntimeError(f"gather_pool launch failed: CUDA error {rc} "
                           f"({lib.esr_cuda_error_string(rc).decode()})")
    LAUNCHES.add(INSTANTIATIONS[kind])
    return out


def gather_pool(table: torch.Tensor, ids: torch.Tensor, mean: bool = False,
                mask_id: int = -1) -> torch.Tensor:
    """Pooled row lookup: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (raising when it cannot launch)."""
    if table.device.type == "cpu":
        return gather_pool_plain(table, ids, mean, mask_id)
    return gather_pool_cuda(table, ids, mean, mask_id)
