"""Row gather and pooled lookup: the CUDA kernel's wrapper and its plain
PyTorch version.

``gather_pool`` replaces the TPU kernel ``_pool_kernel`` of
``esrecsys_tpu/ops/lookup.py``. For each row b of ``ids`` (B, K) it sums
``table[clamp(ids[b, k], 0, R-1)]`` over the K slots whose id is not
``mask_id``, in float32; ``mean`` divides by ``max(count, 1)``. K=1 with
``mask_id=-1`` is the plain row gather of the train step.

A CPU tensor takes :func:`gather_pool_plain`; a CUDA tensor launches the
kernel in ``csrc/gather_pool.cu`` or raises. ``LAUNCHES.count`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from esrecsys_tpu_torch.kernels.build import LaunchCounter, load_library

LAUNCHES = LaunchCounter()


def _check(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table {tuple(table.shape)} and ids "
                         f"{tuple(ids.shape)} must be 2-D")
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table.dtype}")
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
    rows = table[ids.clamp(0, table.shape[0] - 1).long()]       # (B, K, D)
    acc = torch.where(valid[..., None], rows, 0.0).sum(1)
    if mean:
        acc = acc / valid.sum(1, keepdim=True).clamp(min=1).float()
    return acc


def typed_library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("gather_pool")
    if not getattr(lib, "_esr_typed", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.esr_gather_pool.argtypes = [i32, ptr, ptr, ptr, i64, i32, i32,
                                        i64, i32, i32, ptr]
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
    if D % 4 or table.data_ptr() % 16:
        raise ValueError(f"the kernel reads 16-byte row pieces: D={D} must "
                         f"be a multiple of 4 and the table 16-byte aligned")
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if B == 0 or D == 0:
        return out
    lib = typed_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.esr_gather_pool(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), B, K, D, R,
        mask_id, int(mean), stream)
    if rc != 0:
        raise RuntimeError(f"gather_pool launch failed: CUDA error {rc} "
                           f"({lib.esr_cuda_error_string(rc).decode()})")
    LAUNCHES.count += 1
    return out


def gather_pool(table: torch.Tensor, ids: torch.Tensor, mean: bool = False,
                mask_id: int = -1) -> torch.Tensor:
    """Pooled row lookup: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (raising when it cannot launch)."""
    if table.device.type == "cpu":
        return gather_pool_plain(table, ids, mean, mask_id)
    return gather_pool_cuda(table, ids, mean, mask_id)
