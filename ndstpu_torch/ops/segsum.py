"""Exact grouped decimal sums: the port of ``ndstpu.ops.segsum``.

:func:`segment_sum_decimal` returns exact per-segment int64 sums and row
counts of masked scaled-decimal values.  On a CUDA tensor it launches the
hand-written kernel ``csrc/segsum_decimal.cu`` (which replaces the TPU's
one-hot limb kernel ``ndstpu/ops/segsum.py::_limb_kernel``); on a CPU
tensor it runs :func:`segment_sum_decimal_plain`, the same function in
plain PyTorch.  There is no fallback from one to the other.

Contract (bit-exact with the TPU function):

* masked-out rows and rows whose gid is outside ``[0, num_segments)`` add
  nothing;
* a row counts when ``v + 2^41 != 0`` (the TPU count plane);
* if any masked-in ``|v| >= 2^41``, every sum is ``-2^62``.

The TPU function refuses more than ``(2^31 - 1) // 255`` rows (its int32
limb accumulators); both versions here accumulate in int64 and take any
row count.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

_BIAS = 1 << 41
_POISON = -(1 << 62)

# launches of the CUDA kernel since the last reset (the CPU path never
# counts): a run shows through this that it went through the kernel
LAUNCHES = 0


def segment_sum_decimal_plain(vals: torch.Tensor, gid: torch.Tensor,
                              mask: torch.Tensor, num_segments: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (``index_add_`` on int64)."""
    dev = vals.device
    take = mask & (gid >= 0) & (gid < num_segments)
    g = gid[take].long()
    v = vals[take]
    sums = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    counts = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    sums.index_add_(0, g, v)
    counts.index_add_(0, g, (v != -_BIAS).long())
    oob = (mask & ((vals <= -_BIAS) | (vals >= _BIAS))).any()
    sums = torch.where(oob, torch.full_like(sums, _POISON), sums)
    return sums, counts


def _check(vals, gid, mask, num_segments):
    if vals.dtype != torch.int64 or gid.dtype != torch.int32 or \
            mask.dtype != torch.bool:
        raise TypeError(
            f"segment_sum_decimal takes int64 vals, int32 gid and bool "
            f"mask, got {vals.dtype}, {gid.dtype}, {mask.dtype}")
    if vals.dim() != 1 or vals.shape != gid.shape or \
            vals.shape != mask.shape:
        raise ValueError(
            f"segment_sum_decimal takes three 1-D tensors of one length, "
            f"got {tuple(vals.shape)}, {tuple(gid.shape)}, "
            f"{tuple(mask.shape)}")
    if not (vals.device == gid.device == mask.device):
        raise ValueError("segment_sum_decimal: tensors on different devices")
    if not 0 < num_segments < 2 ** 31:
        raise ValueError(f"num_segments out of range: {num_segments}")


def segment_sum_decimal(vals: torch.Tensor, gid: torch.Tensor,
                        mask: torch.Tensor, num_segments: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-segment sums and counts: ``(sums int64[s], counts
    int64[s])``.  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    global LAUNCHES
    _check(vals, gid, mask, num_segments)
    if vals.device.type == "cpu":
        return segment_sum_decimal_plain(vals, gid, mask, num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_sum_decimal: no kernel for {vals.device}")
    if not (vals.is_contiguous() and gid.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("segment_sum_decimal: tensors must be contiguous")
    lib = _lib()
    dev = vals.device
    sums = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    counts = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segsum_decimal_launch(
            vals.data_ptr(), gid.data_ptr(), mask.data_ptr(),
            vals.shape[0], num_segments, sums.data_ptr(),
            counts.data_ptr(), flag.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segsum_decimal launch failed: CUDA error {err}")
    LAUNCHES += 1
    return sums, counts


def _lib():
    from ndstpu_torch.ops import build
    lib = build.load("segsum_decimal")
    fn = lib.segsum_decimal_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
