"""Grouped segment sums: the port of ``ndstpu.ops.segsum``.

Two wrappers, each over a hand-written CUDA kernel that replaces one of
the TPU's one-hot MXU kernels:

* :func:`segment_sum_decimal` returns exact per-segment int64 sums and row
  counts of masked scaled-decimal values (``csrc/segsum_decimal.cu``,
  replacing ``ndstpu/ops/segsum.py::_limb_kernel``);
* :func:`segment_sum_f32` returns masked per-segment float32 sums
  (``csrc/segsum_f32.cu``, replacing ``ndstpu/ops/segsum.py::_f32_kernel``).

On a CUDA tensor a wrapper launches its kernel; on a CPU tensor it runs
its ``*_plain`` version, the same function in plain PyTorch.  There is no
fallback from one to the other.

``segment_sum_decimal``'s contract (bit-exact with the TPU function):

* masked-out rows and rows whose gid is outside ``[0, num_segments)`` add
  nothing;
* a row counts when ``v + 2^41 != 0`` (the TPU count plane);
* if any masked-in ``|v| >= 2^41``, every sum is ``-2^62``.

The TPU function refuses more than ``(2^31 - 1) // 255`` rows (its int32
limb accumulators); both versions here accumulate in int64 and take any
row count.

``segment_sum_f32``'s contract: masked-out rows and rows whose gid is
outside ``[0, num_segments)`` add nothing; the result is float32
``[num_segments]``.  The kernel's float atomics add in no fixed order, so
it agrees with the plain version within a tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

_BIAS = 1 << 41
_POISON = -(1 << 62)

# launches of each CUDA kernel since the last reset (the CPU path never
# counts): a run shows through these that it went through the kernel
LAUNCHES = 0            # segsum_decimal
LAUNCHES_F32 = 0        # segsum_f32


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


def _to_kernel(name: str, vals, gid, mask, num_segments: int,
               vals_dtype: torch.dtype) -> bool:
    """Check a wrapper's inputs: True when they go to the CUDA kernel,
    False when they lie on the CPU (the plain version)."""
    if vals.dtype != vals_dtype or gid.dtype != torch.int32 or \
            mask.dtype != torch.bool:
        raise TypeError(
            f"{name} takes {vals_dtype} vals, int32 gid and bool mask, got "
            f"{vals.dtype}, {gid.dtype}, {mask.dtype}")
    if vals.dim() != 1 or vals.shape != gid.shape or \
            vals.shape != mask.shape:
        raise ValueError(
            f"{name} takes three 1-D tensors of one length, got "
            f"{tuple(vals.shape)}, {tuple(gid.shape)}, {tuple(mask.shape)}")
    if not (vals.device == gid.device == mask.device):
        raise ValueError(f"{name}: tensors on different devices")
    if not 0 < num_segments < 2 ** 31:
        raise ValueError(f"num_segments out of range: {num_segments}")
    if vals.device.type == "cpu":
        return False
    if vals.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {vals.device}")
    if not (vals.is_contiguous() and gid.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    return True


def _launch(kernel: str, inputs, num_segments: int, outputs) -> None:
    """Call ``csrc/<kernel>.cu``'s ``<kernel>_launch(inputs..., n,
    num_segments, outputs..., stream)`` on the inputs' current stream;
    raises on a CUDA error."""
    from ndstpu_torch.ops import build
    fn = getattr(build.load(kernel), f"{kernel}_launch")
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * len(inputs) + [ctypes.c_longlong, ctypes.c_int] + \
        [ptr] * (len(outputs) + 1)
    fn.restype = ctypes.c_int
    dev = inputs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in inputs), inputs[0].shape[0],
                 num_segments, *(t.data_ptr() for t in outputs), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def segment_sum_decimal(vals: torch.Tensor, gid: torch.Tensor,
                        mask: torch.Tensor, num_segments: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-segment sums and counts: ``(sums int64[s], counts
    int64[s])``.  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    global LAUNCHES
    if not _to_kernel("segment_sum_decimal", vals, gid, mask, num_segments,
                      torch.int64):
        return segment_sum_decimal_plain(vals, gid, mask, num_segments)
    dev = vals.device
    sums = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    counts = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch("segsum_decimal", (vals, gid, mask), num_segments,
            (sums, counts, flag))
    LAUNCHES += 1
    return sums, counts


def segment_sum_f32_plain(vals: torch.Tensor, gid: torch.Tensor,
                          mask: torch.Tensor, num_segments: int
                          ) -> torch.Tensor:
    """The f32 kernel's function in plain PyTorch: a float32 ``where``,
    then ``index_add_``."""
    take = mask & (gid >= 0) & (gid < num_segments)
    v = torch.where(take, vals.to(torch.float32), 0.0)
    g = torch.where(take, gid, 0).long()
    out = torch.zeros(num_segments, dtype=torch.float32, device=vals.device)
    return out.index_add_(0, g, v)


def segment_sum_f32(vals: torch.Tensor, gid: torch.Tensor,
                    mask: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Masked per-segment float32 sums: ``float32[num_segments]``.  CUDA
    tensors go to the kernel, CPU tensors to the plain version.  (The TPU
    function's ``block_rows``, ``block_segs`` and ``interpret`` are tiling
    knobs of its one-hot matmul and have no counterpart here.)"""
    global LAUNCHES_F32
    if not _to_kernel("segment_sum_f32", vals, gid, mask, num_segments,
                      torch.float32):
        return segment_sum_f32_plain(vals, gid, mask, num_segments)
    out = torch.zeros(num_segments, dtype=torch.float32, device=vals.device)
    _launch("segsum_f32", (vals, gid, mask), num_segments, (out,))
    LAUNCHES_F32 += 1
    return out
