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

A call on the card costs one output allocation, one zeroing and one
kernel launch through a ctypes binding made once; its launch comes from
:func:`_plan_decimal` or :func:`_plan_f32` (pure functions of the row
count, the segment count and the card's SMs), which the CPU tests check.

``segment_sum_decimal`` may be captured into a CUDA graph (the compiled
query replay, ``torchexec.CompilingExecutor``): the capture calls
:func:`prepare` first and runs under :func:`capturing`, whose aux words
are made outside the capture and must live as long as the graph; it
counts the calls the capture records.  A replay launches them with no
Python call, so :func:`counting_replays` counts them from the profiler's
device events by kernel name, into ``REPLAY_LAUNCHES``.

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

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple, Tuple

import torch

from ndstpu_torch import obs

_BIAS = 1 << 41
_POISON = -(1 << 62)

# launches of each CUDA kernel since the last reset (the CPU path never
# counts): a run shows through these that it went through the kernel.
# LAUNCHES counts the wrapper's own launches; REPLAY_LAUNCHES the
# launches of segsum_decimal that graph replays made inside
# counting_replays(), counted by the profiler (a capture launches nothing
# and counts in neither).  Each of the wrapper's own launches of
# segsum_decimal also adds to the obs counter
# kernel.segsum_decimal.launches, which a power run's metrics sidecar
# carries out of its process
LAUNCHES = 0            # segsum_decimal
REPLAY_LAUNCHES = 0     # segsum_decimal, by graph replays (profiled)
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
    if vals.dtype is not vals_dtype or gid.dtype is not torch.int32 or \
            mask.dtype is not torch.bool:
        raise TypeError(
            f"{name} takes {vals_dtype} vals, int32 gid and bool mask, got "
            f"{vals.dtype}, {gid.dtype}, {mask.dtype}")
    shape = vals.shape
    if len(shape) != 1 or gid.shape != shape or mask.shape != shape:
        raise ValueError(
            f"{name} takes three 1-D tensors of one length, got "
            f"{tuple(vals.shape)}, {tuple(gid.shape)}, {tuple(mask.shape)}")
    dev = vals.device
    if gid.device != dev or mask.device != dev:
        raise ValueError(f"{name}: tensors on different devices")
    if not 0 < num_segments < 2 ** 31:
        raise ValueError(f"num_segments out of range: {num_segments}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    if not (vals.is_contiguous() and gid.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    return True


class Plan(NamedTuple):
    """How one call runs: the kernel's ``regime``, the launch's ``grid``,
    ``block`` and ``cluster`` sizes and its dynamic shared-memory bytes
    (for the f32 kernel, ``smem // (4 * s)`` copies of its histogram).
    ``grid == 0`` launches nothing (no rows)."""
    regime: int
    grid: int
    block: int
    cluster: int
    smem: int


# regimes of csrc/segsum_decimal.cu
DEC_GLOBAL, DEC_SMEM, DEC_CLUSTER = 0, 1, 2
# regimes of csrc/segsum_f32.cu
F32_GLOBAL, F32_SMEM = 0, 1

SMEM_BLOCK = 232448               # shared memory a block can use on sm_90
SMEM_SM = 233472                  # shared memory of one SM (228 KB)
SMEM_DYN_MAX = SMEM_BLOCK - 1024  # what the kernels ask for, at most
# the kernels keep histograms in shared memory from this many rows a
# segment on, global atomics below: the crossover lies between 8 and 16
# for both, at 4,096 and 24,443 segments (chip_smoke.py's sweep, PERF.md)
DEC_SMEM_ROWS_PER_SEG = 16
F32_SMEM_ROWS_PER_SEG = 16
F32_CLUSTER = 2                   # CTAs that fold their histograms together

_NO_KERNEL = Plan(0, 0, 0, 1, 0)


@functools.lru_cache(maxsize=1024)
def _plan_decimal(n: int, s: int, sms: int) -> Plan:
    """The decimal kernel's launch for ``n`` rows over ``s`` segments on a
    card of ``sms`` SMs."""
    if n == 0:
        return _NO_KERNEL
    if n < DEC_SMEM_ROWS_PER_SEG * s or 12 * -(-s // 2) > SMEM_DYN_MAX:
        return _decimal_plan(DEC_GLOBAL, n, s, sms)
    if 12 * s <= SMEM_DYN_MAX:
        return _decimal_plan(DEC_SMEM, n, s, sms)
    return _decimal_plan(DEC_CLUSTER, n, s, sms)


def _decimal_plan(regime: int, n: int, s: int, sms: int) -> Plan:
    """The decimal kernel's launch in ``regime`` (``n > 0``): global
    atomics fill the card (8 blocks of 256 an SM), histograms take one
    block of 1024 an SM, or one CTA of a cluster of 2 each."""
    vecs = -(-n // 4)
    if regime == DEC_GLOBAL:
        return Plan(regime, min(-(-vecs // 256), sms * 8), 256, 1, 0)
    grid = min(sms, -(-vecs // 1024))
    if regime == DEC_SMEM:
        return Plan(regime, grid, 1024, 1, 12 * s)
    return Plan(regime, 2 * max(1, grid // 2), 1024, 2, 12 * -(-s // 2))


@functools.lru_cache(maxsize=1024)
def _plan_f32(n: int, s: int, sms: int) -> Plan:
    """The f32 kernel's launch for ``n`` rows over ``s`` segments on a card
    of ``sms`` SMs."""
    if n == 0:
        return _NO_KERNEL
    if n < F32_SMEM_ROWS_PER_SEG * s or 4 * s > SMEM_DYN_MAX:
        return _f32_plan(F32_GLOBAL, n, s, sms)
    return _f32_plan(F32_SMEM, n, s, sms)


def _f32_plan(regime: int, n: int, s: int, sms: int) -> Plan:
    """The f32 kernel's launch in ``regime`` (``n > 0``): global atomics
    fill the card (8 blocks of 256 an SM); histograms take blocks of 1024,
    two an SM where two fit, each with as many copies of its histogram as
    fit, up to one a warp, folded by clusters of up to ``F32_CLUSTER``."""
    vecs = -(-n // 4)
    if regime == F32_GLOBAL:
        return Plan(regime, min(-(-vecs // 256), sms * 8), 256, 1, 0)
    per_sm = 2 if 2 * (4 * s + 1024) <= SMEM_SM else 1
    copies = max(1, min(1024 // 32, (SMEM_SM // per_sm - 1024) // (4 * s),
                        SMEM_DYN_MAX // (4 * s)))
    grid = min(sms * per_sm, -(-vecs // 1024))
    cluster = min(F32_CLUSTER, 1 << (grid.bit_length() - 1))
    return Plan(regime, grid - grid % cluster, 1024, cluster, 4 * s * copies)


class _CPlan(ctypes.Structure):
    """:class:`Plan` as the C launchers take it."""
    _fields_ = [(f, ctypes.c_int) for f in Plan._fields]


_PTR = ctypes.c_void_p
_ARGTYPES = {
    # vals, gid, mask, n, s, out, aux, plan, stream
    "segsum_decimal": [_PTR] * 3 + [ctypes.c_longlong, ctypes.c_int] +
    [_PTR] * 4,
    # vals, gid, mask, n, s, out, plan, stream
    "segsum_f32": [_PTR] * 3 + [ctypes.c_longlong, ctypes.c_int] + [_PTR] * 3,
}
_FNS = {}       # (kernel, device index) -> its bound ctypes launcher
_SMS = {}       # device index -> SM count
# (device index, stream) -> int64 [2]: the decimal kernel's out-of-range
# flag and block tickets on that stream, zero between calls (the kernel's
# last block resets them)
_AUX = {}


@functools.lru_cache(maxsize=1024)
def _c_plan(plan: Plan) -> _CPlan:
    return _CPlan(*plan)


def _sms(dev: torch.device) -> int:
    sms = _SMS.get(dev.index)
    if sms is None:
        sms = _SMS[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def _launcher(kernel: str, device: int):
    """``csrc/<kernel>.cu``'s bound launcher on the current device, index
    ``device``: built, bound and prepared (its ``cudaFuncSetAttribute``
    calls) on first use there."""
    fn = _FNS.get((kernel, device))
    if fn is None:
        from ndstpu_torch.ops import build
        lib = build.load(kernel)
        prepare = getattr(lib, f"{kernel}_prepare")
        prepare.argtypes = []
        prepare.restype = ctypes.c_int
        err = prepare()
        if err != 0:
            raise RuntimeError(f"{kernel} prepare failed: CUDA error {err}")
        fn = getattr(lib, f"{kernel}_launch")
        fn.argtypes = _ARGTYPES[kernel]
        fn.restype = ctypes.c_int
        _FNS[kernel, device] = fn
    return fn


def prepare(device) -> None:
    """Build, bind and prepare ``segsum_decimal`` on ``device`` now, so
    that a capture makes no attribute call."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        _launcher("segsum_decimal", dev.index or 0)


class _Capture:
    """A capture in progress: the decimal kernel's aux words for its
    calls (int64 [2]: the calls of a graph run one after another on its
    stream, and each leaves them zero) and the calls it has recorded."""

    def __init__(self, device):
        self.aux = torch.zeros(2, dtype=torch.int64, device=device)
        self.n = 0


_CAPTURE = threading.local()


@contextlib.contextmanager
def capturing(device):
    """The extent of one graph capture on ``device``, entered before the
    capture begins: ``segment_sum_decimal`` calls inside it use the
    yielded object's ``aux`` and are counted on its ``n`` instead of in
    ``LAUNCHES``."""
    prev = getattr(_CAPTURE, "cap", None)
    cap = _CAPTURE.cap = _Capture(device)
    try:
        yield cap
    finally:
        _CAPTURE.cap = prev


@contextlib.contextmanager
def counting_replays(host: bool = False):
    """Count the ``segsum_decimal`` launches that graph replays make in
    the block: ``torch.profiler`` records the card's kernels (CUDA
    activity; with ``host`` the host's calls too), and the device events
    whose kernel name holds ``segsum_decimal``, less the wrapper's own
    launches in the block, are added to ``REPLAY_LAUNCHES``.  Yields a
    dict whose ``"launches"`` is that count, and ``"events"`` the
    profiler's events, once the block ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    global REPLAY_LAUNCHES
    out = {"launches": 0}
    before = LAUNCHES
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        yield out
        torch.cuda.synchronize()
    out["events"] = prof.events()
    seen = sum(1 for e in out["events"]
               if e.device_type == DeviceType.CUDA
               and "segsum_decimal" in e.name)
    out["launches"] = seen - (LAUNCHES - before)
    REPLAY_LAUNCHES += out["launches"]


def _call(kernel: str, device: int, stream: int, *args, plan: Plan
          ) -> None:
    """Call ``csrc/<kernel>.cu``'s ``<kernel>_launch(*args, plan, stream)``
    on the current device, index ``device``; raises on a CUDA error."""
    fn = _launcher(kernel, device)
    cplan = _c_plan(plan)
    err = fn(*args, ctypes.addressof(cplan), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def _decimal(vals, gid, mask, num_segments: int, plan: Plan
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of the decimal kernel with ``plan``; the sums and counts
    are the rows of one zeroed int64 buffer.  Inside a capture it takes
    the capture's aux words (allocating them there would put them in the
    graph's pool, cached past the graph's life)."""
    dev = vals.device
    if dev.index != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return _decimal(vals, gid, mask, num_segments, plan)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if torch.cuda.is_current_stream_capturing():
        cap = getattr(_CAPTURE, "cap", None)
        if cap is None:
            raise RuntimeError("segment_sum_decimal captured outside "
                               "segsum.capturing(): no aux words")
        aux = cap.aux
    else:
        aux = _AUX.get((dev.index, stream))
        if aux is None:
            aux = _AUX[dev.index, stream] = torch.zeros(
                2, dtype=torch.int64, device=dev)
    buf = torch.empty((2, num_segments), dtype=torch.int64, device=dev)
    _call("segsum_decimal", dev.index, stream, vals.data_ptr(), gid.data_ptr(),
          mask.data_ptr(), vals.shape[0], num_segments, buf.data_ptr(),
          aux.data_ptr(), plan=plan)
    return buf[0], buf[1]


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
    plan = _plan_decimal(vals.shape[0], num_segments, _sms(vals.device))
    out = _decimal(vals, gid, mask, num_segments, plan)
    if plan.grid:
        cap = getattr(_CAPTURE, "cap", None)
        if cap is not None and torch.cuda.is_current_stream_capturing():
            cap.n += 1
        else:
            LAUNCHES += 1
            obs.inc("kernel.segsum_decimal.launches")
    return out


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
    plan = _plan_f32(vals.shape[0], num_segments, _sms(vals.device))
    out = _f32(vals, gid, mask, num_segments, plan)
    if plan.grid:
        LAUNCHES_F32 += 1
    return out


def _f32(vals, gid, mask, num_segments: int, plan: Plan) -> torch.Tensor:
    """One call of the f32 kernel with ``plan``."""
    s = num_segments
    dev = vals.device
    if dev.index != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return _f32(vals, gid, mask, num_segments, plan)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    out = torch.empty(s, dtype=torch.float32, device=dev)
    _call("segsum_f32", dev.index, stream, vals.data_ptr(), gid.data_ptr(),
          mask.data_ptr(), vals.shape[0], s, out.data_ptr(), plan=plan)
    return out
