"""Cross-process device admission control for concurrent streams.

A copy of the JAX package's ``ndstpu/harness/admission.py``.

The reference bounds intra-device concurrency with
``spark.rapids.sql.concurrentGpuTasks`` (power_run_gpu.template:21) while
`nds-throughput` fans out N concurrent driver processes.  Here N
concurrent power-run processes share one card, so an unbounded fan-out
just queues work behind each other and inflates every stream's tail
latency: a file-lock semaphore in a shared directory grants at most
``slots`` streams device access at a time, acquired around each query.
The in-process throughput scheduler's stream threads take the same
``slots`` through :class:`InprocAdmission`, a plain semaphore.

Locks are ``flock``-based so a crashed stream releases its slot when the
OS closes its file descriptors — no stale-lock cleanup needed.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


class DeviceAdmission:
    """A ``slots``-wide semaphore over lock files in ``lock_dir``."""

    def __init__(self, slots: int, lock_dir: str):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.slots = slots
        self.lock_dir = lock_dir
        os.makedirs(lock_dir, exist_ok=True)
        self._held: Optional[int] = None
        self._fds = {}

    def _fd(self, i: int) -> int:
        fd = self._fds.get(i)
        if fd is None:
            fd = os.open(os.path.join(self.lock_dir, f"slot{i}.lock"),
                         os.O_CREAT | os.O_RDWR, 0o644)
            self._fds[i] = fd
        return fd

    def acquire(self, poll_s: float = 0.02) -> int:
        """Block until one of the slots is free; returns the slot id."""
        import fcntl
        assert self._held is None, "admission slot already held"
        while True:
            for i in range(self.slots):
                try:
                    fcntl.flock(self._fd(i),
                                fcntl.LOCK_EX | fcntl.LOCK_NB)
                    self._held = i
                    return i
                except OSError:
                    continue
            time.sleep(poll_s)

    def release(self) -> None:
        import fcntl
        if self._held is None:
            return
        fcntl.flock(self._fd(self._held), fcntl.LOCK_UN)
        self._held = None

    @contextlib.contextmanager
    def slot(self):
        self.acquire()
        try:
            yield
        finally:
            self.release()

    def close(self) -> None:
        self.release()
        for fd in self._fds.values():
            os.close(fd)
        self._fds = {}


class InprocAdmission:
    """In-process ``slots`` semantics of :class:`DeviceAdmission` for
    the inproc throughput scheduler (ndstpu_torch/harness/scheduler.py): the
    stream workers are threads in ONE process, so a plain semaphore
    replaces the lock files.  Tracks the observed concurrency peak and
    per-acquisition device intervals — the committed evidence that at
    most ``slots`` queries held the device at once."""

    def __init__(self, slots: int):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        import threading
        self.slots = slots
        self._sem = threading.Semaphore(slots)
        self._mu = threading.Lock()
        self._tl = threading.local()
        self._active = 0
        self.max_active = 0
        self.wait_s_total = 0.0
        self.intervals = []  # (t_acquired, t_released) epoch pairs

    def acquire(self) -> int:
        t0 = time.time()
        self._sem.acquire()
        now = time.time()
        with self._mu:
            self._active += 1
            self.max_active = max(self.max_active, self._active)
            self.wait_s_total += now - t0
        self._tl.t0 = now
        return 0

    def release(self) -> None:
        t0 = getattr(self._tl, "t0", None)
        self._tl.t0 = None
        with self._mu:
            self._active -= 1
            if t0 is not None:
                self.intervals.append((t0, time.time()))
        self._sem.release()

    @contextlib.contextmanager
    def slot(self):
        self.acquire()
        try:
            yield
        finally:
            self.release()

    def device_timeline(self) -> dict:
        """Admission-level overlap evidence for the overlap report."""
        with self._mu:
            ivs = list(self.intervals)
        return {
            "slots": self.slots,
            "max_concurrent": self.max_active,
            "gated_queries": len(ivs),
            "busy_s_total": round(sum(b - a for a, b in ivs), 3),
            "wait_s_total": round(self.wait_s_total, 3),
        }


def from_env() -> Optional[DeviceAdmission]:
    """Admission configured by the throughput runner via env vars
    (NDSTPU_ADMISSION_SLOTS / NDSTPU_ADMISSION_DIR), or None."""
    slots = os.environ.get("NDSTPU_ADMISSION_SLOTS")
    if not slots:
        return None
    lock_dir = os.environ.get("NDSTPU_ADMISSION_DIR")
    if not lock_dir:
        return None
    return DeviceAdmission(int(slots), lock_dir)
