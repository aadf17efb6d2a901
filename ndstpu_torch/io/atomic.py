"""Atomic artifact writes: temp file + fsync + ``os.replace``.

A copy of the JAX package's ``ndstpu/io/atomic.py``, its imports changed.

Every JSON/CSV artifact the harness publishes (sidecars, overlap
reports, time logs, summaries, reports, RUN_STATE journal snapshots)
goes through this module so a ``kill -9`` mid-write can never leave a
truncated or half-serialized file behind: readers either see the old
complete artifact or the new complete artifact, never a torn one.

The mechanism is the standard POSIX dance — write to a uniquely-named
temp file *in the same directory* (``os.replace`` is only atomic within
a filesystem), flush + fsync the data, then ``os.replace`` onto the
final name.  ``append_jsonl`` is the complement for append-only
journals (ledger, RUN_STATE): one line per record, flushed and fsynced
per call, so a crash can at worst lose the final in-flight line —
readers skip a torn trailing line, they never misparse earlier ones.

All writers carry the ``io.write`` fault-injection probe
(docs/ROBUSTNESS.md), so chaos runs exercise the failure-mid-write
path the atomicity guarantee exists for.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Iterator, Optional

from ndstpu_torch import faults


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync so the rename itself is durable."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_writer(path: str, mode: str = "w",
                  encoding: Optional[str] = None,
                  newline: Optional[str] = None) -> Iterator:
    """Context manager yielding a file handle for a temp file that is
    atomically renamed onto ``path`` on clean exit (and unlinked on
    error)."""
    if "a" in mode:
        raise ValueError("atomic_writer cannot append; use append_jsonl")
    faults.check("io.write", key=path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    if encoding is None and "b" not in mode:
        encoding = "utf-8"
    fd, tmp = tempfile.mkstemp(
        prefix=f".{os.path.basename(path)}.", suffix=".tmp", dir=d)
    try:
        kw = {} if "b" in mode else {"encoding": encoding,
                                     "newline": newline}
        with os.fdopen(fd, mode, **kw) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_write_text(path: str, text: str) -> None:
    with atomic_writer(path, "w") as f:
        f.write(text)


def atomic_write_bytes(path: str, data: bytes) -> None:
    with atomic_writer(path, "wb") as f:
        f.write(data)


def atomic_write_json(path: str, obj, *, indent: Optional[int] = 2,
                      default=str) -> None:
    with atomic_writer(path, "w") as f:
        json.dump(obj, f, indent=indent, default=default)
        f.write("\n")


def append_jsonl(path: str, record: dict, *, default=str) -> None:
    """Durably append one JSON record to an append-only journal."""
    faults.check("io.write", key=path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    line = json.dumps(record, default=default)
    if "\n" in line:
        raise ValueError("journal record serialized to multiple lines")
    with open(path, "a", encoding="utf-8") as f:
        f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())


def read_jsonl(path: str) -> list:
    """Read a journal, tolerating a torn trailing line (crash mid-
    append) — any other malformed line raises, since append_jsonl
    fsyncs per record."""
    records = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.readlines()
    except FileNotFoundError:
        return records
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            if i == len(lines) - 1:
                break  # torn final line from a crash mid-append
            raise
    return records
