"""Build the port's CUDA kernels from the sources in ``ops/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface, loaded through ``ctypes``.  The library lands in
``build/ndstpu_torch/`` at the root of the checkout, named by a hash of
its source and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  Nothing here runs at import: the first call that
needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ndstpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source (default: every ``csrc/*.cu``) that is
    not built yet, one ``nvcc`` each, all started together.  Returns each
    compiler's output (the ``-Xptxas -v`` register and shared-memory
    report); raises with that output when one fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``csrc/<name>.cu``, built on
    first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build_all([name])
            lib = _LOADED[name] = ctypes.CDLL(str(_target(name)))
        return lib
