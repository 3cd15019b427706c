"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is a CUDA C++ source with a plain C interface.
At first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into
``_build/<name>-<digest>.so`` beside this file (the digest covers the
source and the flags, so an edited source never loads a stale library)
and loaded with ``ctypes``.  :func:`build` starts one ``nvcc`` per
source, all at once, and waits for them.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build", "check", "library"]

SOURCES = ("lift", "rans3", "sparse", "rans_nway", "hist")
_CSRC = Path(__file__).resolve().parent / "csrc"
_OUT = Path(__file__).resolve().parent / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _OUT / f"{name}-{digest}.so"


def build(names=SOURCES) -> list[Path]:
    """Compile every missing library of ``names`` in parallel; returns
    their paths.  Raises ``RuntimeError`` with nvcc's output on failure."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        nvcc = _nvcc()
        _OUT.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        errors = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[n])
        if errors:
            raise RuntimeError("\n".join(errors))
    return [targets[n] for n in names]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (path,) = build((name,))
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status:
        raise RuntimeError(f"{what}: CUDA error {status}")
