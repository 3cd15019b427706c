"""The host-serial rANS coder in C++ (a verbatim copy of the JAX
package's ``native/alice_rans.cpp``), built at first use and bound with
ctypes.

The source is compiled with ``g++ -O3 -fopenmp`` (without OpenMP where
the compiler has no OpenMP runtime) into ``_build/alice_rans-<digest>.so``
of this package; the digest covers the source and the flags, and the
library is written under a per-process name and renamed into place, so
test workers that build at once never load a half-written file.  Nothing
is built at import time.

There is no fallback to Python: a failed build raises with the
compiler's output.  The pure-Python loops of :mod:`~..ops.rans` are the executable
spec and run only when a caller asks for them (``native=False``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["get_lib"]

_SRC = Path(__file__).resolve().parent / "alice_rans.cpp"
_OUT = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fno-exceptions")
_ABI_VERSION = 2

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _compile() -> Path:
    cxx = os.environ.get("CXX", "g++")
    src = _SRC.read_bytes()
    errors = []
    # OpenMP runs the N-way coder's lanes on all cores; where the compiler
    # has no OpenMP runtime the serial build writes the same bytes
    for flags in (("-fopenmp", *_FLAGS), _FLAGS):
        digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
        target = _OUT / f"alice_rans-{digest[:16]}.so"
        if target.exists():
            return target
        _OUT.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *flags, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode == 0:
            os.replace(tmp, target)
            return target
        errors.append(f"{cxx} {' '.join(flags)} ({proc.returncode}):\n"
                      f"{proc.stdout}{proc.stderr}")
    raise RuntimeError("building the native rANS coder failed:\n"
                       + "\n".join(errors))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32

    lib.alc_freq_table.argtypes = [u32p, i32, u16p, u16p, u8p, i32]
    lib.alc_freq_table.restype = None
    lib.alc_rans_encode_put.argtypes = [u32p, u8p, i64, u16p, u16p, u8p,
                                        ctypes.POINTER(i32)]
    lib.alc_rans_encode_put.restype = i64
    lib.alc_rans_finish.argtypes = [ctypes.c_uint32, u8p, i64]
    lib.alc_rans_finish.restype = i64
    lib.alc_rans_encode.argtypes = [u8p, i64, u16p, u16p, u8p,
                                    ctypes.POINTER(i32)]
    lib.alc_rans_encode.restype = i64
    lib.alc_rans_decode_n.argtypes = [u8p, i64, i64, u16p, u16p, u8p, u8p,
                                      u32p, ctypes.POINTER(i64)]
    lib.alc_rans_decode_n.restype = None
    lib.alc_rans_encode4.argtypes = [u8p, i64, u16p, u16p, u8p]
    lib.alc_rans_encode4.restype = i64
    lib.alc_rans_decode4.argtypes = [u8p, i64, i64, u16p, u16p, u8p, u8p]
    lib.alc_rans_decode4.restype = None
    lib.alc_rans_encode_nway.argtypes = [u8p, i64, i32, u16p, u16p, u8p, u32p]
    lib.alc_rans_encode_nway.restype = i64
    lib.alc_rans_decode_nway.argtypes = [u8p, i64, i32, u32p, u16p, u16p,
                                         u8p, u8p]
    lib.alc_rans_decode_nway.restype = None
    lib.alc_native_abi_version.argtypes = []
    lib.alc_native_abi_version.restype = i32
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built at first use.  Raises
    ``RuntimeError`` (with the compiler's output) when it cannot be
    built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = _bind(ctypes.CDLL(str(_compile())))
            if lib.alc_native_abi_version() != _ABI_VERSION:
                raise RuntimeError("native rANS coder: unexpected ABI version")
            _lib = lib
    return _lib
