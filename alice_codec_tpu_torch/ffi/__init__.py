"""C ABI shim build + loader (the reference's 20-function FFI surface; the
port of the JAX package's ``ffi/``).

Builds ``build/libalice_codec.<SOABI>.so`` of this package from
``alice_codec_ffi.cpp`` at first use (g++ against the running CPython),
for the Unity/UE5 wrappers in ``bindings/``: the file name is the JAX
package's, so either package's library loads there unchanged.  The shim's
encode and decode call :mod:`.helpers` of this package, on the CUDA card
unless a Python host asks for another device.

``get_ffi_lib()`` returns a ctypes handle for in-process use.  It loads
the library ``RTLD_LOCAL``, so its 20 symbols stay its own when the JAX
package's shim (loaded ``RTLD_GLOBAL``) is in the same process.  A failed
build raises with the compiler's output.

Where CPython was built without a shared libpython, the shim is linked
without it and takes the interpreter's symbols from the process that
loads it: such a build serves Python hosts only.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

from . import helpers

__all__ = ["get_ffi_lib", "libpython_flags"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "alice_codec_ffi.cpp"
# Per-interpreter artifact under a gitignored build dir: the shim links
# against the running CPython, so one .so per ABI tag.
_SO = (_HERE / "build"
       / f"libalice_codec.{sysconfig.get_config_var('SOABI') or 'py'}.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def libpython_flags() -> list[str]:
    """The link flags for the running CPython's shared libpython, or none
    where it has no shared library (the symbols then come from the
    interpreter that loads the shim)."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlibrary = sysconfig.get_config_var("LDLIBRARY") or ""
    if not (sysconfig.get_config_var("Py_ENABLE_SHARED")
            and (Path(libdir) / ldlibrary).exists()):
        return []
    version = (sysconfig.get_config_var("LDVERSION")
               or sysconfig.get_config_var("VERSION"))
    return [f"-L{libdir}", f"-lpython{version}"]


def _build_command(out: Path) -> list[str]:
    return [os.environ.get("CXX", "g++"), "-O2", "-std=c++17", "-shared", "-fPIC",
            f"-I{sysconfig.get_path('include')}", str(_SRC), "-o", str(out),
            *libpython_flags()]


def _build() -> None:
    """Build the shim unless the library there is newer than the source and
    was built by the same command (the stamp beside it: a library built
    for another interpreter is rebuilt)."""
    stamp = _SO.with_suffix(".cmd")
    want = " ".join(_build_command(_SO))
    if (_SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime
            and stamp.exists() and stamp.read_text() == want):
        return
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    cmd = _build_command(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the C ABI shim failed ({' '.join(cmd)}, "
                           f"exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, _SO)  # never load a half-written file
    stamp.write_text(want)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    vp = ctypes.c_void_p

    for name in ("alice_codec_wavelet1d_haar", "alice_codec_wavelet1d_cdf53",
                 "alice_codec_wavelet1d_cdf97"):
        getattr(lib, name).restype = vp
        getattr(lib, name).argtypes = []
    lib.alice_codec_wavelet1d_destroy.argtypes = [vp]
    lib.alice_codec_wavelet1d_forward.argtypes = [vp, i32p, ctypes.c_uint32]
    lib.alice_codec_wavelet1d_inverse.argtypes = [vp, i32p, ctypes.c_uint32]

    lib.alice_codec_encoder_create.restype = vp
    lib.alice_codec_encoder_create.argtypes = [ctypes.c_uint8]
    lib.alice_codec_encoder_destroy.argtypes = [vp]
    lib.alice_codec_encode.restype = vp
    lib.alice_codec_encode.argtypes = [vp, u8p, ctypes.c_uint32,
                                       ctypes.c_uint32, ctypes.c_uint32,
                                       ctypes.c_uint32]
    lib.alice_codec_decode.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.alice_codec_decode.argtypes = [vp, u32p]

    lib.alice_codec_chunk_destroy.argtypes = [vp]
    lib.alice_codec_chunk_to_bytes.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.alice_codec_chunk_to_bytes.argtypes = [vp, u32p]
    lib.alice_codec_chunk_from_bytes.restype = vp
    lib.alice_codec_chunk_from_bytes.argtypes = [u8p, ctypes.c_uint32]
    for name in ("alice_codec_chunk_width", "alice_codec_chunk_height",
                 "alice_codec_chunk_frames"):
        getattr(lib, name).restype = ctypes.c_uint32
        getattr(lib, name).argtypes = [vp]

    lib.alice_codec_psnr.restype = ctypes.c_double
    lib.alice_codec_psnr.argtypes = [u8p, u8p, ctypes.c_uint32]
    lib.alice_codec_data_free.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                          ctypes.c_uint32]
    lib.alice_codec_string_free.argtypes = [ctypes.c_char_p]
    lib.alice_codec_version.restype = ctypes.c_void_p
    lib.alice_codec_version.argtypes = []
    return lib


def get_ffi_lib(device=None) -> ctypes.CDLL:
    """Load (building if needed) the C ABI library, and set the device its
    encode / decode run on: the CUDA card (``None``), or the one named
    (``"cpu"`` runs the kernels' plain versions).  Raises
    ``RuntimeError`` when the shim cannot be built."""
    global _lib
    helpers.set_device(device)
    with _lock:
        if _lib is None:
            _build()
            _lib = _bind(ctypes.CDLL(str(_SO)))
    return _lib
