"""Plain-bytes helpers the C ABI shim calls via embedded CPython (the port
of the JAX package's ``ffi/helpers.py``).

Keeps the C++ side free of NumPy/torch marshalling: everything crossing
the boundary is bytes + ints.

The C ABI has no device argument, so the codec runs on the device set
here: the CUDA card unless a Python host asked for another through
:func:`set_device` (``ffi.get_ffi_lib(device="cpu")`` does).  With no
card and no such request, ``encode`` / ``decode`` raise and the shim
returns NULL: nothing is coded on the CPU unasked.

The JAX package runs its work on a one-thread pool, because XLA's CPU
client deadlocks on the thread state the shim's ``PyGILState_Ensure``
makes.  torch has no such hazard, so the work runs on the calling
thread, and the kernels' launch counts grow in this process.
"""

from __future__ import annotations

import numpy as np

from ..errors import CodecError
from ..pipeline import EncodedChunk, FrameDecoder, FrameEncoder

#: the device the shim's encode / decode run on (None: the CUDA card)
_device = None


def set_device(device=None) -> None:
    """Set the device of the shim's encode / decode (None: the CUDA card)."""
    global _device
    _device = device


def encode(quality: int, rgb: bytes, width: int, height: int, frames: int):
    """Returns an EncodedChunk object or None on codec error."""
    try:
        return FrameEncoder(quality=quality, device=_device).encode(
            np.frombuffer(rgb, np.uint8), width, height, frames
        )
    except CodecError:
        return None


def decode(chunk: EncodedChunk):
    """Returns RGB bytes or None on codec error."""
    try:
        return FrameDecoder(device=_device).decode(chunk).tobytes()
    except CodecError:
        return None


def chunk_to_bytes(chunk: EncodedChunk) -> bytes:
    return chunk.to_bytes()


def chunk_from_bytes(data: bytes):
    try:
        return EncodedChunk.from_bytes(data)
    except CodecError:
        return None


def chunk_dims(chunk: EncodedChunk):
    return int(chunk.width), int(chunk.height), int(chunk.frames)
