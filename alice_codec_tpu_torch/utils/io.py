"""Raw video IO helpers, host side (a copy of the JAX package's
``utils/io.py``).

The reference's CLI consumes raw interleaved RGB files (reference:
src/bin/main.rs:117); these helpers generalize that to frame iteration and
chunked streaming for the batch pipeline.
"""

from __future__ import annotations

import numpy as np

from ..errors import InvalidBufferSize

__all__ = ["read_raw_rgb", "write_raw_rgb", "iter_chunks"]


def read_raw_rgb(path, width: int, height: int, frames: int | None = None) -> np.ndarray:
    """Read a raw interleaved RGB file into (N, H, W, 3) uint8.

    With ``frames=None`` the frame count is inferred from the file size.
    """
    data = np.fromfile(str(path), np.uint8)
    frame_bytes = width * height * 3
    if frame_bytes == 0:
        raise InvalidBufferSize(1, 0)
    if frames is None:
        if data.size % frame_bytes:
            raise InvalidBufferSize(
                (data.size // frame_bytes + 1) * frame_bytes, data.size
            )
        frames = data.size // frame_bytes
    expected = frames * frame_bytes
    if data.size < expected:
        raise InvalidBufferSize(expected, data.size)
    return data[:expected].reshape(frames, height, width, 3)


def write_raw_rgb(path, frames: np.ndarray) -> None:
    """Write (N, H, W, 3) uint8 frames as raw interleaved RGB."""
    np.asarray(frames, np.uint8).tofile(str(path))


def iter_chunks(frames: np.ndarray, chunk_size: int = 64):
    """Yield (chunk (T,H,W,3), real_frame_count) views over a frame array.

    The final partial chunk is NOT padded (callers pass real counts to the
    encoder, matching the reference's variable-frame chunks).
    """
    n = frames.shape[0]
    for start in range(0, n, chunk_size):
        chunk = frames[start : start + chunk_size]
        yield chunk, chunk.shape[0]
