"""Pipelined chunk streaming over the ALC3 codec (the port of
``alice_codec_tpu/streaming.py``).

A pipeline pays host work per chunk besides the device's: serializing a
container (a device→host fetch of its streams) on encode, parsing and
uploading on decode.  CUDA launches are asynchronous, so the two overlap
— the card codes chunk ``i+1`` while the host serializes chunk ``i`` — as
long as chunk ``i+1`` is dispatched before chunk ``i`` is fetched.  These
helpers keep that order with a bounded ``lookahead`` (each 1080p×64 chunk
in flight holds its compressed streams and its working set on the card).

``Alc3StreamWriter`` / ``Alc3StreamReader`` add the length-prefixed
`.alcs3` file framing, byte for byte the JAX package's::

    "ALS3" | version u8 (=1) | 3 reserved bytes
    per chunk: u32 LE length | ALC3 container

Every container is self-contained, so a truncated tail never corrupts
what came before it, and a writer can resume after it.
"""

from __future__ import annotations

import struct
from collections import deque
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from .alc3 import Alc3Codec, DeviceChunk
from .core import DEFAULT_CHUNK_SIZE
from .errors import InvalidBitstream
from .parallel.batch import chunk_frames

__all__ = [
    "encode_stream",
    "decode_stream",
    "Alc3StreamWriter",
    "Alc3StreamReader",
]

_MAGIC = b"ALS3"
_VERSION = 1
_HEADER = _MAGIC + bytes([_VERSION, 0, 0, 0])


def encode_stream(frames, codec: Alc3Codec | None = None, *,
                  chunk_size: int = DEFAULT_CHUNK_SIZE, lookahead: int = 2,
                  **codec_kwargs) -> Iterator[bytes]:
    """Encode (N, H, W, 3) uint8 frames into a stream of ALC3 containers.

    Yields one single-chunk container per ``chunk_size`` frames (the last
    partial chunk padded by repeating the last frame).  Encodes are
    dispatched up to ``lookahead`` chunks ahead of the serialization
    point.  ``codec_kwargs`` make an :class:`Alc3Codec` when ``codec`` is
    not given (``quality``, ``sparse``, ``device``, ...)."""
    if codec is None:
        codec = Alc3Codec(**codec_kwargs)
    batch, _n = chunk_frames(frames, chunk_size)
    pending: deque[DeviceChunk] = deque()
    for i in range(batch.shape[0]):
        pending.append(codec.encode(batch[i]))
        if len(pending) > max(lookahead, 0):
            yield Alc3Codec.to_bytes(pending.popleft())
    while pending:
        yield Alc3Codec.to_bytes(pending.popleft())


def decode_stream(containers: Iterable[bytes], *, lookahead: int = 2,
                  exact: bool = False, device=None) -> Iterator[np.ndarray]:
    """Decode a stream of ALC3 containers into (T, H, W, 3) uint8 chunks.

    The mirror of :func:`encode_stream`: container ``i+1`` is parsed,
    uploaded to ``device`` (the CUDA card unless given another) and its
    decode dispatched before chunk ``i``'s pixels are fetched; the queue
    holds tensors, and a chunk becomes a numpy array only when it is
    yielded."""
    pending: deque = deque()
    for data in containers:
        codec, chunks = Alc3Codec.from_bytes(data, device=device)
        for ch in chunks:
            pending.append(codec.decode(ch, exact=exact))
            if len(pending) > max(lookahead, 0):
                yield pending.popleft().cpu().numpy()
    while pending:
        yield pending.popleft().cpu().numpy()


class Alc3StreamWriter:
    """Append-only `.alcs3` stream writer with crash-safe resume.

    Format: ``"ALS3" | version u8 | reserved[3]`` then per chunk
    ``u32 LE length | ALC3 container bytes``."""

    def __init__(self, path, *, resume: bool = False):
        self._path = Path(path)
        # resume survives a crash anywhere in the previous run, even
        # before the 8-byte header was written: a file shorter than the
        # header (or none) starts afresh; a wrong magic or version raises
        if (resume and self._path.exists()
                and self._path.stat().st_size >= len(_HEADER)):
            reader = Alc3StreamReader(self._path)
            self.containers_written = sum(1 for _ in reader)
            with open(self._path, "r+b") as fh:
                fh.truncate(reader.valid_end)  # drop any partial tail
            self._fh = open(self._path, "ab")
        else:
            self._fh = open(self._path, "wb")
            self._fh.write(_HEADER)
            self.containers_written = 0

    def append(self, container: bytes) -> None:
        self._fh.write(struct.pack("<I", len(container)))
        self._fh.write(container)
        self.containers_written += 1

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "Alc3StreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Alc3StreamReader:
    """Iterate the complete containers of an `.alcs3` stream.

    ``valid_end``: the byte offset after the last complete container read
    so far — the resume point of :class:`Alc3StreamWriter`."""

    def __init__(self, path):
        self._path = Path(path)
        data = self._path.read_bytes()
        if len(data) < len(_HEADER) or data[:4] != _MAGIC:
            raise InvalidBitstream("bad .alcs3 stream header")
        if data[4] != _VERSION:
            raise InvalidBitstream(f"unsupported .alcs3 version: {data[4]}")
        self._data = data
        self.valid_end = len(_HEADER)

    def __iter__(self) -> Iterator[bytes]:
        data, off = self._data, len(_HEADER)
        while off + 4 <= len(data):
            (length,) = struct.unpack_from("<I", data, off)
            if off + 4 + length > len(data):
                break  # a truncated tail: stop at the last whole container
            yield data[off + 4 : off + 4 + length]
            off += 4 + length
            self.valid_end = off
