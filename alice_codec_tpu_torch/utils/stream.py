"""Streaming `.alcs` container: append-only chunk sequence with resume
(a copy of the JAX package's ``utils/stream.py`` on the port's
``EncodedChunk``: either package reads the other's files).

The checkpoint/resume analog of this framework (SURVEY §5.4): every `.alc`
chunk is self-contained (own histograms + quant params — reference
src/pipeline.rs:200-313), so a stream of chunks is resumable at any chunk
boundary.  ``AlcStreamWriter`` appends length-prefixed chunks; after a
crash, ``AlcStreamReader`` recovers every complete chunk and reports the
byte offset where writing can resume (truncated tails are dropped).

Format: ``"ALCS" | version u8 | reserved[3]`` then per chunk
``u32 LE length | chunk bytes`` (chunk bytes are standard `.alc`).
"""

from __future__ import annotations

import struct
from pathlib import Path

from ..errors import InvalidBitstream
from ..pipeline import EncodedChunk

__all__ = ["AlcStreamWriter", "AlcStreamReader"]

_MAGIC = b"ALCS"
_VERSION = 1
_HEADER = _MAGIC + bytes([_VERSION, 0, 0, 0])


class AlcStreamWriter:
    """Append-only chunk stream writer with crash-safe resume."""

    def __init__(self, path, *, resume: bool = False):
        self._path = Path(path)
        if resume and self._path.exists():
            reader = AlcStreamReader(self._path)
            chunks = list(reader)
            valid_end = reader.valid_end
            self.chunks_written = len(chunks)
            # truncate any partial tail, then append
            with open(self._path, "r+b") as fh:
                fh.truncate(valid_end)
            self._fh = open(self._path, "ab")
        else:
            self._fh = open(self._path, "wb")
            self._fh.write(_HEADER)
            self.chunks_written = 0

    def append(self, chunk: EncodedChunk) -> None:
        data = chunk.to_bytes()
        self._fh.write(struct.pack("<I", len(data)))
        self._fh.write(data)
        self.chunks_written += 1

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "AlcStreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AlcStreamReader:
    """Iterates complete chunks of an `.alcs` stream; tolerates a truncated
    tail (crash recovery) and reports ``valid_end`` for resuming."""

    def __init__(self, path):
        self._data = Path(path).read_bytes()
        if len(self._data) < len(_HEADER) or self._data[:4] != _MAGIC:
            raise InvalidBitstream("bad ALCS magic")
        if self._data[4] != _VERSION:
            raise InvalidBitstream(f"unsupported ALCS version: {self._data[4]}")
        self.valid_end = len(_HEADER)

    def __iter__(self):
        off = len(_HEADER)
        data = self._data
        while off + 4 <= len(data):
            (length,) = struct.unpack_from("<I", data, off)
            if off + 4 + length > len(data):
                break  # truncated tail — stop at last complete chunk
            try:
                chunk = EncodedChunk.from_bytes(data[off + 4 : off + 4 + length])
            except InvalidBitstream:
                break
            off += 4 + length
            self.valid_end = off
            yield chunk
