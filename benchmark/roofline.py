"""The bytes the port's kernels need, and the least time they could take.

A kernel's least time is the bytes its work needs over the card's memory
rate: each input byte read once and each output byte written once, at the
dtype of the kernel's interface.  The ALC3 kernels do integer work with
few operations a byte, so the memory rate bounds them all.  The bytes come
from the chunk's geometry and mode, the wrappers' launch counts and the
counted words of each chunk's wire, never from the port's buffer sizes: a
stream buffer padded to its worst case is not work.

Where the work depends on the data and a count is not at hand, the count
is left low (the sparse value rows of K5 / K6 are not counted), so a share
computed from these bytes is never too high.
"""

from __future__ import annotations

from dataclasses import dataclass

#: NVIDIA H100 SXM published HBM3 rate, bytes/s (at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12

#: the wrappers each of whose launches serves one chunk; the others serve
#: every chunk of a call (a batch) in one launch
PER_CHUNK = ("forward_quant", "inverse_dequant", "forward_3d", "inverse_3d")


@dataclass
class ChunkWork:
    """What one coded chunk tells about its kernels' work."""

    p: int                  # padded pixels of one channel plane
    pp: int                 # a sparse plane's symbols (p padded to whole blocks)
    s_seg: int              # symbol rows of a segment (128 lanes each)
    n_streams: int          # segments the chunk's wire holds
    words: int              # counted 16-bit words of those segments
    channels: int           # colour channels that went through the lifts
    sparse_planes: int      # planes coded sparse (bitmap + values)


def chunk_bytes(wrapper: str, w: ChunkWork) -> int | None:
    """Bytes one chunk's share of ``wrapper``'s work needs; None for a
    wrapper this table does not know."""
    c3 = w.channels * w.p
    seg_symbols = w.n_streams * w.s_seg * 128
    if wrapper in ("forward_quant", "inverse_dequant"):
        return 3 * c3                      # int16 volume and uint8 symbols
    if wrapper in ("forward_3d", "inverse_3d"):
        return 8 * c3                      # int32 in, int32 out
    if wrapper == "encode_words":
        return seg_symbols + 4 * w.words + 4 * w.n_streams
    if wrapper == "decode_words":
        return 4 * w.words + 4 * w.n_streams + seg_symbols
    if wrapper == "compact":                # symbols and tile rows in, bitmap out
        return w.sparse_planes * (w.pp + w.pp // 1024 * 4 + w.pp // 8)
    if wrapper == "expand":                 # bitmap in, symbols out
        return w.sparse_planes * (w.pp // 8 + w.p)
    return None


def least_seconds(launches: dict, chunks: list[ChunkWork]) -> float | None:
    """Least time of every launch in ``launches`` (wrapper → count) that
    served ``chunks``; None where a launched wrapper's bytes are unknown."""
    total = 0
    n = len(chunks)
    for wrapper, count in launches.items():
        if count == 0:
            continue
        per = [chunk_bytes(wrapper, w) for w in chunks]
        if any(b is None for b in per):
            return None
        if wrapper in PER_CHUNK:
            total += sum(per) * count / n  # one chunk a launch
        else:
            total += sum(per)               # every chunk once, in any launches
    return total / HBM_BYTES_PER_S
