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

A driver's summaries become work items (``drivers/<driver>.py``
``work``): :class:`ChunkWork` for ALC3.  Another driver brings its own
type, in its own file, with the same ``bytes(wrapper)`` and ``per_chunk``;
:func:`least_seconds` asks each item for each launched wrapper.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

#: NVIDIA H100 SXM published HBM3 rate, bytes/s (at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12


@dataclass
class ChunkWork:
    """What one coded ALC3 chunk tells about its kernels' work."""

    #: the wrappers each of whose launches serves one chunk; the others
    #: serve every chunk of a call (a batch) in one launch
    per_chunk: ClassVar[frozenset] = frozenset(
        {"forward_quant", "inverse_dequant", "forward_3d", "inverse_3d"})

    p: int                  # padded pixels of one channel plane
    pp: int                 # a sparse plane's symbols (p padded to whole blocks)
    s_seg: int              # symbol rows of a segment (128 lanes each)
    n_streams: int          # segments the chunk's wire holds
    words: int              # counted 16-bit words of those segments
    channels: int           # colour channels that went through the lifts
    sparse_planes: int      # planes coded sparse (bitmap + values)

    def bytes(self, wrapper: str) -> int | None:
        """Bytes this chunk's share of ``wrapper``'s work needs; None for a
        wrapper this table does not know."""
        c3 = self.channels * self.p
        seg_symbols = self.n_streams * self.s_seg * 128
        if wrapper in ("forward_quant", "inverse_dequant"):
            return 3 * c3                      # int16 volume and uint8 symbols
        if wrapper in ("forward_3d", "inverse_3d"):
            return 8 * c3                      # int32 in, int32 out
        if wrapper == "encode_words":
            return seg_symbols + 4 * self.words + 4 * self.n_streams
        if wrapper == "decode_words":
            return 4 * self.words + 4 * self.n_streams + seg_symbols
        if wrapper == "compact":                # symbols and tile rows in, bitmap out
            return self.sparse_planes * (self.pp + self.pp // 1024 * 4 + self.pp // 8)
        if wrapper == "expand":                 # bitmap in, symbols out
            return self.sparse_planes * (self.pp // 8 + self.p)
        return None


def least_seconds(launches: dict, work: list) -> float | None:
    """Least time of every launch in ``launches`` (wrapper → count) that
    served ``work``, one item a chunk (its ``bytes(wrapper)`` and
    ``per_chunk``, as :class:`ChunkWork` has them); None where no item
    counts a launched wrapper's bytes."""
    total = 0
    n = len(work)
    for wrapper, count in launches.items():
        if count == 0:
            continue
        per = [w.bytes(wrapper) for w in work]
        if not per or any(b is None for b in per):
            return None
        if wrapper in work[0].per_chunk:
            total += sum(per) * count / n  # one chunk a launch
        else:
            total += sum(per)               # every chunk once, in any launches
    return total / HBM_BYTES_PER_S
