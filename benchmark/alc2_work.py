"""What one chunk of an ALC2 batch tells about its kernels' work: the
bytes each launched wrapper needs for it (``roofline.py`` reads them
through :func:`roofline.least_seconds` and the cell's ``nway_roofline``).

* ``encode_pack_nway`` (K8, one launch over every (chunk, channel)
  stream of the batch): the padded lane symbols in (one byte each), the
  packed payload out, the lane-length table out (int32);
* ``decode_nway`` (K9, one launch a batch): the payload and the lane
  table in (int64 starts, int32 lengths), the padded lane symbols out;
* ``forward_quant`` (K1) and ``inverse_3d`` (K7), one launch a chunk: as
  :class:`roofline.ChunkWork` counts them.

The payload bytes are the lane table's, so the count follows the data.
The 12-bit tables (a few KB a stream) are left out, so a share computed
from these bytes is never too high.  :func:`nway_event_ms` reads K8 and
K9's measured time, for the same share and ``nway_device_ms``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from statistics import median
from typing import ClassVar

from roofline import ChunkWork


@dataclass
class Alc2Work:
    """One chunk of an ALC2 batch: its three channel streams."""

    #: the wrappers each of whose launches serves one chunk; K8 and K9
    #: serve every chunk of the batch in one launch
    per_chunk: ClassVar[frozenset] = frozenset({"forward_quant", "inverse_3d"})

    p: int              # padded pixels of one channel plane
    n_sym: int          # a channel's symbols padded for the lanes
    n_lanes: int        # lanes a channel
    payload: int        # the chunk's payload bytes (its three channels)

    def bytes(self, wrapper: str) -> int | None:
        """Bytes this chunk's share of ``wrapper``'s work needs; None for a
        wrapper this table does not know."""
        lanes = 3 * self.n_lanes
        if wrapper == "encode_pack_nway":
            return 3 * self.n_sym + self.payload + 4 * lanes
        if wrapper == "decode_nway":
            return self.payload + 12 * lanes + 3 * self.n_sym
        if wrapper in self.per_chunk:
            return ChunkWork(p=self.p, pp=self.p, s_seg=0, n_streams=0, words=0,
                             channels=3, sparse_planes=0).bytes(wrapper)
        return None


def nway_event_ms() -> tuple[float, float] | None:
    """Median milliseconds of a K8 call and of a K9 call over the process's
    kept calls (CUDA event pairs around their launches, recorded by the
    port's ``ops.kernels.rans_nway`` wrappers); None where the port keeps
    no events or a wrapper has no finished call."""
    rn = sys.modules.get("alice_codec_tpu_torch.ops.kernels.rans_nway")
    event_ms = getattr(rn, "event_ms", None)
    if event_ms is None:
        return None
    k8, k9 = event_ms(rn.encode_pack_nway), event_ms(rn.decode_nway)
    if not k8 or not k9:
        return None
    return median(k8), median(k9)
