"""Device N-lane rANS of the ALC2 wire: the port of
``alice_codec_tpu/ops/rans_device.py``.

Lane k of a stream owns symbols k, k+N, k+2N, …; every lane is a
bit-exact reference rANS stream (same state math, renormalisation and
flush), and the lane framing equals the native N-way coder's
(``alc_rans_encode_nway``), so device-coded ALC2 payloads decode on the
host path and vice versa.

* ``encode_device_nway`` / ``decode_device_nway`` are the plain PyTorch
  versions of the N-lane kernels (``ops/kernels/rans_nway.py``, which
  holds the step loops and the layouts; states in int64 masked to 32
  bits), over many streams at once;
* ``pack_device`` turns one stream's per-step bytes into its packed
  payload (the emission-order scatter into reversed per-lane streams plus
  the 4-byte state flush) in torch: the plain version of the pack;
* ``encode_pack_device`` encodes many streams straight into their packed
  payloads, concatenated (``encode_pack_nway``: on the card the encode
  kernel writes the lane streams itself);
* :func:`pack_lane_streams` is the host (numpy) packer.

Tables must be sanitized (``FrequencyTable.from_histogram(...,
sanitize=True)``).
"""

from __future__ import annotations

import numpy as np

from .kernels.rans_nway import (decode_nway_plain, encode_nway_plain,
                                encode_pack_nway, pack_device)

__all__ = [
    "encode_device_nway",
    "decode_device_nway",
    "encode_pack_device",
    "pack_device",
    "pack_lane_streams",
]


#: the plain N-lane encode (``encode_nway``'s plain version), over
#: ``(S, n)`` streams
encode_device_nway = encode_nway_plain
#: the plain N-lane decode (``decode_nway``'s plain version)
decode_device_nway = decode_nway_plain
#: encode and pack ``(S, n)`` streams → ``(payload, lane_lens (S, lanes)
#: int32, totals (S,) int64)``, the payloads one after another
encode_pack_device = encode_pack_nway


def pack_lane_streams(bytes2, counts, states):
    """Host (numpy) packer of one stream's encode output: per lane, the
    emitted bytes in emission order, the 4 state bytes LSB first, the
    lane reversed.  Returns ``(payload bytes, lane_lens uint32[lanes])``."""
    b = np.asarray(bytes2)[::-1]   # emission order is the reversed rows
    c = np.asarray(counts)[::-1].astype(np.int64)
    st = np.asarray(states)
    steps, lanes, _ = b.shape
    lane_lens = c.sum(axis=0) + 4
    payload = np.empty(int(lane_lens.sum()), np.uint8)
    pos = 0
    for k in range(lanes):
        ck = c[:, k]
        n_bytes = int(ck.sum())
        lane = np.empty(n_bytes + 4, np.uint8)
        starts = np.cumsum(ck) - ck
        lane[starts[ck >= 1]] = b[ck >= 1, k, 0]
        lane[starts[ck >= 2] + 1] = b[ck >= 2, k, 1]
        x = int(st[k])
        lane[n_bytes:] = [x & 0xFF, (x >> 8) & 0xFF, (x >> 16) & 0xFF,
                          (x >> 24) & 0xFF]
        payload[pos : pos + lane.size] = lane[::-1]
        pos += lane.size
    return payload.tobytes(), lane_lens.astype(np.uint32)
