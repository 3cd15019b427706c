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
* :func:`pack_device` turns one stream's per-step bytes into its packed
  payload (the emission-order scatter into reversed per-lane streams plus
  the 4-byte state flush) in torch; :func:`encode_pack_device` runs the
  encode kernel over many streams and packs each;
* :func:`pack_lane_streams` is the host (numpy) packer.

Tables must be sanitized (``FrequencyTable.from_histogram(...,
sanitize=True)``).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.rans_nway import (decode_nway_plain, encode_nway,
                                encode_nway_plain)

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


def pack_device(bytes2: torch.Tensor, counts: torch.Tensor,
                states: torch.Tensor, *, n: int, n_lanes: int):
    """Pack one stream's encode output into its payload.

    Per lane: the renorm bytes in emission order (the reversed row
    order), then the 4 state bytes LSB first, the whole lane reversed —
    the ``RansEncoder.finish`` layout (reference src/rans.rs:298-308) —
    and the lanes one after another.  Returns ``(payload (2n + 4·lanes,)
    uint8 front-aligned with zeros past the total, lane_lens (lanes,)
    int32 including the 4 flush bytes, total int64 scalar)``."""
    dev = bytes2.device
    cap = 2 * n + 4 * n_lanes
    c_em = counts.flip(0).to(torch.int64)          # emission order
    prefix = torch.cumsum(c_em, 0) - c_em          # exclusive, per lane
    lane_lens = c_em.sum(0) + 4
    lane_start = torch.cumsum(lane_lens, 0) - lane_lens
    # emission byte p of lane k lands at start_k + len_k - 1 - p
    dst0 = (lane_start + lane_lens - 1) - prefix
    del prefix
    payload = torch.zeros(cap + 1, dtype=torch.uint8, device=dev)  # +1: sink
    b_em = bytes2.flip(0)
    for slot in range(2):
        dst = torch.where(c_em > slot, dst0 - slot, cap)
        payload.index_put_((dst.reshape(-1),), b_em[..., slot].reshape(-1))
        del dst
    for b in range(4):  # the state flush: final positions 3..0
        payload[lane_start + (3 - b)] = ((states >> (8 * b)) & 0xFF).to(torch.uint8)
    return payload[:cap], lane_lens.to(torch.int32), lane_lens.sum()


def encode_pack_device(symbols: torch.Tensor, freqs: torch.Tensor,
                       cums: torch.Tensor, *, n_lanes: int):
    """Encode ``S`` streams (``(S, n)`` uint8, tables (S, 256)) with one
    launch of the N-lane encode kernel, then pack them one at a time (a
    stream's scatter indices take about 16 bytes per symbol).  Returns
    ``(payloads (S, 2n + 4·lanes) uint8, lane_lens (S, lanes) int32,
    totals (S,) int64)``, all on the symbols' device."""
    s, n = symbols.shape
    bytes2, counts, states = encode_nway(symbols, freqs, cums, n_lanes=n_lanes)
    dev = symbols.device
    payloads = torch.empty((s, 2 * n + 4 * n_lanes), dtype=torch.uint8,
                           device=dev)
    lane_lens = torch.empty((s, n_lanes), dtype=torch.int32, device=dev)
    totals = torch.empty(s, dtype=torch.int64, device=dev)
    for i in range(s):
        payloads[i], lane_lens[i], totals[i] = pack_device(
            bytes2[i], counts[i], states[i], n=n, n_lanes=n_lanes)
    return payloads, lane_lens, totals


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
