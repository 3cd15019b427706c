"""Batched chunk encode / decode and the ALC2 batched container: the port
of ``alice_codec_tpu/parallel/batch.py``.

* The encode stage (colour → pad → lift → quantize → zigzag → histograms,
  in the reference ``[low | high]`` layout of the `.alc` wire) runs per
  chunk on the working device.
* Entropy coding is the N-way interleaved rANS: lane k of a channel owns
  symbols k, k+N, …, each lane a reference rANS stream with the
  channel's sanitized 12-bit table — on the host by the native coder
  (OpenMP over the lanes), or with ``device_entropy=True`` on the
  device: one call of the N-lane encode-and-pack route over every
  (chunk, channel) stream of the batch, whose kernels write the packed
  payload themselves; on decode one launch of the N-lane decode kernel
  reading the lanes straight out of the uploaded payload.  Both give the
  same bytes.

ALC2 container layout (little-endian)::

    "ALC2" | version=2 | wavelet u8 | w u32 | h u32 | f u32
    n_chunks u32 | n_lanes u32
    per chunk × n_chunks, per channel × 3:
        ChannelHeader (1040 B, as in .alc) | lane-length table (n_lanes × u32)
    concatenated payloads (chunk-major, channel-major, lane-major)

Every chunk stays independently decodable (self-contained headers and
histograms).  With ``mesh=`` (:func:`~.mesh.chunk_mesh`) the encode and
decode stages run on every device over its shard of the batch; the
entropy stage runs on the first, so the stream is the one without a
mesh.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..core import WaveletType, padded_dims, quality_to_step
from ..errors import InvalidBitstream, InvalidBufferSize
from ..native import get_lib
from ..ops.kernels.rans_nway import decode_nway, encode_pack_nway
from ..ops.rans import FrequencyTable, RansDecoder, RansEncoder, _ctypes_ptr
from ..pipeline import ChannelHeader, as_uint8_tensor, decode_device, encode_device
from .mesh import gather, on_device, shard_batch

__all__ = [
    "DEFAULT_LANES",
    "BatchFrameEncoder",
    "BatchFrameDecoder",
    "EncodedChunkStream",
    "chunk_frames",
]

#: Default interleave width of the N-way rANS.
DEFAULT_LANES = 64

_MAGIC2 = b"ALC2"
#: v2: per-lane step counts 8-aligned (:func:`_lane_sym_count`) — a
#: different symbol padding than v1, so v1 files are rejected.
_VERSION2 = 2


def _lane_sym_count(padded_pixels: int, n_lanes: int) -> int:
    """Symbols per channel padded for the lane coders: a whole number of
    lanes and a per-lane step count that is a multiple of 8 (the TPU
    kernels' tile; a wire constant).  The padding zeros are
    entropy-coded, so encoder and decoder must agree exactly."""
    steps = -(-padded_pixels // n_lanes)
    steps += (-steps) % 8
    return steps * n_lanes


def chunk_frames(frames: np.ndarray, chunk_size: int = 64) -> tuple[np.ndarray, int]:
    """Split (N, H, W, 3) frames into a (B, chunk_size, H, W, 3) batch.

    The final partial chunk is padded by repeating the last frame; returns
    (batch, total_real_frames).
    """
    frames = np.asarray(frames, np.uint8)
    n = frames.shape[0]
    b = -(-n // chunk_size)
    pad = b * chunk_size - n
    if pad:
        frames = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)])
    return frames.reshape(b, chunk_size, *frames.shape[1:]), n


def _encode_batch_device(rgb, step, dead_zone, *, wavelet_type, padded,
                         sharded: bool = False):
    """The encode stage of every chunk, in the reference layout:
    ``(symbols (B, 3, P) uint8, histograms (B, 3, 256) int64)`` on
    ``rgb``'s device.  ``sharded``: ``rgb`` is a list of per-device shards
    (:func:`~.mesh.shard_batch`), and the results are lists of per-shard
    tensors on their devices, every device's work issued before any is
    read."""
    if sharded:
        outs = []
        for x in rgb:
            with on_device(x.device):
                outs.append(_encode_batch_device(
                    x, step, dead_zone, wavelet_type=wavelet_type,
                    padded=padded))
        return [o[0] for o in outs], [o[1] for o in outs]
    outs = [encode_device(rgb[i], step, dead_zone, wavelet_type=wavelet_type,
                          padded=padded, interleaved=False)
            for i in range(rgb.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def _decode_batch_device(symbols, steps, *, wavelet_type, dims, padded,
                         exact: bool = False, sharded: bool = False):
    """The decode stage of every chunk: (B, 3, P) uint8 symbols in the
    reference layout and (B, 3) steps → (B, T, H, W, 3) uint8 RGB;
    ``sharded`` as for :func:`_encode_batch_device`."""
    if sharded:
        outs = []
        for sym, st in zip(symbols, steps):
            with on_device(sym.device):
                outs.append(_decode_batch_device(
                    sym, st, wavelet_type=wavelet_type, dims=dims,
                    padded=padded, exact=exact))
        return outs
    return torch.stack([decode_device(symbols[i], steps[i],
                                      wavelet_type=wavelet_type, dims=dims,
                                      padded=padded, exact=exact,
                                      interleaved=False)
                        for i in range(symbols.shape[0])])


@dataclass
class EncodedChunkStream:
    """A batch of compressed chunks in the ALC2 container."""

    width: int
    height: int
    frames: int  # frames per chunk
    wavelet_type: WaveletType
    n_lanes: int
    chunk_headers: list[list[ChannelHeader]]  # [chunk][channel]
    lane_lens: np.ndarray  # (n_chunks, 3, n_lanes) uint32
    payload: bytes

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_headers)

    @property
    def compressed_size(self) -> int:
        return len(self.payload)

    def to_bytes(self) -> bytes:
        buf = bytearray()
        buf += _MAGIC2
        buf.append(_VERSION2)
        buf.append(int(self.wavelet_type))
        buf += struct.pack("<IIIII", self.width, self.height, self.frames,
                           self.n_chunks, self.n_lanes)
        for ci, headers in enumerate(self.chunk_headers):
            for ch in range(3):
                buf += headers[ch].to_bytes()
                buf += self.lane_lens[ci, ch].astype("<u4").tobytes()
        buf += self.payload
        return bytes(buf)

    @classmethod
    def from_bytes(cls, data: bytes) -> "EncodedChunkStream":
        data = bytes(data)
        if len(data) < 26:
            raise InvalidBitstream(f"ALC2 data too short: {len(data)} bytes")
        if data[:4] != _MAGIC2:
            raise InvalidBitstream("bad magic (expected ALC2)")
        if data[4] != _VERSION2:
            raise InvalidBitstream(f"unsupported ALC2 version: {data[4]}")
        wavelet_type = WaveletType.from_u8(data[5])
        width, height, frames, n_chunks, n_lanes = struct.unpack_from(
            "<IIIII", data, 6)
        off = 26
        chunk_headers = []
        lane_lens = np.zeros((n_chunks, 3, n_lanes), np.uint32)
        total = 0
        for ci in range(n_chunks):
            headers = []
            for ch in range(3):
                if off + 1040 + 4 * n_lanes > len(data):
                    raise InvalidBitstream("truncated ALC2 header section")
                hdr = ChannelHeader.from_bytes(data[off : off + 1040])
                off += 1040
                lane_lens[ci, ch] = np.frombuffer(data, "<u4", n_lanes, off)
                off += 4 * n_lanes
                headers.append(hdr)
                total += hdr.compressed_len
            chunk_headers.append(headers)
        if len(data) < off + total:
            raise InvalidBitstream(
                f"truncated ALC2 payload: need {off + total - len(data)} more bytes")
        return cls(width, height, frames, wavelet_type, n_lanes,
                   chunk_headers, lane_lens, data[off : off + total])


class BatchFrameEncoder:
    """Chunk-batched encoder to the ALC2 container with N-way interleaved
    entropy coding.

    ``device_entropy=True`` codes the lanes on ``device`` (the CUDA card
    unless given another): on the card always through the N-lane
    encode-and-pack kernels — the JAX package's scan coder and its
    fallback to it have no counterpart here, the kernels take any step
    count — and on the CPU through their plain version.  ``pallas_entropy`` is accepted for API
    parity and changes nothing.  ``mesh`` (:func:`~.mesh.chunk_mesh`): the
    encode stage runs on every mesh device over its shard of the batch,
    the entropy stage on the first device (the working device unless
    ``device`` names another); the stream is the one without a mesh.
    """

    def __init__(self, quality: int = 90, wavelet: str | WaveletType = "cdf53",
                 *, n_lanes: int = DEFAULT_LANES, mesh=None,
                 device_entropy: bool = False, pallas_entropy: bool = False,
                 device=None):
        self.quality = int(quality)
        self.wavelet_type = (wavelet if isinstance(wavelet, WaveletType)
                             else WaveletType.from_name(wavelet))
        self.n_lanes = int(n_lanes)
        self.mesh = mesh
        self.device_entropy = bool(device_entropy)
        self.pallas_entropy = bool(pallas_entropy)
        self.step = quality_to_step(self.quality)
        self.device = (mesh.devices[0] if mesh is not None and device is None
                       else resolve_device(device))

    def encode_device_stage(self, batch):
        """The encode stage of every chunk: ``(symbols (B, 3, P) uint8,
        histograms (B, 3, 256) int64)`` on the working device.  ``batch``:
        (B, T, H, W, 3) uint8, numpy or a tensor (used in place when it is
        already on the device); with a mesh, split over its devices and
        the results gathered."""
        b, t, h, w, _ = batch.shape
        kw = dict(wavelet_type=self.wavelet_type, padded=padded_dims(w, h, t))
        if self.mesh is None:
            return _encode_batch_device(as_uint8_tensor(batch, self.device),
                                        self.step, self.step, **kw)
        sym, hists = _encode_batch_device(
            [x.to(torch.uint8) for x in shard_batch(batch, self.mesh)],
            self.step, self.step, sharded=True, **kw)
        return gather(sym, self.device), gather(hists, self.device)

    def encode(self, batch) -> EncodedChunkStream:
        """Encode a (B, T, H, W, 3) uint8 chunk batch (numpy or a tensor)
        into an ALC2 stream."""
        if not isinstance(batch, torch.Tensor):
            batch = np.asarray(batch, np.uint8)
        if batch.ndim != 5 or batch.shape[-1] != 3:
            raise InvalidBufferSize(5, batch.ndim)
        b, t, h, w, _ = batch.shape
        padded = padded_dims(w, h, t)
        padded_pixels = padded[0] * padded[1] * padded[2]
        n_sym = _lane_sym_count(padded_pixels, self.n_lanes)
        lanes = self.n_lanes

        symbols_dev, hists_dev = self.encode_device_stage(batch)
        hists = hists_dev.cpu().numpy().astype(np.uint32)
        tables = [FrequencyTable.from_histogram(hists[ci, ch], sanitize=True)
                  for ci in range(b) for ch in range(3)]

        syms = torch.nn.functional.pad(
            symbols_dev.reshape(b * 3, padded_pixels),
            (0, n_sym - padded_pixels))
        if self.device_entropy:
            dev = syms.device
            freqs = torch.as_tensor(np.stack([tb.freqs for tb in tables]),
                                    dtype=torch.int32).to(dev)
            cums = torch.as_tensor(np.stack([tb.cums for tb in tables]),
                                   dtype=torch.int32).to(dev)
            pay, lens, totals = encode_pack_nway(syms, freqs, cums,
                                                 n_lanes=lanes)
            lane_lens = lens.cpu().numpy().astype(np.uint32).reshape(b, 3, lanes)
            sizes = totals.cpu().tolist()
            payload = pay.cpu().numpy().tobytes()
        else:
            symbols = syms.cpu().numpy()
            lib = get_lib()
            lane_lens = np.zeros((b * 3, lanes), np.uint32)
            parts, sizes = [], []
            out = np.empty(2 * n_sym + 8 * lanes, np.uint8)
            for i, table in enumerate(tables):
                total = lib.alc_rans_encode_nway(
                    _ctypes_ptr(symbols[i]), n_sym, lanes,
                    _ctypes_ptr(table.freqs), _ctypes_ptr(table.cums),
                    _ctypes_ptr(out), _ctypes_ptr(lane_lens[i]))
                parts.append(out[:total].tobytes())
                sizes.append(total)
            payload = b"".join(parts)
            lane_lens = lane_lens.reshape(b, 3, lanes)

        chunk_headers = [
            [ChannelHeader(compressed_len=int(sizes[ci * 3 + ch]),
                           quant_step=self.step, quant_dead_zone=self.step,
                           num_symbols=padded_pixels, histogram=hists[ci, ch])
             for ch in range(3)]
            for ci in range(b)]
        return EncodedChunkStream(w, h, t, self.wavelet_type, lanes,
                                  chunk_headers, lane_lens, payload)


class BatchFrameDecoder:
    """Chunk-batched decoder of ALC2 streams.

    ``device_entropy=True`` decodes the lanes on ``device`` (the CUDA
    card unless given another): on the card always through the N-lane
    decode kernel, which reads each lane straight out of the uploaded
    payload, so symbols never visit the host; on the CPU through its
    plain version.  ``pallas_entropy=True`` implies ``device_entropy``
    (as in the JAX package) and changes nothing else.  ``mesh``
    (:func:`~.mesh.chunk_mesh`): the entropy stage runs on the first
    device (the working device unless ``device`` names another), the
    decode stage on every mesh device over its shard of the batch, and
    the RGB is gathered onto the working device."""

    def __init__(self, *, mesh=None, device_entropy: bool = False,
                 pallas_entropy: bool = False, device=None):
        self.mesh = mesh
        self.device_entropy = bool(device_entropy) or bool(pallas_entropy)
        self.pallas_entropy = bool(pallas_entropy)
        self.device = (mesh.devices[0] if mesh is not None and device is None
                       else resolve_device(device))

    def decode(self, stream: EncodedChunkStream, *, exact: bool = False,
               as_numpy: bool = True):
        """Decode to a (B, T, H, W, 3) uint8 batch: numpy, or with
        ``as_numpy=False`` a tensor on the working device."""
        w, h, t = stream.width, stream.height, stream.frames
        padded = padded_dims(w, h, t)
        padded_pixels = padded[0] * padded[1] * padded[2]
        b = stream.n_chunks
        lanes = stream.n_lanes
        n_sym = _lane_sym_count(padded_pixels, lanes)
        dev = self.device

        steps = np.empty((b, 3), np.int32)
        payload = np.frombuffer(stream.payload, np.uint8)
        tables, spans = [], []
        offset = 0
        for ci in range(b):
            for ch in range(3):
                hdr = stream.chunk_headers[ci][ch]
                if hdr.num_symbols != padded_pixels:
                    raise InvalidBitstream(
                        f"chunk {ci} channel {ch}: num_symbols mismatch")
                end = offset + hdr.compressed_len
                if end > len(payload):
                    raise InvalidBitstream(
                        f"chunk {ci} channel {ch}: compressed data overrun")
                spans.append((offset, end))
                offset = end
                tables.append(
                    FrequencyTable.from_histogram(hdr.histogram, sanitize=True))
                steps[ci, ch] = hdr.quant_step

        if self.device_entropy and b:
            lens = stream.lane_lens.reshape(b * 3, lanes).astype(np.int64)
            starts = np.cumsum(lens, axis=1) - lens
            starts += np.asarray([s0 for s0, _ in spans], np.int64)[:, None]
            # every lane inside the payload, whatever the lane table says
            lens = np.clip(np.minimum(lens, len(payload) - starts), 0, None)
            sym = decode_nway(
                torch.from_numpy(payload.copy()).to(dev),
                torch.from_numpy(starts).to(dev),
                torch.from_numpy(lens.astype(np.int32)).to(dev),
                torch.from_numpy(np.stack([tb.freqs for tb in tables])
                                 .astype(np.int32)).to(dev),
                torch.from_numpy(np.stack([tb.cums for tb in tables])
                                 .astype(np.int32)).to(dev),
                torch.from_numpy(np.stack([tb.cum_to_sym for tb in tables])).to(dev),
                steps=n_sym // lanes)
            sym = sym.reshape(b, 3, n_sym)[:, :, :padded_pixels]
        else:
            lib = get_lib()
            symbols = np.empty((b, 3, n_sym), np.uint8)
            for i, (s0, s1) in enumerate(spans):
                ci, ch = divmod(i, 3)
                data = np.ascontiguousarray(payload[s0:s1])
                table = tables[i]
                lens = np.ascontiguousarray(stream.lane_lens[ci, ch], np.uint32)
                lib.alc_rans_decode_nway(
                    _ctypes_ptr(data), n_sym, lanes, _ctypes_ptr(lens),
                    _ctypes_ptr(table.freqs), _ctypes_ptr(table.cums),
                    _ctypes_ptr(table.cum_to_sym),
                    symbols[ci, ch].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            sym = torch.from_numpy(symbols[:, :, :padded_pixels]).to(dev)

        steps_dev = torch.from_numpy(steps).to(dev)
        kw = dict(wavelet_type=stream.wavelet_type, dims=(w, h, t),
                  padded=padded, exact=exact)
        if not b:
            rgb = torch.empty((0, t, h, w, 3), dtype=torch.uint8, device=dev)
        elif self.mesh is None:
            rgb = _decode_batch_device(sym, steps_dev, **kw)
        else:
            rgb = gather(_decode_batch_device(
                shard_batch(sym, self.mesh), shard_batch(steps_dev, self.mesh),
                sharded=True, **kw), dev)
        return rgb.cpu().numpy() if as_numpy else rgb


# ── pure-Python N-way coder (the spec) ──────────────────────────


def _nway_encode_py(syms: np.ndarray, table: FrequencyTable, n_lanes: int):
    streams = []
    lens = np.zeros(n_lanes, np.uint32)
    for k in range(n_lanes):
        enc = RansEncoder(native=False)
        enc.encode_symbols(syms[k::n_lanes], table)
        s = enc.finish()
        streams.append(s)
        lens[k] = len(s)
    return b"".join(streams), lens


def _nway_decode_py(data, n, lane_lens, table) -> np.ndarray:
    out = np.empty(n, np.uint8)
    off = 0
    buf = data if isinstance(data, bytes) else np.asarray(data, np.uint8).tobytes()
    lanes = len(lane_lens)
    for k in range(lanes):
        ln = int(lane_lens[k])
        dec = RansDecoder(buf[off : off + ln], native=False)
        out[k::lanes] = dec.decode_n((n - k + lanes - 1) // lanes, table)
        off += ln
    return out
