"""ALC3 chunk codec, dense path (PyTorch port of
``alice_codec_tpu/alc3.py`` with ``sparse=False, rdo=False, deep=False,
levels=1`` — the constructor's defaults).

* encode: uint8 RGB → color → pad → fused lift + quantize kernel →
  sampled histograms → frequency tables → word-rANS encode kernel.  The
  result (:class:`DeviceChunk`: padded segment streams, word counts,
  histograms) stays on the device.
* decode: tables from the stored histograms → word-rANS decode kernel →
  fused dequantize + inverse lift kernel → inverse color → uint8 RGB.

The container (:meth:`Alc3Codec.to_bytes` / :meth:`Alc3Codec.from_bytes`)
is the JAX package's ALC3 wire, version 7, byte for byte::

    "ALC3" | version u8 (=7) | wavelet u8 | w u32 | h u32 | f u32
    n_chunks u32 | s_seg u32 | n_segments u32
    per chunk: flags u8, then per plane (Y, Co, Cg):
        ChannelHeader (1040 B) | n_segments × u32 segment word counts
    payload: per chunk/plane/segment, the meaningful u16 words (LE)

The other ALC3 modes (sparse significance coding, AnalyticalRDO steps,
deep 16-bit symbols — on by default at q=100 — and multi-level
decomposition) are not ported yet: the codec and the container parser
raise ``NotImplementedError`` for them instead of falling back to
another mode.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from ._device import resolve_device
from .core import WaveletType, padded_dims_levels, quality_to_step
from .errors import InvalidBitstream, InvalidBufferSize
from .ops.kernels.rans3 import (
    DEFAULT_V_SEG,
    NG,
    decode_words,
    encode_words,
    stream_rows,
)
from .ops.tables_device import freq_table_device
from .pipeline import ChannelHeader, decode_device, encode_device

__all__ = ["DEFAULT_S_SEG", "HIST_STRIDE", "DeviceChunk", "Alc3Codec"]

#: Default segment length (symbol rows per segment; wire constant).
DEFAULT_S_SEG = 2048
#: Histogram subsampling stride for table seeding (wire constant: the
#: stored histograms are the sampled ones).
HIST_STRIDE = 16

_MAGIC3 = b"ALC3"
_VERSION3 = 7  # v6: PROB_BITS 12 → 11; v7: zero-frequency absent symbols

_FLAG_RDO = 1
_FLAG_DEEP = 2
_FLAG_SPARSE = 16  # bits 2-3 hold the decomposition depth

_UNPORTED = {
    "sparse": "sparse significance coding (ROADMAP Queue 1 item 8)",
    "rdo": "AnalyticalRDO band steps (ROADMAP Queue 1 item 10)",
    "deep": "deep 16-bit symbols (ROADMAP Queue 1 item 10)",
    "levels": "multi-level decomposition (ROADMAP Queue 1 item 10)",
}


def _unported(mode: str) -> NotImplementedError:
    return NotImplementedError(
        f"the PyTorch port codes dense single-level ALC3 only; "
        f"{_UNPORTED[mode]} is not ported yet")


def _segment_geometry(padded_pixels: int, s_seg: int,
                      v_seg: int = DEFAULT_V_SEG) -> tuple[int, int]:
    """(n_segments per channel, padded symbol count per channel).

    n_segments is rounded up to a multiple of ``v_seg`` — wire-visible
    (the header's segment count), so kept although the CUDA kernels need
    no V-batching."""
    seg = s_seg * NG
    n_seg = -(-padded_pixels // seg)
    n_seg += (-n_seg) % v_seg
    return n_seg, n_seg * seg


def _table_hists(hists: torch.Tensor, nsym: int, *, s_seg: int,
                 v_seg: int = DEFAULT_V_SEG) -> torch.Tensor:
    """Histograms for table construction: the (m − nsym) padding zeros of
    the segment grid carry probability mass in bin 0 (scaled like the
    sampled histograms), identically on encode and decode; the STORED
    histograms stay the content histograms."""
    _, m = _segment_geometry(nsym, s_seg, v_seg)
    if m == nsym:
        return hists
    pad = -(-(m - nsym) // HIST_STRIDE)
    out = hists.clone()
    out[..., 0] += pad
    return out


def _pick_v_seg(n_seg: int) -> int:
    """Largest factor ≤ DEFAULT_V_SEG dividing the segment count (a chunk
    may carry any n_seg; it decides the table padding of
    :func:`_table_hists` as in the JAX package)."""
    v = DEFAULT_V_SEG
    while n_seg % v:
        v //= 2
    return v


def _covered_hist(hists: torch.Tensor, symbols: torch.Tensor) -> torch.Tensor:
    """Wire v7 coverage floor: every bin up to the plane's exact symbol
    maximum is lifted to ≥ 1, so a zero bin promises the symbol never
    occurs.  ``hists``: (n, 256); ``symbols``: (n, P)."""
    mx = symbols.amax(dim=-1).to(torch.int64)
    idx = torch.arange(256, device=hists.device)
    return torch.where(idx[None, :] <= mx[:, None], hists.clamp(min=1), hists)


def _encode_chunk(rgb, step: int, dead_zone: int, *, wavelet_type, padded,
                  s_seg: int, v_seg: int):
    """Full dense encode: RGB (T, H, W, 3) uint8 → (streams, counts,
    hists)."""
    symbols, hists = encode_device(
        rgb, step, dead_zone, wavelet_type=wavelet_type, padded=padded,
        hist_stride=HIST_STRIDE)
    hists = _covered_hist(hists, symbols)
    p = padded[0] * padded[1] * padded[2]
    freqs, cums = freq_table_device(
        _table_hists(hists, p, s_seg=s_seg, v_seg=v_seg))
    n_seg, m = _segment_geometry(p, s_seg, v_seg)
    if m != p:
        symbols = torch.nn.functional.pad(symbols, (0, m - p))
    streams, counts = encode_words(
        symbols.reshape(3 * n_seg, s_seg, NG), freqs, cums)
    return streams, counts, hists


def _entropy_decode(streams, counts, hists, *, padded, s_seg: int,
                    v_seg: int) -> torch.Tensor:
    """Segment decode → (3, P) uint8 symbols."""
    p = padded[0] * padded[1] * padded[2]
    freqs, cums = freq_table_device(
        _table_hists(hists, p, s_seg=s_seg, v_seg=v_seg))
    sym = decode_words(streams, counts, freqs, cums, s_seg=s_seg)
    return sym.reshape(3, -1)[:, :p]


def _decode_chunk(streams, counts, hists, steps, *, wavelet_type, dims,
                  padded, s_seg: int, v_seg: int, exact: bool = False):
    """Full dense decode: entropy decode, then the inverse transform."""
    sym = _entropy_decode(streams, counts, hists, padded=padded, s_seg=s_seg,
                          v_seg=v_seg)
    return decode_device(sym, steps, wavelet_type=wavelet_type, dims=dims,
                         padded=padded, exact=exact)


@dataclass
class DeviceChunk:
    """A compressed chunk held in device memory (dense ALC3).

    ``streams``: (3·n_seg, stream_rows(s_seg), 128) int32 padded segment
    word streams; ``counts``: (3·n_seg,) int32 meaningful words per
    segment; ``hists``: (3, 256) int64 stored (sampled) histograms."""

    width: int
    height: int
    frames: int
    wavelet_type: WaveletType
    quant_step: int
    s_seg: int
    streams: torch.Tensor
    counts: torch.Tensor
    hists: torch.Tensor

    @property
    def n_planes(self) -> int:
        return 3

    @property
    def n_segments(self) -> int:
        """Segments per plane."""
        return self.streams.shape[0] // self.n_planes

    @property
    def compressed_size(self) -> int:
        """Wire payload size in bytes (fetches only the counts)."""
        return int(self.counts.to(torch.int64).sum().item()) * 2

    @classmethod
    def from_numpy(cls, *, width, height, frames, wavelet_type, quant_step,
                   s_seg, streams, counts, hists, device=None) -> "DeviceChunk":
        """A chunk from the fields of a JAX ``DeviceChunk`` given as numpy
        arrays (a dense, single-level chunk); tensors go to ``device``."""
        dev = resolve_device(device)
        return cls(
            int(width), int(height), int(frames), WaveletType(int(wavelet_type)),
            int(quant_step), int(s_seg),
            torch.as_tensor(np.array(streams, np.int32), device=dev),
            torch.as_tensor(np.array(counts, np.int32), device=dev),
            torch.as_tensor(np.array(hists, np.int64), device=dev),
        )

    def to_numpy(self) -> dict:
        """The inverse of :meth:`from_numpy`: the JAX ``DeviceChunk``
        fields, arrays as numpy (histograms as uint32, like the JAX
        package's)."""
        return dict(
            width=self.width, height=self.height, frames=self.frames,
            wavelet_type=int(self.wavelet_type), quant_step=self.quant_step,
            s_seg=self.s_seg,
            streams=self.streams.cpu().numpy().astype(np.int32),
            counts=self.counts.cpu().numpy().astype(np.int32),
            hists=self.hists.cpu().numpy().astype(np.uint32),
        )


class Alc3Codec:
    """Dense ALC3 chunk codec on one device (CUDA unless ``device`` says
    otherwise).

    >>> import numpy as np
    >>> rgb = np.zeros((2, 8, 8, 3), np.uint8)
    >>> codec = Alc3Codec(quality=90, s_seg=8, device="cpu")
    >>> out = codec.decode(codec.encode(rgb), as_numpy=True)
    >>> bool((out == rgb).all())
    True
    """

    def __init__(self, quality: int = 90, wavelet: str | WaveletType = "cdf53",
                 *, s_seg: int = DEFAULT_S_SEG, rdo: bool = False,
                 deep: bool | None = None, levels: int = 1,
                 sparse: bool = False, device=None):
        if s_seg % 8:
            raise ValueError(f"s_seg must be a multiple of 8, got {s_seg}")
        if not 1 <= int(levels) <= 4:
            raise ValueError(f"levels must be in 1..4, got {levels}")
        self.quality = int(quality)
        self.wavelet_type = (
            wavelet if isinstance(wavelet, WaveletType)
            else WaveletType.from_name(wavelet))
        self.s_seg = int(s_seg)
        self.step = quality_to_step(self.quality)
        deep = (self.quality >= 100) if deep is None else bool(deep)
        if rdo and deep:
            raise ValueError("rdo and deep modes are mutually exclusive")
        if rdo and int(levels) != 1:
            raise ValueError("rdo supports single-level decomposition only")
        for mode, on in (("sparse", sparse), ("rdo", rdo), ("deep", deep),
                         ("levels", int(levels) != 1)):
            if on:
                raise _unported(mode)
        self.device = resolve_device(device)

    def encode(self, rgb) -> DeviceChunk:
        """Encode one (T, H, W, 3) uint8 chunk; accepts NumPy (uploaded
        once) or a tensor (moved to the codec's device if elsewhere)."""
        if isinstance(rgb, torch.Tensor):
            rgb = rgb.to(device=self.device, dtype=torch.uint8)
        else:
            arr = np.asarray(rgb, np.uint8)
            if not arr.flags.writeable:  # torch wraps only writable arrays
                arr = arr.copy()
            rgb = torch.as_tensor(arr, device=self.device)
        if rgb.ndim != 4 or rgb.shape[-1] != 3:
            raise InvalidBufferSize(4, rgb.ndim)
        t, h, w, _ = rgb.shape
        padded = padded_dims_levels(w, h, t, 1)
        n_seg, _ = _segment_geometry(int(np.prod(padded)), self.s_seg)
        streams, counts, hists = _encode_chunk(
            rgb, self.step, self.step, wavelet_type=self.wavelet_type,
            padded=padded, s_seg=self.s_seg, v_seg=_pick_v_seg(n_seg))
        return DeviceChunk(w, h, t, self.wavelet_type, self.step, self.s_seg,
                           streams, counts, hists)

    def decode(self, chunk: DeviceChunk, *, exact: bool = False,
               as_numpy: bool = False):
        """Decode back to (T, H, W, 3) uint8 — a tensor on the chunk's
        device, or a numpy array with ``as_numpy``."""
        w, h, t = chunk.width, chunk.height, chunk.frames
        dev = chunk.streams.device
        steps = torch.full((3,), chunk.quant_step, dtype=torch.int32, device=dev)
        rgb = _decode_chunk(
            chunk.streams, chunk.counts, chunk.hists, steps,
            wavelet_type=chunk.wavelet_type, dims=(w, h, t),
            padded=padded_dims_levels(w, h, t, 1), s_seg=chunk.s_seg,
            v_seg=_pick_v_seg(chunk.n_segments), exact=exact)
        return rgb.cpu().numpy() if as_numpy else rgb

    # ── container serialization (host interchange) ──────────────

    @staticmethod
    def to_bytes(chunks: DeviceChunk | list[DeviceChunk]) -> bytes:
        """Serialize chunk(s) to the ALC3 container (one device fetch per
        chunk; the compaction to meaningful words happens on the host)."""
        if isinstance(chunks, DeviceChunk):
            chunks = [chunks]
        if not chunks:
            raise InvalidBitstream("cannot serialize an empty chunk list")
        c0 = chunks[0]
        p = int(np.prod(padded_dims_levels(c0.width, c0.height, c0.frames, 1)))
        buf = bytearray(_MAGIC3)
        buf.append(_VERSION3)
        buf.append(int(c0.wavelet_type))
        buf += struct.pack("<IIIIII", c0.width, c0.height, c0.frames,
                           len(chunks), c0.s_seg,
                           _segment_geometry(p, c0.s_seg)[0])
        payload = bytearray()
        for ck in chunks:
            counts = ck.counts.cpu().numpy().astype(np.int64)
            streams = ck.streams.cpu().numpy()
            hists = ck.hists.cpu().numpy().astype(np.uint32)
            buf.append(0)  # flags: dense, single level
            n_seg = ck.n_segments
            for ch in range(ck.n_planes):
                row0 = ch * n_seg
                ch_counts = counts[row0 : row0 + n_seg]
                buf += ChannelHeader(
                    compressed_len=int(ch_counts.sum()) * 2,
                    quant_step=ck.quant_step,
                    quant_dead_zone=ck.quant_step,
                    num_symbols=p,
                    histogram=hists[ch],
                ).to_bytes()
                buf += ch_counts.astype("<u4").tobytes()
                for s in range(n_seg):
                    words = streams[row0 + s].reshape(-1)[: ch_counts[s]]
                    payload += words.astype("<u2").tobytes()
        return bytes(buf) + bytes(payload)

    @classmethod
    def from_bytes(cls, data: bytes, *, device=None
                   ) -> tuple["Alc3Codec", list[DeviceChunk]]:
        """Parse an ALC3 container and stage its chunks on ``device``.

        Returns ``(codec, chunks)``; the codec carries the container's
        quality (recovered from the stored step) and wavelet.  Raises
        :class:`InvalidBitstream` for malformed data and
        ``NotImplementedError`` for chunks of an unported mode."""
        data = bytes(data)
        if len(data) < 30:
            raise InvalidBitstream(f"ALC3 data too short: {len(data)} bytes")
        if data[:4] != _MAGIC3:
            raise InvalidBitstream("bad magic (expected ALC3)")
        if data[4] != _VERSION3:
            raise InvalidBitstream(f"unsupported ALC3 version: {data[4]}")
        wavelet_type = WaveletType.from_u8(data[5])
        w, h, f, n_chunks, s_seg, n_seg = struct.unpack_from("<IIIIII", data, 6)
        if s_seg % 8 or not s_seg or s_seg > (1 << 20):
            raise InvalidBitstream(f"invalid segment length: {s_seg}")
        dev = resolve_device(device)
        w_rows = stream_rows(s_seg)

        off = 30
        metas = []  # per chunk: (step, hists, counts per plane)
        for _ in range(n_chunks):
            if off + 1 > len(data):
                raise InvalidBitstream("truncated ALC3 chunk flags")
            flags = data[off]
            off += 1
            if flags & _FLAG_RDO and flags & _FLAG_DEEP:
                raise InvalidBitstream("rdo and deep flags are exclusive")
            for mode, bit in (("sparse", _FLAG_SPARSE), ("rdo", _FLAG_RDO),
                              ("deep", _FLAG_DEEP), ("levels", 12)):
                if flags & bit:
                    raise _unported(mode)
            p = int(np.prod(padded_dims_levels(w, h, f, 1)))
            hists = np.zeros((3, 256), np.uint32)
            counts_list = []
            step = 1
            for ch in range(3):
                if off + 1040 > len(data):
                    raise InvalidBitstream("truncated ALC3 header section")
                hdr = ChannelHeader.from_bytes(data[off : off + 1040])
                off += 1040
                if hdr.num_symbols != p:
                    raise InvalidBitstream(
                        f"num_symbols {hdr.num_symbols} != padded pixels {p}")
                ns = _segment_geometry(p, s_seg)[0]
                if ns != n_seg:
                    raise InvalidBitstream(
                        f"{n_seg} segments cannot cover {p} symbols")
                if off + 4 * ns > len(data):
                    raise InvalidBitstream("truncated ALC3 header section")
                ch_counts = np.frombuffer(data, "<u4", ns, off).astype(np.int64)
                off += 4 * ns
                if int(ch_counts.sum()) * 2 != hdr.compressed_len:
                    raise InvalidBitstream("segment counts disagree with header")
                hists[ch] = hdr.histogram
                step = hdr.quant_step
                counts_list.append(ch_counts)
            metas.append((step, hists, counts_list))

        chunks = []
        # every coded segment carries at least the 2·NG state-flush words
        # and at most s_seg steps' refills plus the flush
        segment_cap = (s_seg + 2) * NG
        for step, hists, counts_list in metas:
            flat_counts = np.concatenate(counts_list)
            if flat_counts.size == 0:
                raise InvalidBitstream("ALC3 chunk with no segments")
            if ((flat_counts != 0) & (flat_counts < 2 * NG)).any():
                raise InvalidBitstream(
                    "segment word count below the state-flush minimum")
            if (flat_counts > segment_cap).any():
                raise InvalidBitstream("segment word count exceeds capacity")
            n_rows = flat_counts.size
            streams = np.zeros((n_rows, w_rows * NG), np.int32)
            for i, cnt in enumerate(flat_counts):
                end = off + 2 * int(cnt)
                if end > len(data):
                    raise InvalidBitstream("truncated ALC3 payload")
                streams[i, : int(cnt)] = np.frombuffer(data, "<u2", int(cnt), off)
                off = end
            chunks.append(DeviceChunk(
                w, h, f, wavelet_type, int(step), int(s_seg),
                torch.as_tensor(streams.reshape(n_rows, w_rows, NG), device=dev),
                torch.as_tensor(flat_counts.astype(np.int32), device=dev),
                torch.as_tensor(hists.astype(np.int64), device=dev),
            ))
        # recover quality from the step map step = max(64 - q*63/100, 1)
        step0 = metas[0][0] if metas else 1
        quality = next(
            (q for q in range(100, -1, -1) if quality_to_step(q) == step0), 90)
        codec = cls(quality=quality, wavelet=wavelet_type, s_seg=int(s_seg),
                    deep=False, device=dev)
        return codec, chunks
