"""ALC3 chunk codec (PyTorch port of ``alice_codec_tpu/alc3.py``): the
dense path (the constructor's default), sparse significance coding
(``sparse=True``, the JAX package's north star), AnalyticalRDO per-band
steps (``rdo=True``), deep 16-bit symbols (``deep=True``, on by default
at q=100, where it is lossless with ``exact=True``) and multi-level
decomposition (``levels`` 2-4), with every composition the JAX package
accepts.

* dense encode: uint8 RGB → color → pad → fused lift + quantize kernel →
  sampled histograms → frequency tables → word-rANS encode kernel.  The
  result (:class:`DeviceChunk`: padded segment streams, word counts,
  histograms) stays on the device.
* dense decode: tables from the stored histograms → word-rANS decode
  kernel → fused dequantize + inverse lift kernel → inverse color → RGB.
* the other modes swap the transform stage (``pipeline``): the plain 3D
  lift kernel and the subgrid lifts, then per-band (rdo) or 16-bit (deep:
  6 lo/hi byte planes, each with its own table) symbols; the entropy
  stage is the same.
* sparse encode: the transform over the channels with nonzero colour
  only; each plane then is elided (no nonzero symbol), coded dense (its
  value rows reach ``DENSE_ROW_FRAC`` of the plane) or split by the
  compact kernel into a significance bitmap and its nonzero values; the
  sparse planes' bitmaps and every coded plane's values go through the
  word-rANS encode kernel.  Sparse decode reverses it with the decode and
  expand kernels.  Deep chunks' 6 byte planes ride the sparse wire as 6
  planes of their own.

The container (:meth:`Alc3Codec.to_bytes` / :meth:`Alc3Codec.from_bytes`)
is the JAX package's ALC3 wire, version 7, byte for byte::

    "ALC3" | version u8 (=7) | wavelet u8 | w u32 | h u32 | f u32
    n_chunks u32 | s_seg u32 | n_segments u32
    per chunk: flags u8 (1: rdo, 2: deep, bits 2-3: levels − 1,
    16: sparse), then per plane (Y, Co, Cg — or their lo/hi byte planes
    when deep; sparse: the bitmap planes, then the value planes):
        ChannelHeader (1040 B) | segment count × u32 segment word counts
        | [rdo, first 3 plane sections] 8 × i32 per-band quant steps
    payload: per chunk/plane/segment, the meaningful u16 words (LE)

A sparse value plane's ``num_symbols`` is its capacity ``kcap``: 0 elides
the plane (its bitmap section then has no segments either), the full
dense capacity marks a dense plane (its bitmap segments ship elided).

``encode_batch`` / ``decode_batch`` code B chunks of one geometry with
one word-rANS launch each way (and one compact / expand launch where
planes are sparse) over the whole batch, and K1 / K4 once a chunk; with a
chunk mesh (``parallel.mesh``) each device codes its shard.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, replace

import numpy as np
import torch

from ._device import resolve_device
from .core import WaveletType, padded_dims_levels, quality_to_step
from .errors import InvalidBitstream, InvalidBufferSize
from .ops.kernels.hist import plane_stats
from .ops.kernels.rans3 import (
    DEFAULT_V_SEG,
    NG,
    decode_words,
    encode_words,
    stream_rows,
)
from .ops.kernels.sparse import (BLOCK_ROWS, DEFAULT_V_BLK, compact, expand,
                                 tile_rows)
from .ops.quant import AnalyticalRDO, quantize_bands_inter, to_symbols
from .ops.tables_device import freq_table_device
from .parallel.mesh import gather, on_device, shard_batch
from .pipeline import (
    ChannelHeader,
    as_uint8_tensor,
    decode_bands_device,
    decode_deep_device,
    decode_device,
    encode_bands_device,
    encode_deep_device,
    encode_deep_sparse_phase1,
    encode_device,
    encode_sparse_phase1,
    transform_moments_device,
)

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


def _covered_hist(hists: torch.Tensor, maxima: torch.Tensor) -> torch.Tensor:
    """Wire v7 coverage floor: every bin up to the plane's exact symbol
    maximum is lifted to ≥ 1, so a zero bin promises the symbol never
    occurs.  ``hists``: (n, 256); ``maxima``: (n,) int64, each plane's
    symbol maximum (``plane_stats`` takes it in the histograms' pass)."""
    idx = torch.arange(256, device=hists.device)
    return torch.where(idx[None, :] <= maxima[:, None], hists.clamp(min=1),
                       hists)


def _sparse_pp(p: int) -> int:
    """Plane symbols padded to a whole number of DEFAULT_V_BLK compaction
    blocks (the sparse wire codes this padded plane; decoders strip it
    back to ``p``)."""
    blk = BLOCK_ROWS * NG * DEFAULT_V_BLK
    return -(-p // blk) * blk


#: Per-plane dense/sparse crossover, as a fraction of the plane's pixel
#: rows (the JAX package's measured indifference point on its TPU; a
#: wire-visible constant).  A plane whose value rows reach it is coded
#: dense inside the sparse wire: its kcap is the full dense capacity, its
#: value section is the raw symbol plane, and its bitmap ships elided.
DENSE_ROW_FRAC = 0.05


def _bucket_nv(need_rows: int, s_seg: int, max_nv: int | None = None) -> int:
    """Value-plane segment count covering ``need_rows`` value rows: a
    multiple of DEFAULT_V_SEG on a 3-bit mantissa grid, clamped to
    ``max_nv`` (the dense plane's segment count); 0 for 0 rows (the
    plane is elided)."""
    if need_rows == 0:
        return 0
    nvu = max(DEFAULT_V_SEG, -(-need_rows // s_seg))
    nvu = -(-nvu // DEFAULT_V_SEG) * DEFAULT_V_SEG
    g = 1 << max((DEFAULT_V_SEG - 1).bit_length(), (nvu - 1).bit_length() - 3)
    nvu = -(-nvu // g) * g
    if max_nv is not None:
        nvu = min(nvu, max_nv)
    return nvu


def _sampled_len(n: int, stride: int = HIST_STRIDE) -> int:
    """Length of ``_hist_sample``'s output for an ``n``-symbol plane (the
    all-zeros histogram of an elided plane's bitmap)."""
    blk = stride * NG
    nb = n // blk
    return nb * NG if nb else n


def _entropy_encode(symbols, hists, maxima, *, s_seg: int, v_seg: int,
                    p: int | None = None):
    """Dense entropy stage: (n, P) uint8 planes, their sampled histograms
    and their symbol maxima → ``(streams, counts, covered hists)``; one
    table per plane, one encode launch for all of them.  ``p``: the
    planes' symbols where ``symbols`` already holds them zero-padded to
    the segment grid (a batch's buffer)."""
    n, width = symbols.shape
    p = width if p is None else p
    hists = _covered_hist(hists, maxima)
    freqs, cums = freq_table_device(
        _table_hists(hists, p, s_seg=s_seg, v_seg=v_seg))
    n_seg, m = _segment_geometry(p, s_seg, v_seg)
    if m != width:
        symbols = torch.nn.functional.pad(symbols, (0, m - width))
    streams, counts = encode_words(
        symbols.reshape(n * n_seg, s_seg, NG), freqs, cums)
    return streams, counts, hists


def _entropy_decode(streams, counts, hists, *, padded, s_seg: int,
                    v_seg: int) -> torch.Tensor:
    """Segment decode → (n, P) uint8 planes (n: the histograms' rows)."""
    p = padded[0] * padded[1] * padded[2]
    freqs, cums = freq_table_device(
        _table_hists(hists, p, s_seg=s_seg, v_seg=v_seg))
    sym = decode_words(streams, counts, freqs, cums, s_seg=s_seg)
    return sym.reshape(hists.shape[0], -1)[:, :p]


def _encode_chunk_sparse(symbols, trows, *, pp: int, s_seg: int, krs,
                         v_b: int, wire_active, wire_nc: int = 3, dense=(),
                         chunk_planes: int | None = None):
    """Sparse phase 2: compact kernel → bitmap + value planes → one
    word-rANS encode launch for all of them.

    ``symbols``: (npv, pp) uint8, the provided planes (wire planes
    ``wire_active`` of the ``wire_nc``: 3 channels, or the 6 byte planes
    of a deep chunk, or the 3·B channels of a batch's B chunks), or a
    sequence of npv (pp,) planes (a batch's, where each chunk's phase 1
    left them); ``trows``: their tile rows, likewise; ``krs``: per
    provided plane, its value capacity in rows (``krs[i] · 128`` symbols,
    whole segments); 0 elides the plane.  ``dense``: provided planes coded
    dense — their value section is the raw plane zero-padded to ``krs[i]``
    rows (the full dense capacity) and their all-ones bitmap is never
    coded.  ``chunk_planes``: wire planes a chunk (default ``wire_nc``: one
    chunk).

    Returns ``(streams, counts, hists)``: hists in the full wire layout
    (2·wire_nc, 256) — bitmap rows, then value rows, with the rows of an
    elided plane synthesized; streams and counts of the coded planes only,
    chunk by chunk: a chunk's bitmap segments first (elided, count 0, for
    dense planes), then each of its coded planes' value segments — so each
    chunk's segments are one slice."""
    planes = list(symbols)
    npv = len(planes)
    dev = planes[0].device
    cp = wire_nc if chunk_planes is None else chunk_planes
    coded = tuple(i for i in range(npv) if krs[i] > 0)
    sp = tuple(c for c in coded if c not in dense)
    nb, mb = _segment_geometry(pp // 8, s_seg, v_b)
    groups = [g for g in ([c for c in coded if wire_active[c] // cp == j]
                          for j in range(wire_nc // cp)) if g]
    # every segment in one buffer, in wire order chunk by chunk: the coded
    # planes' bitmap segments (all zero, so elided, for a dense plane),
    # then their value segments
    sizes = [n for g in groups for n in [mb] * len(g) + [krs[c] * NG for c in g]]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
    parts = iter(torch.split(buf, sizes))
    bm_seg, values = {}, {}
    for g in groups:
        bm_seg.update((c, next(parts)) for c in g)
        values.update((c, next(parts)) for c in g)
    bm_parts = {}
    if sp:
        # the compact kernel reads the sparse planes where phase 1 left
        # them and writes their bitmap and value segments into buf
        compact(symbols, trows, tuple(krs[c] for c in sp), pick=sp,
                out=([bm_seg[c] for c in sp], [values[c] for c in sp]))
        for c in sp:
            bm_parts[c] = bm_seg[c][: pp // 8]
    for c in dense:
        values[c][:pp].copy_(planes[c])
        values[c][pp:].zero_()
        bm_parts[c] = torch.full((pp // 8,), 255, dtype=torch.uint8, device=dev)
        bm_seg[c].zero_()
    # an elided plane's bitmap histogram is all mass at 0 (that of its
    # all-zero bitmap); its value plane has no symbols
    zero_bm_hist = torch.zeros(256, dtype=torch.int64, device=dev)
    zero_bm_hist[0] = _sampled_len(pp // 8)
    zero_v_hist = torch.zeros(256, dtype=torch.int64, device=dev)
    # the covered histograms of every bitmap and coded value plane, in one
    # pass over them
    counted = [bm_parts[c] for c in bm_parts] + [values[c] for c in coded]
    stats = iter(_covered_hist(*plane_stats(counted, HIST_STRIDE))
                 if counted else ())
    bm_hists = dict(zip(bm_parts, stats))
    v_hists = dict(zip(coded, stats))
    pos = {w: i for i, w in enumerate(wire_active)}
    rows = [bm_hists.get(pos.get(w), zero_bm_hist) for w in range(wire_nc)]
    rows += [v_hists.get(pos.get(w), zero_v_hist) for w in range(wire_nc)]
    hists = torch.stack(rows)
    # one table per segment group: each coded plane's bitmap (a dense
    # plane's segments are elided and never read theirs), then its values
    freqs, cums = freq_table_device(torch.cat([
        t for g in groups for t in (
            _table_hists(hists[[wire_active[c] for c in g]], pp // 8,
                         s_seg=s_seg, v_seg=v_b),
            hists[[wire_nc + wire_active[c] for c in g]])]))
    streams, counts = encode_words(
        buf.view(-1, s_seg, NG), freqs, cums,
        planes=[n for g in groups
                for n in [nb] * len(g) + [krs[c] // s_seg for c in g]])
    return streams, counts, hists


def _sparse_entropy_expand(streams, counts, hists, *, p: int, s_seg: int,
                           kcaps, v_b: int, nc: int = 3,
                           chunk_planes: int | None = None) -> torch.Tensor:
    """Sparse decode front half → (nc, p) uint8 symbols (nc: 3 channels,
    or 6 byte planes when deep, or the 3·B channels of B chunks whose
    segments follow one another in ``streams``, ``chunk_planes`` = 3 a
    chunk).  ``hists``: (2·nc, 256), the bitmap rows, then the value
    rows; ``kcaps``: per plane, its value capacity in symbols — 0 elides
    the plane (exact zeros), the full dense capacity marks a dense plane
    (its value symbols are the plane; its bitmap is never read).  One
    word-rANS decode launch covers every segment, one expand launch
    every sparse plane."""
    cp = nc if chunk_planes is None else chunk_planes
    pp = _sparse_pp(p)
    dev = streams.device
    out = torch.empty((nc, p), dtype=torch.uint8, device=dev)
    dense_kcap = _segment_geometry(pp, s_seg)[1]
    nb, mb = _segment_geometry(pp // 8, s_seg, v_b)
    # per chunk: its coded planes' bitmap segments, then their values
    tables, planes, where = [], [], []  # where: (plane, bitmap, values)
    off = 0
    for j in range(nc // cp):
        coded = [c for c in range(j * cp, (j + 1) * cp) if kcaps[c] > 0]
        if not coded:
            continue
        tables += [_table_hists(hists[coded], pp // 8, s_seg=s_seg, v_seg=v_b),
                   hists[[nc + c for c in coded]]]
        planes += [nb] * len(coded) + [kcaps[c] // (s_seg * NG) for c in coded]
        voff = off + len(coded) * mb
        for i, c in enumerate(coded):
            where.append((c, off + i * mb, voff))
            voff += kcaps[c]
        off = voff
    if not where:
        return out.zero_()
    freqs, cums = freq_table_device(torch.cat(tables))
    flat = decode_words(streams, counts, freqs, cums, s_seg=s_seg,
                        planes=planes).view(-1)
    coded = {c for c, _, _ in where}
    for c in range(nc):
        if c not in coded:
            out[c].zero_()
    sp = []
    for c, b, v in where:
        if kcaps[c] >= dense_kcap:
            out[c].copy_(flat[v : v + p])
        else:
            sp.append((c, b, v))
    if sp:
        # the expand kernel reads each sparse plane's bitmap and values
        # out of the decoded segments and writes its row of out
        expand([flat[b : b + pp // 8] for _, b, _ in sp],
               [flat[v : v + kcaps[c]] for c, _, v in sp],
               tuple(kcaps[c] // NG for c, _, _ in sp),
               out=[out[c] for c, _, _ in sp])
    return out


def _bands_sparse_phase15(coeffs, steps8, dzs8, *, padded, pp: int):
    """rdo×sparse phase 1.5: per-band quantize → symbols zero-padded to
    ``pp`` (3, pp) uint8 and their per-tile value rows."""
    p = padded[0] * padded[1] * padded[2]
    symbols = to_symbols(quantize_bands_inter(coeffs, steps8, dzs8))
    symbols = torch.nn.functional.pad(symbols.reshape(3, p), (0, pp - p))
    return symbols, tile_rows(symbols)


def _join(parts: list[torch.Tensor]) -> torch.Tensor:
    """``torch.cat(parts)``, without the copy where the parts already lie
    one after another in one buffer (the chunks of one ``encode_batch``
    or one shard of it)."""
    a = parts[0]
    if len(parts) == 1:
        return a
    if all(x.is_contiguous() and x.dtype == a.dtype and x.device == a.device
           and x.shape[1:] == a.shape[1:]
           and x.untyped_storage().data_ptr() == a.untyped_storage().data_ptr()
           for x in parts) and all(
               y.data_ptr() == x.data_ptr() + x.nbytes
               for x, y in zip(parts, parts[1:])):
        return a.as_strided((sum(x.shape[0] for x in parts),) + a.shape[1:],
                            a.stride(), a.storage_offset())
    return torch.cat(parts)


def _batch_tensor(rgb_batch, device) -> torch.Tensor:
    """A (B, T, H, W, 3) batch, numpy or a tensor, as a uint8 tensor on
    ``device``."""
    x = as_uint8_tensor(rgb_batch, device)
    if x.ndim != 5 or x.shape[-1] != 3:
        raise InvalidBufferSize(5, x.ndim)
    return x


def _shards(rgb_batch, mesh) -> list[torch.Tensor]:
    """A batch as one uint8 tensor a mesh device: given shards (placed
    where the mesh says), or a batch split by ``shard_batch``."""
    if isinstance(rgb_batch, (list, tuple)):
        if len(rgb_batch) != mesh.size:
            raise ValueError(f"{len(rgb_batch)} shards for a mesh of "
                             f"{mesh.size} devices")
        shards = [as_uint8_tensor(x, d) for x, d in zip(rgb_batch, mesh.devices)]
    else:
        if np.ndim(rgb_batch) != 5:
            raise InvalidBufferSize(5, np.ndim(rgb_batch))
        shards = [x.to(torch.uint8) for x in shard_batch(rgb_batch, mesh)]
    for x in shards:
        if x.ndim != 5 or x.shape[-1] != 3:
            raise InvalidBufferSize(5, x.ndim)
    return shards


def _chunks_of(rgb_batch) -> list:
    """The chunks of a batch (or of its shards), one by one."""
    if isinstance(rgb_batch, (list, tuple)):
        return [x[i] for x in rgb_batch for i in range(x.shape[0])]
    if not isinstance(rgb_batch, torch.Tensor):
        rgb_batch = np.asarray(rgb_batch, np.uint8)
    if rgb_batch.ndim != 5 or rgb_batch.shape[-1] != 3:
        raise InvalidBufferSize(5, rgb_batch.ndim)
    return [rgb_batch[i] for i in range(rgb_batch.shape[0])]


def _chunk_to(chunk: "DeviceChunk", dev: torch.device) -> "DeviceChunk":
    if chunk.streams.device == dev:
        return chunk
    return replace(chunk, streams=chunk.streams.to(dev),
                   counts=chunk.counts.to(dev), hists=chunk.hists.to(dev))


def _on_mesh(fn, chunks, mesh, exact: bool) -> torch.Tensor:
    """``fn(shard's chunks, exact)`` on every mesh device (all issued
    before any result is gathered), gathered onto the first."""
    if len(chunks) % mesh.size:
        raise ValueError(f"a batch of {len(chunks)} chunks does not split "
                         f"over {mesh.size} devices")
    bl = len(chunks) // mesh.size
    parts = []
    for s, dev in enumerate(mesh.devices):
        with on_device(dev):
            parts.append(fn([_chunk_to(c, dev)
                             for c in chunks[s * bl : (s + 1) * bl]], exact))
    return gather(parts, mesh.devices[0])


@dataclass
class DeviceChunk:
    """A compressed chunk held in device memory.

    Dense: ``streams`` (n·n_seg, stream_rows(s_seg), 128) int32 padded
    segment word streams of its n planes (3 channels, or 6 byte planes
    when ``deep``); ``counts`` (n·n_seg,) int32 meaningful words per
    segment; ``hists`` (n, 256) int64 stored (sampled) histograms.

    Sparse (``sparse=True``): the segments of the coded planes — their
    bitmap segments, then each one's value segments; ``hists`` (2n, 256),
    the n bitmap planes' then the n value planes'; ``kcaps`` the n value
    capacities in symbols (0: elided plane).

    ``band_steps``: (3, 8) int32 per-channel per-band steps of an
    AnalyticalRDO chunk (None otherwise; ``quant_step`` is then their
    minimum); ``levels``: the decomposition depth."""

    width: int
    height: int
    frames: int
    wavelet_type: WaveletType
    quant_step: int
    s_seg: int
    streams: torch.Tensor
    counts: torch.Tensor
    hists: torch.Tensor
    band_steps: np.ndarray | None = None
    deep: bool = False
    levels: int = 1
    sparse: bool = False
    kcaps: tuple[int, ...] = ()

    @property
    def n_planes(self) -> int:
        n = 6 if self.deep else 3
        return 2 * n if self.sparse else n

    @property
    def n_segments(self) -> int:
        """Segments per plane (meaningless for a sparse chunk, whose
        planes differ in segment count)."""
        return self.streams.shape[0] // self.n_planes

    @property
    def compressed_size(self) -> int:
        """Wire payload size in bytes (fetches only the counts)."""
        return int(self.counts.to(torch.int64).sum().item()) * 2

    @classmethod
    def from_numpy(cls, *, width, height, frames, wavelet_type, quant_step,
                   s_seg, streams, counts, hists, band_steps=None, deep=False,
                   levels=1, sparse=False, kcaps=(), device=None
                   ) -> "DeviceChunk":
        """A chunk from the fields of a JAX ``DeviceChunk`` given as numpy
        arrays; tensors go to ``device``."""
        dev = resolve_device(device)
        return cls(
            int(width), int(height), int(frames), WaveletType(int(wavelet_type)),
            int(quant_step), int(s_seg),
            torch.as_tensor(np.array(streams, np.int32), device=dev),
            torch.as_tensor(np.array(counts, np.int32), device=dev),
            torch.as_tensor(np.array(hists, np.int64), device=dev),
            None if band_steps is None else np.array(band_steps, np.int32),
            bool(deep), int(levels), bool(sparse),
            tuple(int(k) for k in kcaps),
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
            band_steps=(None if self.band_steps is None
                        else np.array(self.band_steps, np.int32)),
            deep=self.deep, levels=self.levels,
            sparse=self.sparse, kcaps=tuple(self.kcaps),
        )


class Alc3Codec:
    """ALC3 chunk codec on one device (CUDA unless ``device`` says
    otherwise): dense or, with ``sparse=True``, with sparse significance
    coding; fixed-step, or AnalyticalRDO per-band steps (``rdo=True``);
    8-bit or, with ``deep`` (the default at q=100), 16-bit symbols;
    ``levels`` 1-4 of decomposition.

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
        self.rdo = bool(rdo)
        self.deep = (self.quality >= 100) if deep is None else bool(deep)
        if self.rdo and self.deep:
            raise ValueError("rdo and deep modes are mutually exclusive")
        self.levels = int(levels)
        if self.rdo and self.levels != 1:
            raise ValueError("rdo supports single-level decomposition only")
        self.sparse = bool(sparse)
        self.device = resolve_device(device)
        # the sparse encoder's caches, keyed by chunk geometry — both are
        # wire-visible, since they decide later chunks' capacities:
        # value capacity rows per (provided planes, wire planes, pp,
        # s_seg), and the channels last found nonzero per (pp, s_seg)
        self._krs_cache: dict = {}
        self._active_cache: dict = {}

    # ── sparse encode ───────────────────────────────────────────

    def _settle_krs(self, rows, wire_active, pp: int, wire_nc: int = 3,
                    chunk_planes: int | None = None):
        """Value capacity rows of the provided planes ``wire_active`` (of
        ``wire_nc`` wire planes, ``chunk_planes`` of them a chunk: all, or
        3 in a batch), given their value rows ``rows``; stores them in the
        capacity cache.

        The JAX package dispatches its phase 2 optimistically with the
        cached capacities and re-dispatches with larger ones where the
        rows overflow; this is the capacity its loop settles on, and the
        cache write it makes: a cached bucket is kept while the rows fit,
        else every plane takes the larger of it and its own bucket.  A
        plane with no rows is elided (0), except each chunk's anchor
        plane (its first wire plane), which keeps the minimum bucket; a
        plane at or above DENSE_ROW_FRAC of its rows is dense (the full
        capacity)."""
        cp = wire_nc if chunk_planes is None else chunk_planes
        max_nv = _segment_geometry(pp, self.s_seg)[0]
        dense_rows = max_nv * self.s_seg

        def bucket(r: int, w: int) -> int:
            if r == 0 and w % cp == 0:
                return DEFAULT_V_SEG * self.s_seg
            if r >= DENSE_ROW_FRAC * (pp // NG):
                return dense_rows
            nv = _bucket_nv(r, self.s_seg, max_nv)
            return dense_rows if nv >= max_nv else nv * self.s_seg

        key = (tuple(wire_active), wire_nc, pp, self.s_seg)
        krs = self._krs_cache.get(key)
        if krs is None:
            krs = tuple(bucket(r, w) for r, w in zip(rows, wire_active))
        for _ in range(8):
            if all(r <= k for r, k in zip(rows, krs)):
                break
            krs = tuple(max(k, bucket(r, w))
                        for r, k, w in zip(rows, krs, wire_active))
        self._krs_cache[key] = krs
        return krs, dense_rows

    def _sparse_phase2(self, symbols, trows, pp: int, rows, wire_active,
                       wire_nc: int = 3, chunk_planes: int | None = None):
        """Capacities from the value ``rows`` (host ints), then the
        compact + entropy stage: ``(streams, counts, hists, kcaps)`` with
        kcaps in the full wire layout."""
        krs, dense_rows = self._settle_krs(rows, wire_active, pp, wire_nc,
                                           chunk_planes)
        nb, _ = _segment_geometry(pp // 8, self.s_seg)
        streams, counts, hists = _encode_chunk_sparse(
            symbols, trows, pp=pp, s_seg=self.s_seg, krs=krs,
            v_b=_pick_v_seg(nb), wire_active=wire_active, wire_nc=wire_nc,
            dense=tuple(i for i, k in enumerate(krs) if k == dense_rows),
            chunk_planes=chunk_planes)
        kcaps = [0] * wire_nc
        for i, w in enumerate(wire_active):
            kcaps[w] = krs[i] * NG
        return streams, counts, hists, tuple(kcaps)

    def _encode_sparse(self, rgb, padded):
        """Fixed-step sparse encode of one chunk on the codec's device.

        Phase 1 transforms only the channels the last chunk of this
        geometry needed (all three at first); one host read of the value
        rows and colour flags then picks the capacities.  Where a channel
        assumed zero is not, phase 1 runs again over the needed channels,
        and the capacities the JAX package's discarded dispatch stores for
        the first set are stored too (a channel's symbols do not depend on
        which others are active, so its first rows give them)."""
        p = int(np.prod(padded))
        pp = _sparse_pp(p)
        akey = (pp, self.s_seg)
        active = self._active_cache.get(akey, (0, 1, 2))

        def phase1(chans):
            sym, trows, flags = encode_sparse_phase1(
                rgb, self.step, self.step, wavelet_type=self.wavelet_type,
                padded=padded, pp=pp, levels=self.levels, active=chans)
            host = torch.cat([trows.sum(-1, dtype=torch.int64),
                              flags.to(torch.int64)]).tolist()
            return sym, trows, host[: len(chans)], host[len(chans):]

        symbols, trows, rows, flags = phase1(active)
        needed = tuple(sorted({0} | {c for c in range(3) if flags[c]}))
        if not set(needed) <= set(active):
            self._settle_krs(rows, active, pp)
            active = needed
            symbols, trows, rows, _ = phase1(active)
        self._active_cache[akey] = needed
        return self._sparse_phase2(symbols, trows, pp, rows, active)

    def _encode_sparse_planes(self, symbols, trows, pp: int):
        """Sparse phase 2 of a deep (6 byte planes) or rdo chunk: every
        plane provided, no zero-channel cache."""
        n = symbols.shape[0]
        rows = trows.sum(-1, dtype=torch.int64).tolist()
        return self._sparse_phase2(symbols, trows, pp, rows, tuple(range(n)),
                                   wire_nc=n)

    # ── encode / decode ─────────────────────────────────────────

    def _rdo_steps(self, s1, s2, p: int):
        """Per-band (steps, dead zones), each (3, 8) int32 numpy, from the
        device moments (one host read)."""
        s12 = torch.stack([s1, s2]).cpu().numpy()
        rdo = AnalyticalRDO.with_quality(self.quality)
        steps = np.empty((3, 8), np.int32)
        dzs = np.empty((3, 8), np.int32)
        for ch in range(3):
            steps[ch], dzs[ch] = rdo.steps_from_moments(
                p // 8, s12[0, ch], s12[1, ch])
        return steps, dzs

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
        padded = padded_dims_levels(w, h, t, self.levels)
        p = int(np.prod(padded))
        pp = _sparse_pp(p)
        step, band_steps, kcaps = self.step, None, ()
        if self.rdo:
            coeffs, s1, s2 = transform_moments_device(
                rgb, wavelet_type=self.wavelet_type, padded=padded)
            band_steps, dzs = self._rdo_steps(s1, s2, p)
            step = int(band_steps.min())
            steps8 = torch.as_tensor(band_steps, device=self.device)
            dzs8 = torch.as_tensor(dzs, device=self.device)
        stage = dict(wavelet_type=self.wavelet_type, padded=padded,
                     levels=self.levels)
        if self.sparse and (self.rdo or self.deep):
            if self.rdo:
                planes, trows = _bands_sparse_phase15(coeffs, steps8, dzs8,
                                                      padded=padded, pp=pp)
                del coeffs
            else:
                planes, trows = encode_deep_sparse_phase1(
                    rgb, self.step, self.step, pp=pp, **stage)
            streams, counts, hists, kcaps = self._encode_sparse_planes(
                planes, trows, pp)
        elif self.sparse:
            streams, counts, hists, kcaps = self._encode_sparse(rgb, padded)
        else:
            if self.rdo:
                planes, hists, maxima = encode_bands_device(
                    coeffs, steps8, dzs8, padded=padded,
                    hist_stride=HIST_STRIDE)
                del coeffs
            else:
                if self.deep:
                    planes, hists, maxima = encode_deep_device(
                        rgb, self.step, self.step, hist_stride=HIST_STRIDE,
                        **stage)
                else:
                    planes, hists, maxima = encode_device(
                        rgb, self.step, self.step, hist_stride=HIST_STRIDE,
                        interleaved=True, **stage)
            v_seg = _pick_v_seg(_segment_geometry(p, self.s_seg)[0])
            streams, counts, hists = _entropy_encode(
                planes, hists, maxima, s_seg=self.s_seg, v_seg=v_seg)
        return DeviceChunk(w, h, t, self.wavelet_type, step, self.s_seg,
                           streams, counts, hists, band_steps=band_steps,
                           deep=self.deep, levels=self.levels,
                           sparse=self.sparse, kcaps=kcaps)

    def decode(self, chunk: DeviceChunk, *, exact: bool = False,
               as_numpy: bool = False):
        """Decode back to (T, H, W, 3) uint8 — a tensor on the chunk's
        device, or a numpy array with ``as_numpy``."""
        w, h, t = chunk.width, chunk.height, chunk.frames
        dev = chunk.streams.device
        padded = padded_dims_levels(w, h, t, chunk.levels)
        p = int(np.prod(padded))
        if chunk.sparse:
            nb, _ = _segment_geometry(_sparse_pp(p) // 8, chunk.s_seg)
            planes = _sparse_entropy_expand(
                chunk.streams, chunk.counts, chunk.hists, p=p,
                s_seg=chunk.s_seg, kcaps=chunk.kcaps, v_b=_pick_v_seg(nb),
                nc=6 if chunk.deep else 3)
        else:
            planes = _entropy_decode(
                chunk.streams, chunk.counts, chunk.hists, padded=padded,
                s_seg=chunk.s_seg, v_seg=_pick_v_seg(chunk.n_segments))
        stage = dict(wavelet_type=chunk.wavelet_type, dims=(w, h, t),
                     padded=padded, exact=exact)
        steps = torch.full((3,), chunk.quant_step, dtype=torch.int32,
                           device=dev)
        if chunk.band_steps is not None:
            steps8 = torch.as_tensor(np.asarray(chunk.band_steps, np.int32),
                                     device=dev)
            rgb = decode_bands_device(planes, steps8, **stage)
        elif chunk.deep:
            rgb = decode_deep_device(planes, steps, levels=chunk.levels,
                                     **stage)
        else:
            # an elided sparse plane (kcap 0) carries no nonzero symbol
            active = (tuple(c for c in range(3) if chunk.kcaps[c] > 0)
                      if chunk.sparse else None)
            rgb = decode_device(planes, steps, levels=chunk.levels,
                                active=active, interleaved=True, **stage)
        return rgb.cpu().numpy() if as_numpy else rgb

    # ── batches and chunk meshes ────────────────────────────────

    def encode_batch(self, rgb_batch, *, mesh=None) -> list[DeviceChunk]:
        """Encode a (B, T, H, W, 3) uint8 batch: numpy (uploaded once), a
        tensor, or with ``mesh`` also the per-device shards of
        :func:`~.parallel.mesh.shard_batch`.

        Dense and sparse fixed-step batches run K1 once a chunk, then one
        word-rANS encode launch (and, where planes are sparse, one compact
        launch) over the whole batch; the containers equal per-chunk
        :meth:`encode`'s (sparse: with the batch's own capacity caches).
        With ``mesh`` (:func:`~.parallel.mesh.chunk_mesh`) each device
        codes its shard and its chunks stay there: dense streams equal the
        unsharded path's; sparse takes the mesh's capacity rule (one bucket
        a channel from the batch maximum, no plane elided, no cache read or
        written) and an uneven B encodes per chunk.  rdo and deep encode
        per chunk."""
        if self.rdo or self.deep:
            return [self.encode(c) for c in _chunks_of(rgb_batch)]
        if mesh is not None:
            if self.sparse:
                return self._encode_batch_sparse_mesh(rgb_batch, mesh)
            out = []
            for dev, x in zip(mesh.devices, _shards(rgb_batch, mesh)):
                with on_device(dev):
                    out += self._encode_batch_dense(x)
            return out
        x = _batch_tensor(rgb_batch, self.device)
        if self.sparse:
            return self._encode_batch_sparse(x)
        return self._encode_batch_dense(x)

    def _encode_batch_dense(self, x) -> list[DeviceChunk]:
        """Dense batch on ``x``'s device: K1 once a chunk into one buffer
        of the B·3 planes, then one encode launch over all of them; chunk
        i owns segment rows [i·3·n_seg, (i+1)·3·n_seg)."""
        b, t, h, w, _ = x.shape
        padded = padded_dims_levels(w, h, t, self.levels)
        p = int(np.prod(padded))
        n_seg, m = _segment_geometry(p, self.s_seg)
        buf = torch.empty((3 * b, m), dtype=torch.uint8, device=x.device)
        hists, maxima = [], []
        for i in range(b):
            planes, hist, mx = encode_device(
                x[i], self.step, self.step, wavelet_type=self.wavelet_type,
                padded=padded, levels=self.levels, hist_stride=HIST_STRIDE,
                interleaved=True)
            buf[3 * i : 3 * i + 3, :p].copy_(planes)
            hists.append(hist)
            maxima.append(mx)
            del planes
        buf[:, p:].zero_()
        streams, counts, hists = _entropy_encode(
            buf, torch.cat(hists), torch.cat(maxima), s_seg=self.s_seg,
            v_seg=_pick_v_seg(n_seg), p=p)
        rows = 3 * n_seg
        return [DeviceChunk(w, h, t, self.wavelet_type, self.step, self.s_seg,
                            streams[i * rows : (i + 1) * rows],
                            counts[i * rows : (i + 1) * rows],
                            hists[3 * i : 3 * i + 3], levels=self.levels)
                for i in range(b)]

    def _phase1_chunks(self, x, padded, pp: int, active=(0, 1, 2)):
        """Sparse phase 1 of each chunk of ``x`` over the ``active``
        channels: ``(planes, tile rows, value-row and flag tensors)``, the
        planes and tile rows one per (chunk, active channel), left where
        each chunk's phase 1 put them."""
        outs = [encode_sparse_phase1(
            x[i], self.step, self.step, wavelet_type=self.wavelet_type,
            padded=padded, pp=pp, levels=self.levels, active=active)
            for i in range(x.shape[0])]
        return ([pl for o in outs for pl in o[0]],
                [r for o in outs for r in o[1]],
                torch.stack([o[1].sum(-1, dtype=torch.int64) for o in outs]),
                torch.stack([o[2] for o in outs]))

    def _encode_batch_sparse(self, x) -> list[DeviceChunk]:
        """Sparse batch: phase 1 a chunk over the batch's union active set
        (cached per (B, pp, s_seg), apart from the single-chunk key), one
        host read of the value rows and colour flags, then one compact and
        one encode launch over the B·na planes.  A wrong guess runs phase
        1 again over the needed channels, and the capacities the JAX
        package's discarded dispatch caches for the first set are cached
        too (as in :meth:`_encode_sparse`)."""
        b, t, h, w, _ = x.shape
        padded = padded_dims_levels(w, h, t, self.levels)
        pp = _sparse_pp(int(np.prod(padded)))
        akey = (b, pp, self.s_seg)
        active = self._active_cache.get(akey, (0, 1, 2))

        def phase1(chans):
            planes, trows, rows, flags = self._phase1_chunks(x, padded, pp,
                                                             chans)
            host = torch.cat([rows.reshape(-1),
                              flags.reshape(-1).to(torch.int64)]).tolist()
            wire = tuple(3 * i + c for i in range(b) for c in chans)
            return planes, trows, host[: len(wire)], host[len(wire):], wire

        planes, trows, rows, flags, wire = phase1(active)
        needed = tuple(sorted({0} | {c for c in range(3)
                                     if any(flags[3 * i + c] for i in range(b))}))
        if not set(needed) <= set(active):
            self._settle_krs(rows, wire, pp, 3 * b, 3)
            del planes, trows
            active = needed
            planes, trows, rows, _, wire = phase1(active)
        self._active_cache[akey] = needed
        streams, counts, hists, kcaps = self._sparse_phase2(
            planes, trows, pp, rows, wire, 3 * b, 3)
        return self._split_sparse(streams, counts, hists, kcaps, (w, h, t), pp)

    def _split_sparse(self, streams, counts, hists, kcaps, dims, pp: int
                      ) -> list[DeviceChunk]:
        """B self-contained chunks from one batch's phase 2, whose
        segments run chunk by chunk (its coded planes' bitmap segments,
        then their value segments) and whose hists are the (2·3B, 256)
        wire layout."""
        b = len(kcaps) // 3
        nb, _ = _segment_geometry(pp // 8, self.s_seg)
        seg = self.s_seg * NG
        chunks, off = [], 0
        for i in range(b):
            kc = tuple(kcaps[3 * i : 3 * i + 3])
            n = sum(1 for k in kc if k) * nb + sum(k // seg for k in kc)
            chunks.append(DeviceChunk(
                *dims, self.wavelet_type, self.step, self.s_seg,
                streams[off : off + n], counts[off : off + n],
                torch.cat([hists[3 * i : 3 * i + 3],
                           hists[3 * b + 3 * i : 3 * b + 3 * i + 3]]),
                levels=self.levels, sparse=True, kcaps=kc))
            off += n
        return chunks

    def _encode_batch_sparse_mesh(self, rgb_batch, mesh) -> list[DeviceChunk]:
        """Sparse batch over a mesh: phase 1 on every shard, one host read
        of the B·3 row counts, then phase 2 on every shard with ONE
        capacity a channel, the batch maximum's bucket (no plane elided;
        DENSE_ROW_FRAC batch-wide; the caches neither read nor written),
        so every chunk carries the same kcaps.  An uneven B encodes per
        chunk."""
        if not isinstance(rgb_batch, (list, tuple)):
            b = len(rgb_batch)
            if b % mesh.size:
                return [self.encode(c) for c in _chunks_of(rgb_batch)]
        shards = _shards(rgb_batch, mesh)
        bl, t, h, w, _ = shards[0].shape
        padded = padded_dims_levels(w, h, t, self.levels)
        pp = _sparse_pp(int(np.prod(padded)))
        p1 = []
        for dev, x in zip(mesh.devices, shards):
            with on_device(dev):
                p1.append(self._phase1_chunks(x, padded, pp))
        rows = gather([r for _, _, r, _ in p1], mesh.devices[0]).tolist()
        max_nv = _segment_geometry(pp, self.s_seg)[0]

        def ch_bucket(r: int) -> int:
            if r >= DENSE_ROW_FRAC * (pp // NG):
                return max_nv
            nv = max(_bucket_nv(r, self.s_seg, max_nv), DEFAULT_V_SEG)
            return max_nv if nv >= max_nv else nv

        nv3 = tuple(ch_bucket(max(r[c] for r in rows)) for c in range(3))
        krs3 = tuple(nv * self.s_seg for nv in nv3)
        dense3 = tuple(c for c in range(3) if nv3[c] == max_nv)
        nb, _ = _segment_geometry(pp // 8, self.s_seg)
        chunks = []
        for dev, (planes, trows, _, _) in zip(mesh.devices, p1):
            with on_device(dev):
                streams, counts, hists = _encode_chunk_sparse(
                    planes, trows, pp=pp, s_seg=self.s_seg, krs=krs3 * bl,
                    v_b=_pick_v_seg(nb), wire_active=tuple(range(3 * bl)),
                    wire_nc=3 * bl, chunk_planes=3,
                    dense=tuple(3 * j + c for j in range(bl) for c in dense3))
            chunks += self._split_sparse(
                streams, counts, hists, tuple(k * NG for k in krs3) * bl,
                (w, h, t), pp)
        return chunks

    def decode_batch(self, chunks: list[DeviceChunk], *, exact: bool = False,
                     mesh=None) -> torch.Tensor:
        """Decode B chunks → (B, T, H, W, 3) uint8 on the first chunk's
        device (with ``mesh``: the mesh's first device).

        Fixed-step chunks of one geometry decode in one word-rANS decode
        launch (sparse: and one expand launch) and K4 once a chunk; with
        ``mesh`` each device decodes its shard (sparse: where every chunk
        has the same kcaps and none is elided, as the mesh encoder makes
        them).  rdo, deep or mixed chunks decode per chunk."""
        c0 = chunks[0]
        dev = mesh.devices[0] if mesh is not None else c0.streams.device

        def geom(c):
            return (c.width, c.height, c.frames, c.s_seg, c.levels,
                    c.wavelet_type)

        def plain_sparse(c):
            return (c.sparse and not c.deep and c.band_steps is None
                    and geom(c) == geom(c0))

        if mesh is not None and len(chunks) % mesh.size == 0 and all(
                plain_sparse(c) and c.kcaps == c0.kcaps
                and all(k > 0 for k in c.kcaps) for c in chunks):
            return _on_mesh(self._decode_batch_sparse, chunks, mesh, exact)
        if mesh is None and all(plain_sparse(c) for c in chunks):
            return self._decode_batch_sparse(chunks, exact)
        if any(c.band_steps is not None or c.deep or c.sparse for c in chunks):
            return torch.stack([self.decode(c, exact=exact).to(dev)
                                for c in chunks])
        if any(geom(c) != geom(c0) for c in chunks):
            raise ValueError("the dense chunks of a batch must share their "
                             "geometry, segment length and levels")
        if mesh is None:
            return self._decode_batch_dense(chunks, exact)
        return _on_mesh(self._decode_batch_dense, chunks, mesh, exact)

    def _decode_batch_dense(self, chunks, exact: bool) -> torch.Tensor:
        """One decode launch over the B·3 planes, then K4 once a chunk."""
        c0 = chunks[0]
        dev = c0.streams.device
        chunks = [_chunk_to(c, dev) for c in chunks]
        w, h, t = c0.width, c0.height, c0.frames
        padded = padded_dims_levels(w, h, t, c0.levels)
        planes = _entropy_decode(
            _join([c.streams for c in chunks]), _join([c.counts for c in chunks]),
            torch.cat([c.hists for c in chunks]), padded=padded,
            s_seg=c0.s_seg, v_seg=_pick_v_seg(c0.n_segments))
        return self._inverse_chunks(chunks, planes, padded, exact, None)

    def _decode_batch_sparse(self, chunks, exact: bool) -> torch.Tensor:
        """One decode and one expand launch over the B·3 planes, then K4
        once a chunk; the shared active set goes to the inverse only where
        every chunk has the same one."""
        c0 = chunks[0]
        dev = c0.streams.device
        chunks = [_chunk_to(c, dev) for c in chunks]
        b = len(chunks)
        padded = padded_dims_levels(c0.width, c0.height, c0.frames, c0.levels)
        p = int(np.prod(padded))
        nb, _ = _segment_geometry(_sparse_pp(p) // 8, c0.s_seg)
        planes = _sparse_entropy_expand(
            _join([c.streams for c in chunks]), _join([c.counts for c in chunks]),
            torch.cat([c.hists[:3] for c in chunks]
                      + [c.hists[3:] for c in chunks]),
            p=p, s_seg=c0.s_seg, kcaps=tuple(k for c in chunks for k in c.kcaps),
            v_b=_pick_v_seg(nb), nc=3 * b, chunk_planes=3)
        acts = {tuple(i for i in range(3) if c.kcaps[i] > 0) for c in chunks}
        active = acts.pop() if len(acts) == 1 else None
        return self._inverse_chunks(chunks, planes, padded, exact, active)

    @staticmethod
    def _inverse_chunks(chunks, planes, padded, exact: bool, active):
        """K4 (and the inverse colour) a chunk, from the batch's (3B, P)
        decoded planes, into one (B, T, H, W, 3) tensor (on the fused
        colour route K4 writes each chunk's frames there itself)."""
        c0 = chunks[0]
        dev = planes.device
        w, h, t = c0.width, c0.height, c0.frames
        out = torch.empty((len(chunks), t, h, w, 3), dtype=torch.uint8,
                          device=dev)
        for i, c in enumerate(chunks):
            steps = torch.full((3,), c.quant_step, dtype=torch.int32,
                               device=dev)
            decode_device(
                planes[3 * i : 3 * i + 3], steps,
                wavelet_type=c0.wavelet_type, dims=(w, h, t), padded=padded,
                exact=exact, levels=c0.levels, active=active, interleaved=True,
                out=out[i])
        return out

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
        p = int(np.prod(padded_dims_levels(c0.width, c0.height, c0.frames,
                                           c0.levels)))
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
            flags = _FLAG_RDO if ck.band_steps is not None else 0
            flags |= _FLAG_DEEP if ck.deep else 0
            flags |= (ck.levels - 1) << 2  # bits 2-3: decomposition depth
            flags |= _FLAG_SPARSE if ck.sparse else 0
            buf.append(flags)
            # per plane: (segments, num_symbols).  Sparse: the bitmap
            # planes of pp/8 symbols, then the value planes of kcap
            # symbols; an elided plane (kcap 0) has no segments in either.
            if ck.sparse:
                pp = _sparse_pp(p)
                nb, _ = _segment_geometry(pp // 8, ck.s_seg)
                plane_geom = ([(nb, pp // 8) if k > 0 else (0, 0)
                               for k in ck.kcaps]
                              + [(k // (ck.s_seg * NG), k) for k in ck.kcaps])
            else:
                plane_geom = [(ck.n_segments, p)] * ck.n_planes
            row0 = 0
            for ch, (n_seg, nsym) in enumerate(plane_geom):
                ch_counts = counts[row0 : row0 + n_seg]
                buf += ChannelHeader(
                    compressed_len=int(ch_counts.sum()) * 2,
                    quant_step=ck.quant_step,
                    quant_dead_zone=ck.quant_step,
                    num_symbols=int(nsym),
                    histogram=hists[ch],
                ).to_bytes()
                buf += ch_counts.astype("<u4").tobytes()
                # the band steps are per channel: they ride the first 3
                # plane sections (sparse value planes carry none)
                if ck.band_steps is not None and ch < 3:
                    buf += np.asarray(ck.band_steps[ch], "<i4").tobytes()
                for s in range(n_seg):
                    words = streams[row0 + s].reshape(-1)[: ch_counts[s]]
                    payload += words.astype("<u2").tobytes()
                row0 += n_seg
        return bytes(buf) + bytes(payload)

    @classmethod
    def from_bytes(cls, data: bytes, *, device=None
                   ) -> tuple["Alc3Codec", list[DeviceChunk]]:
        """Parse an ALC3 container and stage its chunks on ``device``.

        Returns ``(codec, chunks)``; the codec carries the container's
        quality (recovered from the stored step — best effort for rdo
        chunks, whose stored step is the smallest band step), wavelet and
        modes.  Raises :class:`InvalidBitstream` for malformed data."""
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

        def read_steps(off: int, steps: np.ndarray, ch: int) -> int:
            if off + 32 > len(data):
                raise InvalidBitstream("truncated ALC3 header section")
            steps[ch] = np.frombuffer(data, "<i4", 8, off)
            if (steps[ch] < 1).any():
                raise InvalidBitstream("non-positive RDO band step")
            return off + 32

        off = 30
        metas = []  # per chunk: (step, hists, counts per plane, DeviceChunk
        #             keyword fields)
        seg = s_seg * NG
        for _ in range(n_chunks):
            if off + 1 > len(data):
                raise InvalidBitstream("truncated ALC3 chunk flags")
            flags = data[off]
            off += 1
            deep = bool(flags & _FLAG_DEEP)
            sparse = bool(flags & _FLAG_SPARSE)
            levels = ((flags >> 2) & 3) + 1
            p = int(np.prod(padded_dims_levels(w, h, f, levels)))
            nbm = 6 if deep else 3  # byte planes (bitmap planes if sparse)
            n_planes = 2 * nbm if sparse else nbm
            band_steps = (np.zeros((3, 8), np.int32) if flags & _FLAG_RDO
                          else None)
            if band_steps is not None and deep:
                raise InvalidBitstream("rdo and deep flags are exclusive")
            hists = np.zeros((n_planes, 256), np.uint32)
            counts_list, kcaps, bm_elided = [], [], []
            step = 1
            for ch in range(n_planes):
                if off + 1040 > len(data):
                    raise InvalidBitstream("truncated ALC3 header section")
                hdr = ChannelHeader.from_bytes(data[off : off + 1040])
                off += 1040
                hists[ch] = hdr.histogram
                step = hdr.quant_step
                has_steps = band_steps is not None and ch < 3
                if sparse and hdr.num_symbols == 0:
                    # an elided plane: no segments; its bitmap and value
                    # sections are elided together.  The band steps still
                    # ride an elided bitmap section.
                    if ch >= nbm and not bm_elided[ch - nbm]:
                        raise InvalidBitstream(
                            "sparse value capacity 0 for a coded bitmap")
                    if hdr.compressed_len:
                        raise InvalidBitstream(
                            "elided plane with nonzero payload")
                    if ch >= nbm:
                        kcaps.append(0)
                    else:
                        bm_elided.append(True)
                    counts_list.append(np.zeros((0,), np.int64))
                    if has_steps:
                        off = read_steps(off, band_steps, ch)
                    continue
                if sparse and ch >= nbm:
                    # a value plane's capacity comes from its own header
                    plane_sym = hdr.num_symbols
                    if plane_sym % seg:
                        raise InvalidBitstream(
                            "sparse value capacity not segment-aligned")
                    if (plane_sym // seg) % DEFAULT_V_SEG:
                        raise InvalidBitstream(
                            "sparse value capacity not V-aligned")
                    if plane_sym > _segment_geometry(_sparse_pp(p), s_seg)[1]:
                        raise InvalidBitstream(
                            "sparse value capacity exceeds the plane size")
                    if bm_elided[ch - nbm]:
                        raise InvalidBitstream(
                            "coded value plane for an elided bitmap")
                    kcaps.append(plane_sym)
                elif sparse:
                    bm_elided.append(False)
                    plane_sym = _sparse_pp(p) // 8
                    if hdr.num_symbols != plane_sym:
                        raise InvalidBitstream(
                            f"bitmap num_symbols {hdr.num_symbols} != "
                            f"{plane_sym}")
                else:
                    plane_sym = p
                    if hdr.num_symbols != p:
                        raise InvalidBitstream(
                            f"num_symbols {hdr.num_symbols} != padded pixels {p}")
                ns = _segment_geometry(plane_sym, s_seg)[0]
                if not sparse and ns != n_seg:
                    raise InvalidBitstream(
                        f"{n_seg} segments cannot cover {p} symbols")
                if off + 4 * ns + (32 if has_steps else 0) > len(data):
                    raise InvalidBitstream("truncated ALC3 header section")
                ch_counts = np.frombuffer(data, "<u4", ns, off).astype(np.int64)
                off += 4 * ns
                if has_steps:
                    off = read_steps(off, band_steps, ch)
                if int(ch_counts.sum()) * 2 != hdr.compressed_len:
                    raise InvalidBitstream("segment counts disagree with header")
                counts_list.append(ch_counts)
            metas.append((step, hists, counts_list, dict(
                band_steps=band_steps, deep=deep, levels=levels,
                sparse=sparse, kcaps=tuple(kcaps))))

        chunks = []
        # every coded segment carries at least the 2·NG state-flush words
        # and at most s_seg steps' refills plus the flush
        segment_cap = (s_seg + 2) * NG
        for step, hists, counts_list, fields in metas:
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
                **fields))
        # recover quality from the step map step = max(64 - q*63/100, 1)
        step0 = metas[0][0] if metas else 1
        quality = next(
            (q for q in range(100, -1, -1) if quality_to_step(q) == step0), 90)
        f0 = metas[0][3] if metas else {}
        codec = cls(quality=quality, wavelet=wavelet_type, s_seg=int(s_seg),
                    rdo=f0.get("band_steps") is not None,
                    deep=f0.get("deep", False), levels=f0.get("levels", 1),
                    sparse=f0.get("sparse", False), device=dev)
        return codec, chunks
