"""Plain PyTorch reference of the ALC3 codec, for judging a run.

A frozen copy of the port's plain (CPU) arithmetic, written out here so
that the benchmark imports nothing of the program under test:

* the forward transform (YCoCg-R, edge pad, integer lifting, dead-zone
  quantize, zigzag) that gives the symbols a chunk's wire has to carry;
* an independent reader of a chunk's wire (frequency tables from its
  stored histograms, the segment word-rANS decode, the sparse bitmap
  expand), which recovers the symbols the program actually coded;
* the inverse (un-zigzag, dequantize, inverse lifting, crop, int16
  truncation, inverse YCoCg-R) that gives the frames a decoder must
  return for those symbols.

Wire constants and rules are ALC3 v7's (NG = 128 lanes, PROB_BITS = 11,
WORD_L = 2^16, HIST_STRIDE = 16, TILE_ROWS = 8, 512-row blocks padded to
16-block slots, segment counts rounded to 8).  Lossy 8-bit chunks take
the fused form of the transform (int16 stored between the spatial and
the temporal pass), deep 16-bit chunks the int32 form; both follow the
JAX package's choice for the shapes the benchmark runs (:func:`fused`).

Every function works on any device.  Large volumes are processed one
channel at a time so that a 64x1080x1920 chunk fits beside the program's
retained outputs.
"""

from __future__ import annotations

import torch

NG = 128
PROB_BITS = 11
PROB_SCALE = 1 << PROB_BITS
WORD_L = 1 << 16
DEFAULT_V_SEG = 8
HIST_STRIDE = 16
TILE_ROWS = 8
BLOCK_ROWS = 512
DEFAULT_V_BLK = 16
_U32 = 0xFFFFFFFF
_MASK = PROB_SCALE - 1
_TILE = TILE_ROWS * NG
# the JAX package's Pallas tile and frame budgets (which shapes it fuses)
_TILE_BYTES = 6 * 1024 * 1024
_FRAME_BYTES = 9 * 1024 * 1024

#: (coefficient ×2^12, predict) lifting steps of each filter
LIFTING_STEPS = {
    "cdf53": ((-4096, True), (1024, False)),
    "cdf97": ((-6497, True), (-217, False), (3616, True), (1817, False)),
    "haar": ((-4096, True), (2048, False)),
}


def quality_to_step(quality: int) -> int:
    q = min(int(quality), 100)
    return max(64 - (q * 63) // 100, 1)


def padded_dims(w: int, h: int, f: int) -> tuple[int, int, int]:
    """(pW, pH, pT): width and height padded to even, frames to even (a
    single frame to two)."""
    return w + (w & 1), h + (h & 1), 2 if f == 1 else f + (f & 1)


def _pick_tile(n: int, cap: int) -> int:
    if n <= cap:
        return n
    b = 0
    for d in range(8, min(n, cap) + 1, 8):
        if n % d == 0:
            b = d
    return b


def fused(padded) -> bool:
    """Whether ALC3 lifts a (pW, pH, pT) volume with the fused, int16
    stored transform (else int32 throughout)."""
    w, h, t = padded
    if t % 2 or h % 2 or w % 2:
        return False
    if _pick_tile(h, max(1, _TILE_BYTES // (t * w * 4))) < 1:
        return False
    if h * w * 2 <= _FRAME_BYTES:
        return True
    return (_pick_tile(h, max(1, _TILE_BYTES // (w * 4))) >= 8
            and _pick_tile(w, max(1, _TILE_BYTES // (h * 4))) >= 128)


# ── colour ──────────────────────────────────────────────────────


def rgb_to_ycocg_r(rgb: torch.Tensor):
    x = rgb.to(torch.int16)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    co = r - b
    t = b + (co >> 1)
    cg = g - t
    y = t + (cg >> 1)
    return y, co, cg


def ycocg_r_to_rgb(y, co, cg) -> torch.Tensor:
    y, co, cg = (v.to(torch.int16) for v in (y, co, cg))
    t = y - (cg >> 1)
    g = cg + t
    b = t - (co >> 1)
    r = co + b
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def _edge_pad(x: torch.Tensor, padded) -> torch.Tensor:
    """(T, H, W) → (pT, pH, pW) by edge replication."""
    pw, ph, pf = padded
    t, h, w = x.shape
    dev = x.device
    if pf != t:
        x = x.index_select(0, torch.arange(pf, device=dev).clamp(max=t - 1))
    if ph != h:
        x = x.index_select(1, torch.arange(ph, device=dev).clamp(max=h - 1))
    if pw != w:
        x = x.index_select(2, torch.arange(pw, device=dev).clamp(max=w - 1))
    return x.contiguous()


# ── lifting ─────────────────────────────────────────────────────


def _delta(avg: torch.Tensor, coeff: int) -> torch.Tensor:
    """Exact int32 ``(avg·coeff + 4096) >> 13``."""
    shifts = {-4096: (1, 1, -1), 4096: (1, 1, 1), 2048: (2, 2, 1),
              -2048: (2, 2, -1), 1024: (4, 3, 1), -1024: (4, 3, -1)}
    if coeff in shifts:
        add, sh, sign = shifts[coeff]
        return ((avg + add) if sign > 0 else (add - avg)) >> sh
    hi = avg >> 13
    lo = avg & 8191
    return coeff * hi + ((coeff * lo + 4096) >> 13)


def _lift_step(x, coeff: int, predict: bool, axis: int, undo: bool):
    n = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = n
    idx = torch.arange(n, device=x.device).view(shape)
    nl = torch.roll(x, 1, axis)
    nr = torch.roll(x, -1, axis)
    if predict:
        tgt = (idx & 1) == 1
        nbr = nl + torch.where(idx == n - 1, nl, nr)
    else:
        tgt = (idx & 1) == 0
        nbr = torch.where(idx == 0, nr, nl) + nr
    d = _delta(nbr, coeff)
    return torch.where(tgt, x - d if undo else x + d, x)


def lift_steps(wavelet: str, *, inverse=False, exact=False):
    base = LIFTING_STEPS[wavelet]
    if not inverse:
        return tuple((c, p, False) for c, p in base)
    if exact:
        return tuple((c, p, True) for c, p in reversed(base))
    return tuple((-c, p, False) for c, p in reversed(base))


def lift_axis(x: torch.Tensor, steps, axis: int) -> torch.Tensor:
    axis %= x.ndim
    for coeff, predict, undo in steps:
        x = _lift_step(x, coeff, predict, axis, undo)
    return x


def _store(x: torch.Tensor, dtype) -> torch.Tensor:
    """A store of int32 values at ``dtype`` (wrapping), read back as int32."""
    return x.to(dtype).to(torch.int32)


# ── quantization ────────────────────────────────────────────────


def quantize(v: torch.Tensor, step: int, dead_zone: int) -> torch.Tensor:
    av = v.abs()
    q = torch.div(av - (dead_zone >> 1), step, rounding_mode="floor")
    return torch.where(av < dead_zone, 0, torch.sign(v) * q).to(torch.int32)


def zigzag(q: torch.Tensor, mask: int) -> torch.Tensor:
    return torch.where(q > 0, 2 * q - 1, -2 * q) & mask


def unzigzag(s: torch.Tensor) -> torch.Tensor:
    s = s.to(torch.int32)
    return torch.where(s % 2 == 1, (s + 1) // 2, -(s // 2))


# ── the transform ───────────────────────────────────────────────


class Spec:
    """What a configuration asks of the codec: geometry and mode.

    ``store``: the dtype of the lossy transform's store between its
    spatial and temporal passes (int16 is the codec's; the control
    lowers it)."""

    def __init__(self, *, frames, height, width, quality, wavelet,
                 deep=None, exact=False, store=torch.int16):
        self.dims = (int(width), int(height), int(frames))
        self.padded = padded_dims(*self.dims)
        self.wavelet = wavelet
        self.step = quality_to_step(quality)
        self.deep = int(quality) >= 100 if deep is None else bool(deep)
        self.exact = bool(exact)
        self.store = store
        pw, ph, pf = self.padded
        self.p = pw * ph * pf
        if not self.deep and (not fused(self.padded) or ph * pw * 2 > _FRAME_BYTES):
            raise ValueError("the reference's lossy path is the fused one, on frames "
                             "whose spatial pass is not split")

    @property
    def n_planes(self) -> int:
        return 6 if self.deep else 3


def _channels(rgb: torch.Tensor, spec: Spec):
    """The three padded colour planes, one at a time, int32."""
    for ch in rgb_to_ycocg_r(rgb):
        yield _edge_pad(ch, spec.padded).to(torch.int32)


def forward_symbols(rgb: torch.Tensor, spec: Spec) -> torch.Tensor:
    """uint8 (T, H, W, 3) → the (n_planes, P) uint8 symbol planes a chunk
    codes: 3 channels, or 6 lo/hi byte planes of 16-bit symbols (deep)."""
    steps = lift_steps(spec.wavelet)
    out = torch.empty((spec.n_planes, spec.p), dtype=torch.uint8,
                      device=rgb.device)
    for c, x in enumerate(_channels(rgb, spec)):
        x = lift_axis(x, steps, -1)
        if spec.deep:
            x = lift_axis(lift_axis(x, steps, -2), steps, -3)
            s = zigzag(quantize(x, spec.step, spec.step), 0xFFFF).reshape(-1)
            out[2 * c] = (s & 255).to(torch.uint8)
            out[2 * c + 1] = (s >> 8).to(torch.uint8)
        else:
            x = lift_axis(_store(lift_axis(x, steps, -2), spec.store), steps, -3)
            out[c] = zigzag(quantize(x, spec.step, spec.step),
                            0xFF).to(torch.uint8).reshape(-1)
        del x
    return out


def inverse_rgb(symbols: torch.Tensor, spec: Spec) -> torch.Tensor:
    """(n_planes, P) uint8 symbols → the uint8 (T, H, W, 3) frames."""
    w, h, t = spec.dims
    pw, ph, pf = spec.padded
    steps = lift_steps(spec.wavelet, inverse=True, exact=spec.exact)
    chans = []
    for c in range(3):
        if spec.deep:
            s = symbols[2 * c].to(torch.int32) | (symbols[2 * c + 1].to(torch.int32) << 8)
        else:
            s = symbols[c]
        x = (unzigzag(s) * spec.step).reshape(pf, ph, pw)
        if spec.deep:
            x = lift_axis(lift_axis(lift_axis(x, steps, -3), steps, -2), steps, -1)
        else:
            x = lift_axis(_store(lift_axis(x, steps, -3), spec.store), steps, -2)
            x = lift_axis(x, steps, -1)
        chans.append(x[:t, :h, :w].to(torch.int16))
        del x
    return ycocg_r_to_rgb(*chans)


# ── the wire ────────────────────────────────────────────────────


def segment_geometry(n: int, s_seg: int, v_seg: int = DEFAULT_V_SEG):
    """(segments, padded symbols) of an n-symbol plane."""
    seg = s_seg * NG
    n_seg = -(-n // seg)
    n_seg += (-n_seg) % v_seg
    return n_seg, n_seg * seg


def pick_v_seg(n_seg: int) -> int:
    v = DEFAULT_V_SEG
    while n_seg % v:
        v //= 2
    return v


def sparse_pp(p: int) -> int:
    blk = BLOCK_ROWS * NG * DEFAULT_V_BLK
    return -(-p // blk) * blk


def table_hists(hists, nsym: int, *, s_seg: int, v_seg: int):
    """Table histograms: the segment grid's padding zeros add mass to
    bin 0, scaled like the sampled histograms."""
    _, m = segment_geometry(nsym, s_seg, v_seg)
    if m == nsym:
        return hists
    out = hists.clone()
    out[..., 0] += -(-(m - nsym) // HIST_STRIDE)
    return out


def _first_argmax(x):
    idx = torch.arange(x.shape[-1], device=x.device)
    hit = x == x.max(dim=-1, keepdim=True).values
    return torch.where(hit, idx, x.shape[-1]).min(dim=-1).values


def freq_tables(hist: torch.Tensor):
    """(n, 256) histograms → (freqs, cums) int64, wire v7 normalisation."""
    h = hist.reshape(-1, 256).to(torch.int64)
    rows = torch.arange(h.shape[0], device=h.device)
    total = h.sum(dim=-1, keepdim=True)
    freqs = torch.where(h > 0, ((h * PROB_SCALE) // total.clamp(min=1)).clamp(min=1), 0)
    excess = freqs.sum(dim=-1) - PROB_SCALE
    while True:
        imax = _first_argmax(freqs)
        take = torch.minimum(excess, freqs[rows, imax] - 1)
        live = (excess > 0) & (take > 0)
        if not bool(live.any()):
            break
        take = torch.where(live, take, 0)
        freqs[rows, imax] -= take
        excess -= take
    freqs[rows, _first_argmax(freqs)] += PROB_SCALE - freqs.sum(dim=-1)
    cums = torch.cumsum(freqs, dim=-1) - freqs
    uniform = total == 0
    step = PROB_SCALE // 256
    freqs = torch.where(uniform, step, freqs)
    cums = torch.where(uniform, torch.arange(256, device=h.device) * step, cums)
    return freqs, cums


def _slot_lut(freqs, cums) -> torch.Tensor:
    """(n_tables, PROB_SCALE) int64: symbol, f-1 and slot-cum of each slot."""
    slots = torch.arange(PROB_SCALE, device=cums.device).expand(
        cums.shape[0], PROB_SCALE).contiguous()
    sym = torch.searchsorted(cums.contiguous(), slots, right=True) - 1
    return (sym | ((freqs.gather(1, sym) - 1) << 8)
            | ((slots - cums.gather(1, sym)) << (8 + PROB_BITS)))


def decode_segments(streams, counts, freqs, cums, planes, *, s_seg: int):
    """Word-rANS decode of every segment: ``streams`` (n, rows, 128) u16
    words held in int32, ``counts`` (n,), one table per group of
    ``planes[i]`` consecutive segments → (n, s_seg, 128) uint8."""
    n, w_rows, ng = streams.shape
    dev = streams.device
    tbl = torch.repeat_interleave(torch.arange(len(planes), device=dev),
                                  torch.tensor(planes, device=dev))
    w_words = w_rows * ng
    lut = _slot_lut(freqs, cums)[tbl]
    flat = streams.reshape(n, w_words)
    cnt = counts.to(torch.int64).reshape(n, 1)
    lanes = torch.arange(ng, device=dev)

    def word_at(i):
        ok = (i >= 0) & (i < w_words)
        return torch.where(ok, flat.gather(1, i.clamp(0, w_words - 1)).to(torch.int64)
                           & 0xFFFF, 0)

    cur = (cnt - 2 * NG).clamp(min=0)
    x = ((word_at(cur + lanes) << 16) | word_at(cur + NG + lanes)) & _U32
    out = torch.empty((n, s_seg, ng), dtype=torch.uint8, device=dev)
    for j in range(s_seg):
        e = lut.gather(1, x & _MASK)
        out[:, j] = (e & 255).to(torch.uint8)
        f = ((e >> 8) & _MASK) + 1
        x = (f * (x >> PROB_BITS) + ((e >> (8 + PROB_BITS)) & _MASK)) & _U32
        need = x < WORD_L
        r = need.to(torch.int64)
        k = r.sum(1, keepdim=True)
        w = word_at((cur - k).clamp(min=0) + torch.cumsum(r, 1) - r)
        x = torch.where(need, ((x << 16) | w) & _U32, x)
        cur = cur - k
    out[cnt[:, 0] == 0] = 0
    return out


def _popcount8(x):
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def expand_plane(bitmap: torch.Tensor, values: torch.Tensor, p: int):
    """One sparse plane: its (pp/8,) bitmap and its value symbols → its
    first ``p`` symbols.  Bit j of byte (tile, l) marks symbol tile·1024 +
    j·128 + l nonzero; each tile's nonzeros follow one another in pixel
    order, padded to whole 128-symbol rows."""
    dev = bitmap.device
    tiles = bitmap.numel() // NG
    shifts = torch.arange(TILE_ROWS, dtype=torch.uint8, device=dev)
    bits = ((bitmap.reshape(tiles, 1, NG) >> shifts.view(1, -1, 1)) & 1
            ).reshape(tiles, _TILE).to(torch.int64)
    rank = torch.cumsum(bits, -1) - bits
    rows = (_popcount8(bitmap).reshape(tiles, NG).sum(-1) + NG - 1) // NG
    base = (torch.cumsum(rows, 0) - rows).to(torch.int64)[:, None]
    row = base + (rank >> 7)
    ok = (bits == 1) & (row * NG < values.numel())
    index = (row * NG + (rank & (NG - 1))).clamp(0, max(values.numel() - 1, 0))
    if values.numel() == 0:
        sym = torch.zeros(tiles * _TILE, dtype=torch.uint8, device=dev)
    else:
        sym = torch.where(ok, values.reshape(-1)[index], 0).to(torch.uint8).reshape(-1)
    return sym[:p]


def read_wire(streams, counts, hists, *, spec: Spec, s_seg: int,
              sparse: bool, kcaps=()) -> torch.Tensor:
    """The symbols a chunk's wire carries: (n_planes, P) uint8."""
    n, p = spec.n_planes, spec.p
    if not sparse:
        n_seg = streams.shape[0] // n
        freqs, cums = freq_tables(table_hists(hists, p, s_seg=s_seg,
                                              v_seg=pick_v_seg(n_seg)))
        sym = decode_segments(streams, counts, freqs, cums, [n_seg] * n,
                              s_seg=s_seg)
        return sym.reshape(n, -1)[:, :p]
    pp = sparse_pp(p)
    dense_kcap = segment_geometry(pp, s_seg)[1]
    nb, mb = segment_geometry(pp // 8, s_seg)
    v_b = pick_v_seg(nb)
    nb, mb = segment_geometry(pp // 8, s_seg, v_b)
    coded = [c for c in range(n) if kcaps[c] > 0]
    out = torch.zeros((n, p), dtype=torch.uint8, device=streams.device)
    if not coded:
        return out
    freqs, cums = freq_tables(torch.cat([
        table_hists(hists[coded], pp // 8, s_seg=s_seg, v_seg=v_b),
        hists[[n + c for c in coded]]]))
    planes = [nb] * len(coded) + [kcaps[c] // (s_seg * NG) for c in coded]
    flat = decode_segments(streams, counts, freqs, cums, planes,
                           s_seg=s_seg).reshape(-1)
    voff = len(coded) * mb
    for i, c in enumerate(coded):
        values = flat[voff: voff + kcaps[c]]
        if kcaps[c] >= dense_kcap:
            out[c] = values[:p]
        else:
            out[c] = expand_plane(flat[i * mb: i * mb + pp // 8], values, p)
        voff += kcaps[c]
    return out
