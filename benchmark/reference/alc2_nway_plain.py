"""Plain PyTorch reference of the ALC2 batch container, for judging a run.

It imports nothing of the program under test.  From ``alc3_plain`` it
takes the colour, the lift, the quantize and the zigzag (ALC2 codes the
same 8-bit symbols as the fused ALC3 transform: YCoCg-R, the lift with an
int16 store between the spatial and the temporal pass, dead-zone
quantize), and writes out here what is ALC2's own:

* the reference ``[low | high]`` layout: along each of T, H and W the
  even indices (low band) first, then the odd ones (high band);
* an independent reader of the payload: the sanitized 12-bit table of
  each stored histogram (the arithmetic of the reference's
  ``FrequencyTable::from_histogram`` with the renormalization that keeps
  every used slot inside the table), and the N-lane byte-rANS decode of
  every (chunk, channel) stream at once, vectorized over the lanes: lane
  k of a stream holds symbols k, k+N, k+2N, ..., each lane a reference
  rANS stream (PROB_BITS 12, RANS32_L 2^23, byte renormalization, its
  state the first four bytes big-endian), its start the lane table's;
* the decode's inverse: dequantize, the int32 inverse lift throughout (T,
  then H, then W; the negated-coefficient replay unless ``exact``), crop,
  the int16 truncating cast, inverse YCoCg-R;
* the judge of one batch (:func:`judge_one`) and the configuration's
  control (:func:`control_samples`).

Large volumes are worked one chunk and one channel at a time, so judging
a batch of 64x1080x1920 chunks fits on the card beside the run's kept
outputs.
"""

from __future__ import annotations

import torch

from reference import alc3_plain as a3

PROB_BITS = 12
PROB_SCALE = 1 << PROB_BITS
RANS32_L = 1 << 23
#: the lane coders step in whole tiles of 8 rows (an ALC2 wire constant)
STEP_ALIGN = 8


def lane_sym_count(p: int, n_lanes: int) -> int:
    """A channel's symbols padded for the lanes: a whole number of rows of
    ``n_lanes`` and a row count that is a multiple of 8.  The padding is
    zeros, coded like the rest."""
    steps = -(-p // n_lanes)
    steps += (-steps) % STEP_ALIGN
    return steps * n_lanes


# ── the layout ──────────────────────────────────────────────────


def to_low_high(sym: torch.Tensor, padded) -> torch.Tensor:
    """(3, P) symbols in the lift's interleaved layout → (3, P) in the
    reference [low | high] layout."""
    pw, ph, pf = padded
    x = sym.reshape(3, pf, ph, pw)
    for dim in (1, 2, 3):            # the padded dims are even
        even = torch.arange(0, x.shape[dim], 2, device=x.device)
        x = torch.cat([x.index_select(dim, even), x.index_select(dim, even + 1)], dim)
    return x.reshape(3, -1)


# ── the tables ──────────────────────────────────────────────────


def freq_table(hist) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A stored 256-bin histogram → its sanitized table: ``(freqs, cums,
    lut)`` int64, freqs summing to 4096, every symbol at least 1, and the
    slot → symbol map of the 4096 slots."""
    h = torch.as_tensor(hist).to(torch.int64).reshape(-1)
    n = h.numel()
    total = int(h.sum())
    if total == 0:                           # uniform
        per = PROB_SCALE // n
        freqs = torch.full((n,), per, dtype=torch.int64)
        freqs[-1] = PROB_SCALE - per * (n - 1)
    else:
        freqs = torch.where(h == 0, 1, (h * PROB_SCALE // total).clamp(min=1))
        excess = int(freqs.sum()) - PROB_SCALE
        while excess > 0:                    # take from the largest, first first
            imax = int(torch.argmax(freqs))
            take = min(excess, int(freqs[imax]) - 1)
            if take == 0:
                break
            freqs[imax] -= take
            excess -= take
        freqs[-1] += PROB_SCALE - int(freqs.sum())
    cums = torch.cumsum(freqs, 0) - freqs
    lut = torch.zeros(PROB_SCALE, dtype=torch.int64)
    for s in range(n):
        a = int(cums[s])
        lut[a:min(a + int(freqs[s]), PROB_SCALE)] = s
    return freqs, cums, lut


# ── the payload ─────────────────────────────────────────────────


def decode_lanes(payload, starts, tables, steps: int) -> torch.Tensor:
    """Byte-rANS decode of ``S`` streams of ``N`` lanes each: ``payload``
    flat uint8, ``starts`` (S, N) int64 byte offset of each lane in it,
    ``tables`` S ``(freqs, cums, lut)`` → (S, steps·N) uint8 symbols,
    symbol j·N + k from step j of lane k.  A lane reads its bytes in
    order from its start (a sound lane ends where the next begins; reads
    stay inside the payload whatever the lane table says)."""
    dev = payload.device
    s_n, n = starts.shape
    start = starts.reshape(-1).to(dev)
    last = max(payload.numel() - 1, 0)
    # one word a (stream, slot): the slot's symbol, its frequency (13 bits)
    # and its cumulative frequency (12 bits)
    word = torch.cat([lut | (freqs[lut] << 8) | (cums[lut] << 21)
                      for freqs, cums, lut in tables]).to(dev)
    row = torch.arange(s_n, device=dev).repeat_interleave(n) * PROB_SCALE

    def byte(pos):
        return torch.take(payload, (start + pos).clamp(0, last)).to(torch.int64)

    x = torch.zeros_like(start)
    for i in range(4):                       # the state, big-endian
        x = (x << 8) | byte(i)
    pos = torch.full_like(start, 4)
    out = torch.empty((steps, s_n * n), dtype=torch.uint8, device=dev)
    for j in range(steps):
        slot = x & (PROB_SCALE - 1)
        w = torch.take(word, row + slot)
        out[j] = w & 255
        x = ((w >> 8) & 8191) * (x >> PROB_BITS) + slot - (w >> 21)
        # after a symbol x ≥ 2^11 (RANS32_L >> 12): two bytes renormalize it
        for _ in range(2):
            need = x < RANS32_L
            x = torch.where(need, (x << 8) | byte(pos), x)
            pos = pos + need
    return out.reshape(steps, s_n, n).permute(1, 0, 2).reshape(s_n, steps * n)


def read_payload(stream, p: int, device) -> torch.Tensor:
    """The symbols an ALC2 stream's payload carries: (n_chunks, 3, p)
    uint8 in the reference layout, read with the tables of its stored
    histograms and its lane table."""
    b, n = stream.n_chunks, stream.n_lanes
    n_sym = lane_sym_count(p, n)
    payload = torch.frombuffer(bytearray(stream.payload), dtype=torch.uint8).to(device)
    lens = torch.as_tensor(stream.lane_lens.astype("int64")).reshape(b * 3, n)
    offsets = torch.tensor([0] + [h.compressed_len for hs in stream.chunk_headers
                                  for h in hs], dtype=torch.int64).cumsum(0)[:-1]
    starts = torch.cumsum(lens, 1) - lens + offsets[:, None]
    tables = [freq_table(h.histogram) for hs in stream.chunk_headers for h in hs]
    sym = decode_lanes(payload, starts, tables, n_sym // n)
    return sym[:, :p].reshape(b, 3, p)


# ── the inverse ─────────────────────────────────────────────────


def inverse_rgb(sym: torch.Tensor, spec) -> torch.Tensor:
    """(3, P) uint8 symbols in the lift's interleaved layout → the uint8
    (T, H, W, 3) frames of the decode's int32 inverse."""
    w, h, t = spec.dims
    pw, ph, pf = spec.padded
    steps = a3.lift_steps(spec.wavelet, inverse=True, exact=spec.exact)
    chans = []
    for c in range(3):
        x = (a3.unzigzag(sym[c]) * spec.step).reshape(pf, ph, pw)
        for axis in (-3, -2, -1):
            x = a3.lift_axis(x, steps, axis)
        chans.append(x[:t, :h, :w].to(torch.int16))
        del x
    return a3.ycocg_r_to_rgb(*chans)


# ── judging ─────────────────────────────────────────────────────


def header_mismatch(stream, inputs, config: dict, spec, ref_syms) -> int:
    """Header fields of a stream that differ from the configuration and
    from the reference's own symbols (``ref_syms``: one (3, P) tensor a
    chunk): the geometry, the chunk and lane counts, the wavelet, each
    channel's step, dead zone and symbol count, and each bin of its stored
    histogram."""
    w, h, t = spec.dims
    want = (w, h, t, len(inputs), int(config["codec"]["n_lanes"]),
            a3.WAVELETS[spec.wavelet])
    have = (stream.width, stream.height, stream.frames, stream.n_chunks, stream.n_lanes,
            int(stream.wavelet_type))
    head = sum(a != b for a, b in zip(want, have))
    for headers, sym in zip(stream.chunk_headers, ref_syms):
        for ch, hdr in enumerate(headers):
            head += ((hdr.quant_step != spec.step) + (hdr.quant_dead_zone != spec.step)
                     + (hdr.num_symbols != spec.p))
            want_hist = torch.bincount(sym[ch].to(torch.int64), minlength=256).cpu()
            have_hist = torch.as_tensor(hdr.histogram.astype("int64"))
            head += int((want_hist != have_hist).sum())
    return head


def judge_one(inputs, stream, decoded, config: dict) -> dict:
    """The numbers of one batch (``checks.py``): ``inputs`` the pool's
    chunks, ``stream`` the ALC2 stream, whose attributes alone are read
    (or a control's (B, 3, P) symbols in the reference layout),
    ``decoded`` the (B, T, H, W, 3) frames."""
    spec = a3.spec_of(config)
    dev = inputs[0].device
    ref_syms = [a3.forward_symbols(x, spec) for x in inputs]
    if isinstance(stream, torch.Tensor):    # a control's symbols
        head, wire = 0, stream
    else:
        head = header_mismatch(stream, inputs, config, spec, ref_syms)
        wire = read_payload(stream, spec.p, dev)
    mism = 0
    err = 0 if decoded.shape[0] == len(inputs) else 256
    for i, sym in enumerate(ref_syms):
        low_high = to_low_high(sym, spec.padded)
        mism += (int((wire[i] != low_high).sum()) if i < wire.shape[0]
                 and wire[i].shape == low_high.shape else low_high.numel())
        del low_high
        if i < decoded.shape[0]:
            err = max(err, a3.max_err(decoded[i], inverse_rgb(sym, spec)))
    return {"header_mismatch": head, "symbol_mismatch": mism, "rgb_max_err": err}


def control_samples(pool, config: dict, program):
    """The configuration's control, one batch of the pool (``control.py``):
    this reference in the program's place with the store between the lift
    passes lowered from int16 to int8, the next precision down — its
    symbols in the reference layout and the int32 inverse of them."""
    low = a3.spec_of(config, store=torch.int8)
    syms, frames = [], []
    for x in pool:
        sym = a3.forward_symbols(x, low)
        syms.append(to_low_high(sym, low.padded))
        frames.append(inverse_rgb(sym, low))
        del sym
    yield list(pool), torch.stack(syms), torch.stack(frames)
