"""The ALC2 device coder's packed route against the JAX package and the
host coder, and numpy models of its CUDA kernels against the plain
versions (``ops/kernels/rans_nway.py``):

* the plain encode-and-pack (``encode_pack_nway`` on the CPU: the plain
  encode, ``pack_device`` per stream, the concatenation) against JAX's
  ``encode_pack_device`` and the native ``alc_rans_encode_nway``;
* the encode kernel's reciprocal division (``rcp_update``) against
  ``x // f`` at every frequency, at the edges of the reachable states;
* the decode kernel's table words (``decode_table``) against the tables;
* a model of the encode kernel's register gather, backward word stores
  into per-lane slabs (``slab_bytes``) and the compaction at
  ``lane_offsets``, against ``pack_streams``;
* a model of the decode kernel's shared-memory ring (16-byte chunks
  landing a few refills after they start), register window (funnel
  shifts, capped refills) against ``decode_nway_plain``,
  on lanes starting 1-3 bytes past a word, cut short, and shorter than
  their 4-byte state.

Tiny shapes; every JAX result is computed once, in a module-scoped
fixture."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alice_codec_tpu.ops import rans_device as jrd

from alice_codec_tpu_torch.native import get_lib
from alice_codec_tpu_torch.ops import rans, rans_device
from alice_codec_tpu_torch.ops.kernels import rans_nway as rn

# several pytest workers share the CPU: keep torch on one thread
torch.set_num_threads(1)

LANES = (5, 128)
STEPS = 9  # odd: the slab's end and the word stores' alignment
U = np.uint64
U32 = U(0xFFFFFFFF)


def _streams(lanes: int, steps: int = STEPS):
    """Three streams of ``steps`` x ``lanes`` symbols: random symbols under
    a random table, symbols with half the mass on 0 under a table that
    makes the rest rare (byte pairs), and a one-symbol histogram's table."""
    rng = np.random.default_rng(lanes)
    n = lanes * steps
    skew = np.ones(256, np.uint32)
    skew[0] = 1 << 30
    one = np.zeros(256, np.uint32)
    one[7] = 99
    hists = [rng.integers(0, 1000, 256).astype(np.uint32), skew, one]
    sym = np.stack([
        rng.integers(0, 256, n),
        np.where(rng.random(n) < 0.5, 0, rng.integers(1, 256, n)),
        np.where(rng.random(n) < 0.9, 7, rng.integers(0, 256, n))]).astype(np.uint8)
    return sym, [rans.FrequencyTable.from_histogram(h, sanitize=True) for h in hists]


def _tables(tables):
    f = torch.from_numpy(np.stack([t.freqs for t in tables]).astype(np.int32))
    c = torch.from_numpy(np.stack([t.cums for t in tables]).astype(np.int32))
    lut = torch.from_numpy(np.stack([t.cum_to_sym for t in tables]))
    return f, c, lut


@pytest.fixture(scope="module")
def jax_packed():
    """JAX's ``encode_pack_device`` of each stream, the payloads
    concatenated, and its lane lengths, per lane count."""
    out = {}
    for lanes in LANES:
        sym, tables = _streams(lanes)
        pays, lens = [], []
        for i, t in enumerate(tables):
            pay, ln, total = jrd.encode_pack_device(
                jnp.asarray(sym[i]), jnp.asarray(t.freqs), jnp.asarray(t.cums),
                n_lanes=lanes)
            pays.append(np.asarray(pay)[: int(total)])
            lens.append(np.asarray(ln))
        out[lanes] = (np.concatenate(pays), np.stack(lens))
    return out


@pytest.mark.parametrize("lanes", LANES)
def test_encode_pack_plain_matches_jax_and_native(jax_packed, lanes):
    sym, tables = _streams(lanes)
    f, c, _ = _tables(tables)
    before = rn.encode_pack_nway.launches
    pay, lens, totals = rn.encode_pack_nway(torch.from_numpy(sym), f, c,
                                            n_lanes=lanes)
    assert rn.encode_pack_nway.launches == before  # the CPU path launches nothing
    assert rans_device.encode_pack_device is rn.encode_pack_nway
    want_pay, want_lens = jax_packed[lanes]
    assert pay.numpy().tobytes() == want_pay.tobytes()
    np.testing.assert_array_equal(lens.numpy(), want_lens)
    np.testing.assert_array_equal(totals.numpy(), want_lens.sum(1))
    assert totals.dtype == torch.int64 and lens.dtype == torch.int32
    _, counts, _ = rn.encode_nway_plain(torch.from_numpy(sym), f, c, n_lanes=lanes)
    assert bool((counts[1] == 2).any())  # the skewed stream emits byte pairs
    lib, off = get_lib(), 0
    for i, t in enumerate(tables):  # each stream equals the native coder's
        nat = np.empty(2 * sym.shape[1] + 8 * lanes, np.uint8)
        nat_lens = np.zeros(lanes, np.uint32)
        total = lib.alc_rans_encode_nway(
            rans._ctypes_ptr(sym[i]), sym.shape[1], lanes,
            rans._ctypes_ptr(t.freqs), rans._ctypes_ptr(t.cums),
            rans._ctypes_ptr(nat), rans._ctypes_ptr(nat_lens))
        assert total == int(totals[i])
        assert nat[:total].tobytes() == pay[off: off + total].numpy().tobytes()
        np.testing.assert_array_equal(nat_lens, lens[i].numpy())
        off += total


def test_rcp_update_equals_division():
    """For every f in 1..4096, states at both ends of the range the
    division sees after renormalisation ([2^11 f, 2^19 f)) and on both
    sides of the multiples of f there, plus a random sample of it."""
    rng = np.random.default_rng(3)
    f = np.arange(1, 4097, dtype=np.uint64)[:, None]
    lo, hi = f << U(11), f << U(19)
    xs = [lo, lo + U(1), hi - U(1), hi - U(2)]
    for k in (1 << 11, (1 << 11) + 1, (1 << 19) - 1):
        xs += [U(k) * f - U(1), U(k) * f, U(k) * f + U(1)]
    xs.append(lo + (rng.random((4096, 64)) * (hi - lo).astype(np.float64)).astype(np.uint64))
    x = np.concatenate([np.broadcast_to(a, (4096, a.shape[1])) for a in xs], 1)
    x = np.clip(x, lo, hi - U(1))
    f = np.broadcast_to(f, x.shape)
    c = (rng.random(x.shape) * (U(4097) - f).astype(np.float64)).astype(np.uint64)
    want = ((x // f) << U(12)) + x % f + c
    np.testing.assert_array_equal(rn.rcp_update(x, f, c), want)


@pytest.mark.parametrize("kind", ["random", "skew"])
def test_decode_table_words(kind):
    rng = np.random.default_rng(11)
    if kind == "random":
        h = rng.integers(0, 1000, 256).astype(np.uint32)
    else:
        h = np.ones(256, np.uint32)
        h[200] = 1 << 30
    t = rans.FrequencyTable.from_histogram(h, sanitize=True)
    f, c, lut = _tables([t])
    w = rn.decode_table(f, c, lut)
    assert w.dtype == torch.int32 and w.shape == (1, 4096)
    w = w[0].numpy().view(np.uint32).astype(np.int64)
    sym, r, fr = w & 0xFF, (w >> 8) & 0xFFF, (w >> 20) + 1
    slot = np.arange(4096)
    np.testing.assert_array_equal(sym, t.cum_to_sym)
    np.testing.assert_array_equal(fr, t.freqs[sym])
    np.testing.assert_array_equal(slot - r, t.cums[sym])
    assert (r < fr).all()


# ── numpy models of the CUDA kernels ────────────────────────────


def _bswap(x):
    return (((x & U(0xFF)) << U(24)) | (((x >> U(8)) & U(0xFF)) << U(16))
            | (((x >> U(16)) & U(0xFF)) << U(8)) | (x >> U(24)))


def _model_encode_pack(sym, freqs, cums, lanes):
    """encode_slabs (a 64-bit gather, its oldest four bytes stored as a
    little-endian word below the lane's cursor, the state closing the
    lane) and compact_lanes (each lane from the end of its slab to its
    offset), lane by lane in numpy."""
    s, n = sym.shape
    steps = n // lanes
    slab = rn.slab_bytes(steps)
    assert slab % 16 == 0 and slab >= 2 * steps + 4
    rows = sym.reshape(s, steps, lanes).astype(np.int64)
    f_t, c_t = freqs.astype(np.uint64), cums.astype(np.uint64)
    slabs = np.zeros(s * lanes * slab + 16, np.uint8)
    end = (np.arange(s * lanes) + 1) * slab
    wp = end.copy()
    x = np.full(s * lanes, 1 << 23, np.uint64)
    acc = np.zeros(s * lanes, np.uint64)
    cnt = np.zeros(s * lanes, np.uint64)

    def store(m, word):
        assert (wp[m] % 4 == 0).all()  # aligned word stores
        for b in range(4):
            slabs[wp[m] + b] = (word[m] >> U(8 * b)) & U(0xFF)

    for j in range(steps - 1, -1, -1):
        f = np.take_along_axis(f_t, rows[:, j], 1).reshape(-1)
        c = np.take_along_axis(c_t, rows[:, j], 1).reshape(-1)
        xm = f << U(19)
        # x >= xm as the sign bit of xm - 1 - x (x < 2^31, xm <= 2^31)
        sh = ((((xm - U(1) - x) & U32) >> U(31))
              + (((xm - U(1) - (x >> U(8))) & U32) >> U(31))) << U(3)
        v = ((x & U(0xFF)) << U(8)) | ((x >> U(8)) & U(0xFF))
        acc = (acc << sh) | (v >> (U(16) - sh))
        cnt += sh
        x = rn.rcp_update(x >> sh, f, c)
        m = cnt >= U(32)
        cnt[m] -= U(32)
        wp[m] -= 4
        store(m, (acc >> cnt) & U32)
    acc = (acc << U(32)) | _bswap(x)
    wp -= 4
    store(np.ones_like(wp, bool), (acc >> cnt) & U32)
    bp = wp.copy()
    while (cnt > 0).any():
        m = cnt > 0
        bp[m] -= 1
        slabs[bp[m]] = (acc[m] >> (cnt[m] - U(8))) & U(0xFF)
        cnt[m] -= U(8)
    lens = (end - bp).astype(np.int32)
    offs = rn.lane_offsets(torch.from_numpy(lens.reshape(s, lanes))).numpy()
    out = np.full(int(lens.sum()), 0xAA, np.uint8)
    for w in range(s * lanes):
        out[offs[w]: offs[w] + lens[w]] = slabs[end[w] - lens[w]: end[w]]
    return out, lens.reshape(s, lanes)


@pytest.mark.parametrize("lanes", LANES)
def test_slab_model_equals_pack(lanes):
    sym, tables = _streams(lanes)
    f, c, _ = _tables(tables)
    want_pay, want_lens, _ = rn.pack_streams(
        *rn.encode_nway_plain(torch.from_numpy(sym), f, c, n_lanes=lanes))
    pay, lens = _model_encode_pack(sym, f.numpy(), c.numpy(), lanes)
    np.testing.assert_array_equal(lens, want_lens.numpy())
    assert pay.tobytes() == want_pay.numpy().tobytes()


def _funnel_l(lo, hi, sh, clamp=False):
    sh = np.minimum(sh, U(32)) if clamp else sh & U(31)
    return ((((hi << U(32)) | lo) << sh) >> U(32)) & U32


RING, REFILL, LAG = 8, 8, 3  # csrc/rans_nway.cu kRing, kRefill, kLag


def _model_decode(payload, starts, lens, table, steps):
    """decode_nway lane by lane in numpy: each lane's ring of RING 16-byte
    chunks (zeros past the payload), refilled with one chunk a lane every
    REFILL steps once the slot's chunk is taken, a copy landing only LAG
    refills after it starts (a word read before it lands reads the slot's
    old chunk); the window hi:lo at bit p8 with the next word nx; refills
    capped by the bytes left."""
    nbytes = payload.size
    st, ln = starts.reshape(-1).astype(np.int64), lens.reshape(-1).astype(np.int64)
    s, lanes = starts.shape
    stream = np.repeat(np.arange(s), lanes)
    tab = table.view(np.uint32).astype(np.uint64)
    c0 = st >> 4
    full = np.zeros((int(c0.max()) + steps // 4 + 2 * RING + 4) * 16, np.uint8)
    full[:nbytes] = payload
    words_le = full.view("<u4").astype(np.uint64)
    idx = np.arange(st.size)

    def load(c):  # (L, 4) little-endian words of chunk c
        return words_le[(c * 4)[:, None] + np.arange(4)]

    ring = np.zeros((st.size, RING, 4), np.uint64)
    for r in range(RING - 1):
        ring[:, r] = load(c0 + r)
    ic = np.full(st.size, RING - 1, np.int64)
    rw = (st >> 2) & 3
    pending = []

    def take(m):
        w = ring[idx, (rw >> 2) % RING, rw & 3]
        rw[m] += 1
        return _bswap(w)

    def refill():
        m = ic < (rw >> 2) + RING
        pending.append((m, ic % RING, load(c0 + ic)))
        ic[m] += 1
        while len(pending) > LAG:
            pm, slot, data = pending.pop(0)
            ring[idx[pm], slot[pm]] = data[pm]

    every = np.ones(st.size, bool)
    hi, lo, nx = take(every), take(every), take(every)
    p8 = ((st & 3) * 8).astype(np.uint64)
    x = _funnel_l(lo, hi, p8)
    keep = np.where(ln <= 0, U(0),
                    ~(U32 >> (U(8) * np.clip(ln, 0, 3).astype(np.uint64))) & U32)
    x = np.where(ln < 4, x & keep, x)
    hi, lo, nx = lo, nx, take(every)
    rem = np.maximum(ln - 4, 0)
    out = np.empty((steps, st.size), np.uint8)
    for j in range(steps):
        if j % REFILL == 0:
            refill()
        e = tab[stream, (x & U(0xFFF)).astype(np.int64)]
        h = x >> U(12)
        x = ((e >> U(20)) * h + h + ((e >> U(8)) & U(0xFFF))) & U32
        n = np.minimum((x < U(1 << 23)).astype(np.int64) + (x < U(1 << 15)), rem)
        rem -= n
        sft = (8 * n).astype(np.uint64)
        x = _funnel_l(_funnel_l(lo, hi, p8), x, sft, clamp=True)
        p8 += sft
        out[j] = e & U(0xFF)
        adv = p8 >= U(32)
        p8[adv] -= U(32)
        w = take(adv)
        hi, lo, nx = np.where(adv, lo, hi), np.where(adv, nx, lo), np.where(adv, w, nx)
    return out.reshape(steps, s, lanes).transpose(1, 0, 2)


@pytest.mark.parametrize("steps", [STEPS, 400])
def test_decode_window_model_matches_plain(steps):
    """Three streams side by side in one payload, every lane shifted by a
    0-3 byte gap so that lanes start at every offset in a word, lanes cut
    short, shorter than their state and empty, and one cut at the
    payload's end; at 400 steps the skewed stream's lanes run through
    their rings several times."""
    lanes = 5
    sym, tables = _streams(lanes, steps)
    f, c, lut = _tables(tables)
    pay, lens, _ = rn.encode_pack_nway(torch.from_numpy(sym), f, c, n_lanes=lanes)
    pay, lens = pay.numpy(), lens.numpy().astype(np.int64)
    rng = np.random.default_rng(7)
    gaps = rng.integers(0, 4, lens.shape)
    starts = np.cumsum(lens + gaps).reshape(lens.shape) - lens
    old = np.cumsum(lens).reshape(lens.shape) - lens
    data = np.zeros(int((starts + lens).max()), np.uint8)
    for a, b, n in zip(starts.reshape(-1), old.reshape(-1), lens.reshape(-1)):
        data[a: a + n] = pay[b: b + n]
    cut = lens.copy()
    cut[0, 1] = 9
    cut[1, 0] = 3
    cut[1, 4] = 0
    cut[2, 2] = 1
    cut[2, 4] = 6  # the last lane, and the payload ends with its 6 bytes
    table = rn.decode_table(f, c, lut).numpy()
    for ln, dat in ((lens, data), (cut, data[: starts[2, 4] + 6])):
        got = _model_decode(dat, starts, ln, table, steps)
        want = rn.decode_nway_plain(
            torch.from_numpy(dat.copy()), torch.from_numpy(starts),
            torch.from_numpy(ln.astype(np.int32)), f, c, lut, steps=steps)
        np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(
        _model_decode(data, starts, lens, table, steps).reshape(3, -1), sym)
    assert steps < 100 or lens.max() > 16 * 2 * RING  # the rings wrap
    assert set((starts & 3).reshape(-1)) == {0, 1, 2, 3}
