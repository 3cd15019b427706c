"""The port's rANS coders against the JAX package, bit for bit:

* the host 12-bit coder (``ops/rans.py``: ``FrequencyTable`` native and
  spec, with and without ``sanitize``; ``RansEncoder`` with its
  ``overflowed`` flag; ``RansDecoder``; the interleaved and SIMD coders);
* the plain N-lane coder of the ALC2 wire (the plain versions of the
  ``encode_nway`` / ``decode_nway`` kernels) against JAX's scan coder
  (``ops/rans_device.py``) and its Pallas kernels in interpret mode;
* the slot → symbol LUT against the two-level search of JAX's decoders;
* the stream packers (torch and numpy) against JAX's ``pack_device``.

Every JAX result is computed once, in a module-scoped fixture."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alice_codec_tpu.ops import rans as jrans
from alice_codec_tpu.ops import rans_device as jrd
from alice_codec_tpu.ops.pallas.rans_decode_kernel import decode_nway_pallas
from alice_codec_tpu.ops.pallas.rans_kernel import encode_nway_pallas

from alice_codec_tpu_torch.native import get_lib
from alice_codec_tpu_torch.ops import rans, rans_device
from alice_codec_tpu_torch.ops.kernels import rans_nway

# several pytest workers share the CPU: keep torch on one thread
torch.set_num_threads(1)

LANES = (1, 8, 128)
STEPS = 64  # a multiple of the Pallas kernels' 8-row tile


def _hists() -> dict[str, np.ndarray]:
    """Histograms for the table tests: random, skewed (its
    reference-exact table crosses PROB_SCALE), all zero, one symbol,
    counts near 2^32, and a short alphabet."""
    rng = np.random.default_rng(5)
    skew = np.zeros(256, np.uint32)
    skew[0] = 1 << 24
    skew[1:] = 1
    one = np.zeros(256, np.uint32)
    one[200] = 12345
    big = rng.integers(1 << 20, 1 << 24, 256).astype(np.uint32)
    return {
        "random": rng.integers(0, 1000, 256).astype(np.uint32),
        "skew": skew,
        "zero": np.zeros(256, np.uint32),
        "one": one,
        "big": big,
        "short": rng.integers(0, 50, 17).astype(np.uint32),
    }


HISTS = _hists()


def _nway_case(lanes: int):
    """One stream of STEPS x ``lanes`` symbols under a skewed sanitized
    table: half the symbols rare, so states climb and emit byte pairs."""
    rng = np.random.default_rng(lanes)
    n = lanes * STEPS
    sym = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 256, n)).astype(np.uint8)
    table = jrans.FrequencyTable.from_histogram(HISTS["skew"], sanitize=True)
    return sym, table


def _lane_mats(payload: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, int]:
    """Front-aligned (lanes, max_len) lane matrix of a packed payload (the
    JAX decoders' input form), max_len rounded up to 512 as its batch
    decoder does."""
    max_len = int(lens.max())
    max_len += (-max_len) % 512
    mats = np.zeros((len(lens), max_len), np.uint8)
    off = 0
    for k, ln in enumerate(lens):
        mats[k, :ln] = payload[off : off + ln]
        off += ln
    return mats, max_len


@pytest.fixture(scope="module")
def jax_nway():
    """JAX's N-lane results per lane count: the scan encode, the
    interpret-mode Pallas encode, the packed stream, and both decoders'
    symbols."""
    out = {}
    for lanes in LANES:
        sym, table = _nway_case(lanes)
        f, c = jnp.asarray(table.freqs), jnp.asarray(table.cums)
        scan = jrd.encode_device_nway(jnp.asarray(sym), f, c, n_lanes=lanes)
        pallas = encode_nway_pallas(jnp.asarray(sym), f, c, n_lanes=lanes,
                                    interpret=True)
        pay, lens, total = jrd.pack_device(*scan, n=sym.size, n_lanes=lanes)
        pay = np.asarray(pay)[: int(total)]
        lens = np.asarray(lens)
        mats, max_len = _lane_mats(pay, lens)
        dec_scan, _, _ = jrd.decode_device_nway(
            jnp.asarray(mats), jnp.asarray(lens), f, c,
            jnp.asarray(table.cum_to_sym), n_lanes=lanes, steps=STEPS,
            max_lane_bytes=max_len)
        dec_pallas = decode_nway_pallas(
            jnp.asarray(mats), jnp.asarray(lens), f, c, n_lanes=lanes,
            steps=STEPS, max_lane_bytes=max_len, interpret=True)
        out[lanes] = dict(
            sym=sym, table=table,
            scan=[np.asarray(a) for a in scan],
            pallas=[np.asarray(a) for a in pallas],
            payload=pay, lens=lens,
            dec_scan=np.asarray(dec_scan), dec_pallas=np.asarray(dec_pallas))
    return out


def _torch_tables(table):
    f = torch.from_numpy(table.freqs.astype(np.int32))[None]
    c = torch.from_numpy(table.cums.astype(np.int32))[None]
    lut = torch.from_numpy(table.cum_to_sym.copy())[None]
    return f, c, lut


# ── the N-lane coder (K8 / K9 plain versions) ───────────────────


@pytest.mark.parametrize("lanes", LANES)
def test_encode_nway_plain_matches_jax(jax_nway, lanes):
    ref = jax_nway[lanes]
    f, c, _ = _torch_tables(ref["table"])
    before = rans_nway.encode_nway.launches
    b2, counts, states = rans_nway.encode_nway(
        torch.from_numpy(ref["sym"])[None], f, c, n_lanes=lanes)
    assert rans_nway.encode_nway.launches == before  # the CPU path launches nothing
    assert int((counts == 2).sum()) > 0  # the case emits byte pairs
    for want in (ref["scan"], ref["pallas"]):
        np.testing.assert_array_equal(b2[0].numpy(), want[0])
        np.testing.assert_array_equal(counts[0].numpy(), want[1])
        np.testing.assert_array_equal(states[0].numpy(), want[2].astype(np.int64))
    # ops/rans_device names the same plain version
    assert rans_device.encode_device_nway is rans_nway.encode_nway_plain


@pytest.mark.parametrize("lanes", LANES)
def test_decode_nway_plain_matches_jax(jax_nway, lanes):
    ref = jax_nway[lanes]
    f, c, lut = _torch_tables(ref["table"])
    lens = torch.from_numpy(ref["lens"].astype(np.int32))[None]
    starts = torch.cumsum(lens.long(), 1) - lens.long()
    before = rans_nway.decode_nway.launches
    got = rans_nway.decode_nway(torch.from_numpy(ref["payload"].copy()), starts,
                                lens, f, c, lut, steps=STEPS)
    assert rans_nway.decode_nway.launches == before
    np.testing.assert_array_equal(got[0].numpy(), ref["dec_scan"])
    np.testing.assert_array_equal(got[0].numpy().astype(np.int32), ref["dec_pallas"])
    np.testing.assert_array_equal(got[0].numpy().reshape(-1), ref["sym"])


def test_nway_streams_decode_side_by_side():
    """Many streams per call, each with its own table and lane offsets in
    one flat payload (the ALC2 batch layout), and a lane length cut short
    (the `pos < len` guard: no byte past the lane is read)."""
    rng = np.random.default_rng(9)
    lanes, steps = 5, 24
    tables = [rans.FrequencyTable.from_histogram(h, sanitize=True)
              for h in (HISTS["random"], HISTS["skew"], HISTS["one"])]
    sym = rng.integers(0, 256, (3, lanes * steps)).astype(np.uint8)
    f = torch.from_numpy(np.stack([t.freqs for t in tables]).astype(np.int32))
    c = torch.from_numpy(np.stack([t.cums for t in tables]).astype(np.int32))
    lut = torch.from_numpy(np.stack([t.cum_to_sym for t in tables]))
    payload, lens, totals = rans_device.encode_pack_device(
        torch.from_numpy(sym), f, c, n_lanes=lanes)
    assert payload.numel() == int(totals.sum())
    starts = torch.cumsum(lens.long(), 1) - lens.long()
    starts += torch.cumsum(totals, 0)[:, None] - totals[:, None]
    out = rans_device.decode_device_nway(payload, starts, lens, f, c, lut,
                                         steps=steps)
    np.testing.assert_array_equal(out.reshape(3, -1).numpy(), sym)
    lib = get_lib()
    for i, t in enumerate(tables):  # each stream equals the native coder's
        nat = np.empty(2 * sym.shape[1] + 8 * lanes, np.uint8)
        nat_lens = np.zeros(lanes, np.uint32)
        total = lib.alc_rans_encode_nway(
            rans._ctypes_ptr(sym[i]), sym.shape[1], lanes,
            rans._ctypes_ptr(t.freqs), rans._ctypes_ptr(t.cums),
            rans._ctypes_ptr(nat), rans._ctypes_ptr(nat_lens))
        s0 = int(starts[i, 0])
        assert nat[:total].tobytes() == payload[s0: s0 + total].numpy().tobytes()
        np.testing.assert_array_equal(nat_lens, lens[i].numpy())
    cut = lens.clone()
    cut[1, 2] = 3  # shorter than its 4-byte state
    bad = rans_nway.decode_nway_plain(payload, starts, cut, f, c, lut, steps=steps)
    assert bad.shape == out.shape
    np.testing.assert_array_equal(bad[0].numpy(), out[0].numpy())


def test_lut_equals_two_level_search():
    """For sanitized tables (every frequency >= 1, strictly increasing
    cums) the 4096-entry slot -> symbol LUT equals the two-level 16-wide
    search over the cums that JAX's decoders run — on random and on
    hostile histograms."""
    rng = np.random.default_rng(13)
    hists = [HISTS[k] for k in ("random", "skew", "zero", "one", "big")]
    hists += [rng.integers(0, 1 << rng.integers(1, 31), 256).astype(np.uint32)
              for _ in range(20)]
    hists += [np.where(rng.random(256) < p, rng.integers(1, 1 << 30, 256), 0)
              .astype(np.uint32) for p in (0.01, 0.1, 0.5)]
    slot = np.arange(4096)
    for h in hists:
        for native in (True, False):
            t = rans.FrequencyTable.from_histogram(h, sanitize=True, native=native)
            cums = t.cums.astype(np.int64)
            assert (t.freqs >= 1).all() and int(t.freqs.astype(np.int64).sum()) == 4096
            hi = (cums[::16][None, :] <= slot[:, None]).sum(1) - 1
            blocks = cums.reshape(16, 16)[hi]
            lo = (blocks <= slot[:, None]).sum(1) - 1
            np.testing.assert_array_equal(t.cum_to_sym, hi * 16 + lo)


def test_pack_matches_jax(jax_nway):
    for lanes in LANES:
        ref = jax_nway[lanes]
        b2, counts, states = (torch.from_numpy(np.array(a)) for a in ref["scan"])
        states = states.to(torch.int64)
        pay, lens, total = rans_device.pack_device(
            b2, counts.to(torch.uint8), states, n=ref["sym"].size, n_lanes=lanes)
        assert int(total) == ref["payload"].size
        assert pay[: int(total)].numpy().tobytes() == ref["payload"].tobytes()
        assert not pay[int(total):].any()
        np.testing.assert_array_equal(lens.numpy(), ref["lens"])
        host, host_lens = rans_device.pack_lane_streams(*ref["scan"])
        want, want_lens = jrd.pack_lane_streams(ref["scan"][0], ref["scan"][1],
                                                states=ref["scan"][2])
        assert host == want == ref["payload"].tobytes()
        np.testing.assert_array_equal(host_lens, want_lens)


# ── the host 12-bit coder ───────────────────────────────────────


@pytest.mark.parametrize("name", sorted(HISTS))
def test_frequency_table_matches_jax(name):
    h = HISTS[name]
    for sanitize in (False, True):
        want = jrans.FrequencyTable.from_histogram(h, sanitize=sanitize)
        for native in (True, False):
            got = rans.FrequencyTable.from_histogram(h, sanitize=sanitize,
                                                     native=native)
            np.testing.assert_array_equal(got.freqs, want.freqs)
            np.testing.assert_array_equal(got.cums, want.cums)
            np.testing.assert_array_equal(got.cum_to_sym, want.cum_to_sym)
    u = rans.FrequencyTable.uniform(len(h))
    np.testing.assert_array_equal(u.freqs, jrans.FrequencyTable.uniform(len(h)).freqs)


@pytest.mark.parametrize("name", ["random", "skew", "one"])
def test_single_stream_coder_matches_jax(name):
    """RansEncoder bytes and ``overflowed`` (the skewed reference-exact
    table crosses PROB_SCALE, so rare symbols overflow), and RansDecoder
    symbols, state and position — native and spec."""
    rng = np.random.default_rng(len(name))
    h = HISTS[name]
    sym = np.where(rng.random(3000) < 0.6, int(np.argmax(h)),
                   rng.integers(0, 256, 3000)).astype(np.uint8)
    for sanitize in (False, True):
        jt = jrans.FrequencyTable.from_histogram(h, sanitize=sanitize)
        je = jrans.RansEncoder()
        je.encode_symbols(sym[:1000], jt)
        je.encode_symbols(sym[1000:], jt)
        want = je.finish()
        if name == "skew":
            assert je.overflowed != sanitize
        jd = jrans.RansDecoder(want)
        want_sym = jd.decode_n(len(sym) + 5, jt)
        for native in (True, False):
            t = rans.FrequencyTable.from_histogram(h, sanitize=sanitize)
            e = rans.RansEncoder(native=native)
            e.encode_symbols(sym[:1000], t)
            e.encode_symbols(sym[1000:], t)
            assert e.finish() == want
            assert e.overflowed == je.overflowed
            d = rans.RansDecoder(want, native=native)
            np.testing.assert_array_equal(d.decode_n(len(sym) + 5, t), want_sym)
            assert (d.state, d.pos) == (jd.state, jd.pos)
            assert d.is_empty == jd.is_empty
    one = rans.RansEncoder()
    one.encode(jt.get_symbol(3))
    jone = jrans.RansEncoder()
    jone.encode(jt.get_symbol(3))
    assert one.finish() == jone.finish()


def test_interleaved_and_simd_coders_match_jax():
    rng = np.random.default_rng(21)
    t = rans.FrequencyTable.from_histogram(HISTS["random"])
    jt = jrans.FrequencyTable.from_histogram(HISTS["random"])
    a = rng.integers(0, 256, 103).astype(np.uint8)
    b = rng.integers(0, 256, 41).astype(np.uint8)
    for calls in ([a], [a, b]):
        for native in (True, False):
            enc, jenc = rans.InterleavedRansEncoder(native=native), jrans.InterleavedRansEncoder()
            for syms in calls:
                enc.encode(syms, t)
                jenc.encode(syms, jt)
            data = enc.finish()
            assert data == jenc.finish()
            dec, jdec = rans.InterleavedRansDecoder(data, native=native), jrans.InterleavedRansDecoder(data)
            for n in (20, 30):
                np.testing.assert_array_equal(dec.decode_n(n, t), jdec.decode_n(n, jt))
    blob = rng.integers(0, 256, 64).astype(np.uint8).tobytes()
    np.testing.assert_array_equal(rans.SimdRansDecoder(blob).decode_n(16, t),
                                  jrans.SimdRansDecoder(blob).decode_n(16, jt))
    with pytest.raises(ValueError):
        rans.SimdRansDecoder(blob).decode_n(3, t)
