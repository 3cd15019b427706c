"""The port's bridges (ML, cache, DB, crypto) against the JAX package's,
on the CPU.  Hashes run over kilobytes (the BLAKE3 is pure Python)."""

import numpy as np
import pytest
import torch

from alice_codec_tpu.bridges import cache as jcache
from alice_codec_tpu.bridges import crypto as jcrypto
from alice_codec_tpu.bridges import db as jdb
from alice_codec_tpu.bridges import ml as jml
from alice_codec_tpu_torch.bridges import cache, crypto, db, ml

# ── ML ──────────────────────────────────────────────────────────


def _ternary(rng, rows, cols):
    return rng.integers(-1, 2, (rows, cols)).astype(np.int8)


@pytest.mark.parametrize("rows, cols", [(2, 3), (8, 64), (5, 257)])
@pytest.mark.parametrize("kind", ["integer", "f32"])
def test_ternary_matvec_matches_jax(rows, cols, kind):
    """Integer-valued features: exactly JAX's logits; seeded float32
    features: within rtol 1e-6 / atol 1e-5 (both sum in float32, in their
    own orders)."""
    rng = np.random.default_rng(rows * cols)
    w = _ternary(rng, rows, cols)
    x = (rng.integers(-300, 300, cols).astype(np.float32) if kind == "integer"
         else rng.standard_normal(cols).astype(np.float32) * 50)
    got = ml.ternary_matvec(x, w, device="cpu")
    want = jml.ternary_matvec(x, w)
    assert got.dtype == want.dtype == np.float32
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    out, jout = np.full(rows + 2, 7, np.float32), np.full(rows + 2, 7, np.float32)
    assert ml.ternary_matvec(x, w, out, device="cpu") is out
    jml.ternary_matvec(x, w, jout)
    np.testing.assert_array_equal(out[rows:], jout[rows:])
    np.testing.assert_allclose(out, jout, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("features", [
    [5.0, 1.0, 3.0],   # class 0: 4, class 1: 4 -> the last maximum
    [1.0, 1.0, 1.0],   # 0 and 2: a tie again
    [-2.0, 7.5, 0.25],
])
def test_classifier_and_predictor_match_jax(features):
    weights = [1, -1, 0, 0, 1, 1]
    ours = ml.SubBandClassifier(weights, 3, 2, device="cpu")
    theirs = jml.SubBandClassifier(weights, 3, 2)
    assert ours.classify(features) == theirs.classify(features)
    a, b = np.zeros(2, np.float32), np.zeros(2, np.float32)
    ours.classify_logits(features, a)
    theirs.classify_logits(features, b)
    np.testing.assert_array_equal(a, b)
    mw = [1, 0, -1, 0, 0, 1, 0, -1]
    f4 = features + [4.0]
    assert (ml.MotionPredictor(mw, 4, device="cpu").predict(f4)
            == jml.MotionPredictor(mw, 4).predict(f4))


def test_classifier_ties_resolve_to_the_last_max():
    w = np.ones((4, 3), np.int8)  # every class scores the same
    assert (ml.SubBandClassifier(w, 3, 4, device="cpu").classify([1.0, 2.0, 3.0])
            == jml.SubBandClassifier(w, 3, 4).classify([1.0, 2.0, 3.0])
            == (3, 6.0))


def test_classifier_rejects_nonternary_like_jax():
    for mod, kw in ((ml, {"device": "cpu"}), (jml, {})):
        with pytest.raises(ValueError, match="ternary"):
            mod.SubBandClassifier([5, 0, 0, 0, 0, 0], 3, 2, **kw)


def test_ml_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ml.SubBandClassifier([1, 0, 0, 0, 1, 1], 3, 2)
    with pytest.raises(RuntimeError):
        ml.MotionPredictor([1] * 8, 4)
    with pytest.raises(RuntimeError):
        ml.ternary_matvec([1.0], np.ones((1, 1), np.int8))


# ── cache ───────────────────────────────────────────────────────


def test_frame_cache_sequence_matches_jax():
    """The same puts and gets: the same hits, misses, evictions and data."""
    rng = np.random.default_rng(0)
    caches = (cache.FrameCache(3), jcache.FrameCache(3))
    ops = [("put", int(c), int(f), int(q)) if rng.random() < 0.4
           else ("get", int(c), int(f), int(q))
           for c, f, q in rng.integers(0, 3, (200, 3))]
    for op, c, f, q in ops:
        if op == "put":
            px = np.full(4, c * 9 + f * 3 + q, np.uint8)
            for fc in caches:
                fc.put(c, f, q, px, 2, 2)
        else:
            got = [fc.get(c, f, q) for fc in caches]
            assert (got[0] is None) == (got[1] is None)
            if got[0] is not None:
                np.testing.assert_array_equal(got[0].data, got[1].data)
                assert (got[0].width, got[0].height) == (got[1].width, got[1].height)
        assert len(caches[0]) == len(caches[1])
        assert caches[0].is_empty == caches[1].is_empty
        assert caches[0].hit_rate() == caches[1].hit_rate()
    assert 0.0 < caches[0].hit_rate() < 1.0


def test_frame_cache_keeps_tensors_where_they_are():
    """A tensor is stored as given (detached, no copy); anything else as
    NumPy."""
    fc = cache.FrameCache(2)
    frame = torch.arange(12, dtype=torch.uint8, requires_grad=False).reshape(2, 2, 3)
    fc.put(0, 0, 90, frame, 2, 2)
    got = fc.get(0, 0, 90).data
    assert isinstance(got, torch.Tensor)
    assert got.data_ptr() == frame.data_ptr() and got.device == frame.device
    grad = torch.ones(3, requires_grad=True)
    fc.put(0, 1, 90, grad, 3, 1)
    assert not fc.get(0, 1, 90).data.requires_grad
    fc.put(0, 2, 90, [1, 2, 3], 3, 1)  # evicts frame 0 (LRU)
    assert isinstance(fc.get(0, 2, 90).data, np.ndarray)
    assert fc.get(0, 0, 90) is None and len(fc) == 2


# ── DB ──────────────────────────────────────────────────────────

_RECORDS = [(1000, 2.5e6, 38.5, 1200.0), (3000, 2.0e6, 36.0, 1300.0),
            (2000, 3.0e6, 40.0, 1100.0), (2000, 1.0e6, 41.25, 900.0),
            (7000, 4.5e6, 33.0, 1500.5)]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_tsdb_log_crosses_packages(tmp_path, writer):
    """A metrics sink written by one package reads in the other: equal
    scans, aggregates and downsamples."""
    mods = {"torch": db, "jax": jdb}
    w, r = mods[writer], mods["jax" if writer == "torch" else "torch"]
    sink = w.CodecMetricsSink.open(tmp_path / "m")
    sink.record(w.CodecMetrics(*_RECORDS[0], w.FrameType.PREDICTED))
    sink.record_batch([w.CodecMetrics(*rec) for rec in _RECORDS[1:]])
    sink.flush()
    other, mine = r.CodecMetricsSink.open(tmp_path / "m"), sink
    for a, b in ((0, 10_000), (1500, 2500), (2000, 2000), (8000, 9000)):
        assert other.query_bitrate(a, b) == mine.query_bitrate(a, b)
        assert other.query_psnr(a, b) == mine.query_psnr(a, b)
        assert other.query_encode_time(a, b) == mine.query_encode_time(a, b)
        assert other.average_bitrate(a, b) == mine.average_bitrate(a, b)
        assert other.average_psnr(a, b) == mine.average_psnr(a, b)
        assert other.max_encode_time(a, b) == mine.max_encode_time(a, b)
        for step in (1, 1000, 3000):
            assert other.downsample_bitrate(a, b, step) == mine.downsample_bitrate(a, b, step)
            assert other.downsample_psnr(a, b, step) == mine.downsample_psnr(a, b, step)
    tsdb = tmp_path / "m" / "psnr.tsdb"
    for agg in db.Aggregation:
        ours, theirs = db.TimeSeriesDB(tsdb), jdb.TimeSeriesDB(tsdb)
        assert (ours.aggregate(0, 10_000, agg)
                == theirs.aggregate(0, 10_000, jdb.Aggregation(agg.value)))
        ours.close()
        theirs.close()
    # a torn tail record is ignored by both
    with open(tsdb, "ab") as fh:
        fh.write(b"\x01\x02\x03")
    assert db.TimeSeriesDB(tsdb).scan(0, 10_000) == jdb.TimeSeriesDB(tsdb).scan(0, 10_000)


# ── crypto ──────────────────────────────────────────────────────


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 3000])
def test_hash_and_derive_key_match_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert crypto.content_hash(data).as_bytes() == jcrypto.content_hash(data).as_bytes()
    assert crypto.hash_data(data).hex() == jcrypto.hash_data(data).hex()
    assert (crypto.derive_key("alice-codec-v1", data).as_bytes()
            == jcrypto.derive_key("alice-codec-v1", data).as_bytes())


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_seals_open_in_the_other_package(direction):
    pytest.importorskip("cryptography")
    sealer, opener = (crypto, jcrypto) if direction == "torch_to_jax" else (jcrypto, crypto)
    raw = crypto.derive_key("alice-codec-v1", b"passphrase").as_bytes()
    plaintext = np.random.default_rng(7).integers(0, 256, 2048, np.uint8).tobytes()
    sealed = sealer.seal_bitstream(plaintext, sealer.Key.from_bytes(raw))
    assert len(sealed.data) == 24 + len(plaintext) + 16
    assert opener.open_bitstream(opener.SealedBitstream(sealed.data, len(plaintext)),
                                 opener.Key.from_bytes(raw)) == plaintext
    bad = bytearray(sealed.data)
    bad[30] ^= 1
    with pytest.raises(opener.CipherError):
        opener.open_sealed(opener.Key.from_bytes(raw), bytes(bad))
    with pytest.raises(opener.CipherError):
        opener.open_sealed(opener.Key.generate(), sealed.data)
    with pytest.raises(opener.CipherError):
        opener.open_sealed(opener.Key.from_bytes(raw), sealed.data[:39])
