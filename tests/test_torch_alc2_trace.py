"""The ALC2 container's tracing: the host-stage spans and the copy
counters of ``parallel/batch.py`` (``STAGES``), ``StageTimer``'s per-call
samples, and the CUDA event pairs of the K8 / K9 wrappers
(``ops/kernels/rans_nway.py``).  The cases marked ``gpu`` need the card
(each skips without one, decided inside the test)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alice_codec_tpu_torch import FrequencyTable, profiling
from alice_codec_tpu_torch.ops.kernels import rans_nway
from alice_codec_tpu_torch.parallel import BatchFrameDecoder, BatchFrameEncoder, batch

B, T, H, W, LANES = 2, 4, 16, 16, 8
SPANS = {True: ("alc2.encode.tables", "alc2.encode.to_host", "alc2.decode.parse",
                "alc2.decode.upload"),
         False: ("alc2.encode.tables", "alc2.decode.parse")}


def _batch(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, T, H, W, 3), np.uint8)


def _roundtrip(device_entropy, as_numpy=False):
    enc = BatchFrameEncoder(90, n_lanes=LANES, device_entropy=device_entropy, device="cpu")
    stream = enc.encode(_batch())
    out = BatchFrameDecoder(device_entropy=device_entropy, device="cpu").decode(
        stream, as_numpy=as_numpy)
    return stream, out


@pytest.mark.parametrize("device_entropy", [True, False])
def test_each_span_once_a_call(device_entropy):
    before = {n: batch.STAGES.counts.get(n, 0) for n in SPANS[True]}
    for _ in range(2):
        _roundtrip(device_entropy)
    for name in SPANS[True]:
        want = 2 if name in SPANS[device_entropy] else 0
        assert batch.STAGES.counts.get(name, 0) - before[name] == want, name
    for name in SPANS[device_entropy]:
        assert len(batch.STAGES.samples[name]) >= 2 and batch.STAGES.samples[name][-1] >= 0


def test_spans_are_profiler_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _roundtrip(True)
    names = [e.name for e in prof.events()]
    for name in SPANS[True]:
        assert names.count(name) == 1, name


@pytest.mark.parametrize("as_numpy", [False, True])
def test_counters_are_the_streams_bytes(as_numpy):
    counters = batch.STAGES.counters
    before = dict(counters)
    stream, out = _roundtrip(True, as_numpy)
    got = {k: counters[k] - before.get(k, 0) for k in counters}
    n = B * 3                                 # (chunk, channel) streams
    tables = n * 256 * 4                      # freqs or cums, int32
    lane_table = n * LANES * 4                # lane lengths, int32
    payload = len(stream.payload)
    assert payload == int(stream.lane_lens.sum()) > 0
    # encode: histograms (int64), totals (int64), lane table, payload back;
    # both tables up
    assert got["alc2.encode.d2h_reads"] == 4
    assert got["alc2.encode.d2h_bytes"] == n * 256 * 8 + n * 8 + lane_table + payload
    assert got["alc2.encode.h2d_bytes"] == 2 * tables
    # decode: payload, lane starts (int64) and lengths, both tables and the
    # slot LUTs (uint8) up, and the steps (int32); frames back on request
    frames = B * T * H * W * 3
    assert got["alc2.decode.d2h_reads"] == int(as_numpy)
    assert got["alc2.decode.d2h_bytes"] == frames * as_numpy
    assert got["alc2.decode.h2d_bytes"] == (payload + n * LANES * 8 + lane_table
                                            + 2 * tables + n * 4096 + n * 4)
    assert batch.STAGES.samples["alc2.encode.d2h_reads"][-1] == 4
    assert isinstance(out, np.ndarray) == as_numpy


def test_device_entropy_payload_is_a_read_only_view():
    """The device-entropy payload is a read-only view of the host memory
    it was read into: the host coder's bytes, through the container and
    into either decoder alike."""
    stream, out = _roundtrip(True, as_numpy=True)
    host, _ = _roundtrip(False)
    assert isinstance(stream.payload, memoryview) and stream.payload.readonly
    assert isinstance(host.payload, bytes) and stream.payload == host.payload
    assert stream.to_bytes() == host.to_bytes()
    again = batch.EncodedChunkStream.from_bytes(stream.to_bytes())
    for device_entropy in (True, False):
        dec = BatchFrameDecoder(device_entropy=device_entropy, device="cpu")
        np.testing.assert_array_equal(dec.decode(again), out)


def test_stage_timer_keeps_bounded_samples(monkeypatch):
    monkeypatch.setattr(profiling, "SAMPLES", 5)
    timer = profiling.StageTimer()
    for _ in range(7):
        with timer.stage("encode"):
            pass
    timer.tally("reads", 3)
    timer.tally("reads", 4)
    # the old API reads as before
    assert timer.counts["encode"] == 7 and timer.totals["encode"] >= 0
    assert timer.average_us("encode") == pytest.approx(timer.totals["encode"] / 7 * 1e6)
    assert timer.report().count("\n") == 0 and "7 calls" in timer.report()
    # the newest 5 calls kept; counts summed and kept per call
    assert len(timer.samples["encode"]) == 5 and sum(timer.samples["encode"]) <= \
        timer.totals["encode"]
    assert timer.counters["reads"] == 7 and list(timer.samples["reads"]) == [3, 4]
    assert "reads" not in timer.totals


def _nway_inputs(device, s=3, steps=16):
    g = torch.Generator().manual_seed(3)
    sym = torch.randint(0, 6, (s, steps * LANES), generator=g, dtype=torch.uint8)
    hist = torch.stack([torch.bincount(r.long(), minlength=256) for r in sym])
    tabs = [FrequencyTable.from_histogram(h.numpy().astype(np.uint32), sanitize=True)
            for h in hist]
    f, c, lut = (torch.from_numpy(np.stack([getattr(t, k) for t in tabs]).astype(dt))
                 for k, dt in (("freqs", np.int32), ("cums", np.int32),
                               ("cum_to_sym", np.uint8)))
    return sym.to(device), f.to(device), c.to(device), lut.to(device), steps


def _k8_k9(device):
    sym, f, c, lut, steps = _nway_inputs(device)
    pay, lens, _ = rans_nway.encode_pack_nway(sym, f, c, n_lanes=LANES)
    starts = rans_nway.lane_offsets(lens).reshape(lens.shape)
    out = rans_nway.decode_nway(pay, starts, lens, f, c, lut, steps=steps)
    assert torch.equal(out.reshape(sym.shape), sym)


def test_no_event_pair_on_the_cpu():
    n8, n9 = len(rans_nway.encode_pack_nway.events), len(rans_nway.decode_nway.events)
    _k8_k9("cpu")
    assert len(rans_nway.encode_pack_nway.events) == n8
    assert len(rans_nway.decode_nway.events) == n9
    assert rans_nway.encode_pack_nway.events.maxlen == rans_nway.EVENTS_KEPT


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_one_event_pair_a_launch_on_the_card(cuda):
    for fn in (rans_nway.encode_pack_nway, rans_nway.decode_nway):
        fn.events.clear()
    _k8_k9(cuda)
    (k8,), (k9,) = rans_nway.encode_pack_nway.events, rans_nway.decode_nway.events
    assert len(k8) == 2 and len(k9) == 1           # encode_slabs + compact_lanes; K9
    torch.cuda.synchronize()
    for fn in (rans_nway.encode_pack_nway, rans_nway.decode_nway):
        (ms,) = rans_nway.event_ms(fn)
        assert ms > 0


@pytest.mark.gpu
def test_card_payloads_stay_apart(cuda):
    """Payloads read back from the card into reused page-locked blocks:
    each stream keeps its own bytes while the next is encoded, and the
    card decodes them, its uploads staged the same way."""
    enc = BatchFrameEncoder(90, n_lanes=LANES, device_entropy=True, device=cuda)
    ref = BatchFrameEncoder(90, n_lanes=LANES, device_entropy=True, device="cpu")
    dec = BatchFrameDecoder(device_entropy=True, device=cuda)
    batches = [_batch(seed) for seed in range(3)]
    streams = [enc.encode(x) for x in batches]
    for x, s in zip(batches, streams):
        assert s.to_bytes() == ref.encode(x).to_bytes()
        want = BatchFrameDecoder(device_entropy=True, device="cpu").decode(s)
        np.testing.assert_array_equal(dec.decode(s), want)
