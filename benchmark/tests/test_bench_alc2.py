"""The ALC2 batch cell on the CPU: its driver and its plain judge run the
cell to ``correct`` at 8x64x128, a run whose timed path is broken
underneath is not correct, the control is not correct, the judge's own
reading of the payload is the program's symbols, and the work type and
the cell's metric readers count what they say."""

import collections
import json
import sys
import time
import types

import numpy as np
import pytest
import torch

import checks
import devtrace
import harness
from alc2_work import Alc2Work
from conftest import ROOT, TINY_CHUNK, make_tiny_root
from reference import alc2_nway_plain as ref

CELL = "alc2_1080.batch4"
CONFIG = "benchmark/configs/alc2_cdf53_q90_1080p.json"


@pytest.fixture
def alc2_root(tmp_path):
    """The tiny checkout, with the ``s_seg`` that ``make_tiny_root`` gives
    every configuration taken out of the ALC2 one (its encoder has none)."""
    root = make_tiny_root(tmp_path)
    path = root / CONFIG
    cfg = json.loads(path.read_text())
    cfg["codec"].pop("s_seg")
    path.write_text(json.dumps(cfg))
    return root


def _run(root, seed=2**31 + 41, trace=False):
    return harness.run_cell(harness.load_cell(root, CELL), seed=seed, seconds=0.3,
                            trace=trace, device="cpu", t_start=time.perf_counter(),
                            log=lambda s: None)


def _pool(root, seed=7):
    cell = harness.load_cell(root, CELL)
    geo = cell.config["chunk"]
    return cell, harness.generator(root, cell.traffic).make_pool(
        cell.traffic["content"], 4, seed, geo["frames"], geo["height"], geo["width"], "cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct(alc2_root, trace):
    res = _run(alc2_root, trace=trace)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 4 and res["attempted"] % 4 == 0     # chunks, not batches
    assert all(c == {"value": 0, "limit": 0} for c in res["checks"].values())
    assert set(res["checks"]) == {"header_mismatch", "symbol_mismatch", "rgb_max_err"}
    # a CPU run reads no per-layer number: they are the card's
    want = set() if trace else {"chunks_per_s", "roundtrip_ms_p95", "setup_s"}
    assert set(res["metrics"]) == want


def test_the_cell_keeps_the_contract():
    cell = harness.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.traffic["loop"] == "batch"
    assert {m["name"] for m in cell.per_layer} == {"alc2_host_ms", "nway_device_ms",
                                                   "nway_roofline"}
    assert cell.config["codec"] == {"quality": 90, "wavelet": "cdf53", "n_lanes": 4096,
                                    "device_entropy": True}
    drv = cell.driver.Driver(dict(cell.config, chunk=dict(TINY_CHUNK)), "cpu")
    with pytest.raises(ValueError, match="batches only"):
        drv.encode(torch.zeros((8, 64, 128, 3), dtype=torch.uint8))


def _flip_payload_byte(monkeypatch):
    from alice_codec_tpu_torch.parallel import BatchFrameEncoder

    real = BatchFrameEncoder.encode

    def broken(self, batch):
        s = real(self, batch)
        pay = bytearray(s.payload)
        pay[len(pay) // 2] ^= 0x5A
        s.payload = bytes(pay)
        return s

    monkeypatch.setattr(BatchFrameEncoder, "encode", broken)


def _swap_lane_lengths(monkeypatch):
    from alice_codec_tpu_torch.parallel import BatchFrameEncoder

    real = BatchFrameEncoder.encode

    def broken(self, batch):
        s = real(self, batch)
        lens = s.lane_lens[1, 2]
        i, j = np.flatnonzero(lens != lens[0])[0], 0
        lens[[i, j]] = lens[[j, i]]
        return s

    monkeypatch.setattr(BatchFrameEncoder, "encode", broken)


def _change_header_step(monkeypatch):
    from alice_codec_tpu_torch.parallel import BatchFrameEncoder

    real = BatchFrameEncoder.encode

    def broken(self, batch):
        s = real(self, batch)
        s.chunk_headers[2][0].quant_step += 1
        return s

    monkeypatch.setattr(BatchFrameEncoder, "encode", broken)


def _alter_decoded_pixel(monkeypatch):
    from alice_codec_tpu_torch.parallel import BatchFrameDecoder

    real = BatchFrameDecoder.decode

    def broken(self, stream, **kw):
        out = real(self, stream, **kw).clone()
        out.view(-1)[4321] ^= 1
        return out

    monkeypatch.setattr(BatchFrameDecoder, "decode", broken)


FAULTS = [_flip_payload_byte, _swap_lane_lengths, _change_header_step, _alter_decoded_pixel]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__.strip("_") for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(alc2_root, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(alc2_root)
    assert res["correct"] is False and res["failed"] == 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_control_is_not_correct(alc2_root, seed):
    """The control: the reference with its int16 store between the lift
    passes lowered to int8."""
    import control

    cell = harness.load_cell(alc2_root, CELL)
    numbers, failed = checks.judge(control.control_samples(cell, seed, "cpu"), cell.config,
                                   harness.reference(alc2_root, cell.config))
    assert failed == 1 and not checks.passed(numbers)
    assert numbers["symbol_mismatch"] > 0 and numbers["rgb_max_err"] > 0


def test_the_judges_reading_is_the_programs_symbols(alc2_root):
    """The reference's payload reading and its [low | high] layout of its
    own transform both equal the symbols the program coded."""
    cell, pool = _pool(alc2_root)
    drv = cell.driver.Driver(cell.config, "cpu")
    batch = torch.stack(pool)
    stream = drv.encode_batch(batch)
    program, hists = drv.enc.encode_device_stage(batch)
    spec = ref.a3.spec_of(cell.config)
    assert torch.equal(ref.read_payload(stream, spec.p, "cpu"), program)
    own = torch.stack([ref.to_low_high(ref.a3.forward_symbols(x, spec), spec.padded)
                       for x in pool])
    assert torch.equal(own, program)
    decoded = drv.decode_batch(stream)
    assert all(torch.equal(decoded[i], ref.inverse_rgb(ref.a3.forward_symbols(x, spec), spec))
               for i, x in enumerate(pool))


@pytest.mark.parametrize("kind", ["natural", "one_symbol", "empty", "flat", "skewed"])
def test_the_judges_tables_are_the_ports(kind):
    from alice_codec_tpu_torch import FrequencyTable

    rng = np.random.default_rng(5)
    hist = {"natural": rng.integers(0, 10**6, 256),
            "one_symbol": np.eye(256, dtype=np.int64)[17] * 132_710_400,
            "empty": np.zeros(256, np.int64),
            "flat": np.full(256, 3),
            # many rare symbols beside one large one: the renormalization
            "skewed": np.r_[[10**8], rng.integers(1, 40, 255)]}[kind].astype(np.uint32)
    port = FrequencyTable.from_histogram(hist, sanitize=True)
    freqs, cums, lut = ref.freq_table(hist)
    assert int(freqs.sum()) == ref.PROB_SCALE and int(freqs.min()) >= 1
    assert freqs.tolist() == port.freqs.tolist() and cums.tolist() == port.cums.tolist()
    assert lut.tolist() == port.cum_to_sym.tolist()


def test_work_bytes_by_hand():
    w = Alc2Work(p=132_710_400, n_sym=132_710_400, n_lanes=4096, payload=61_000_000)
    # K8: 3 x 132,710,400 lane symbols in, the payload and 3 x 4096 int32 lengths out
    assert w.bytes("encode_pack_nway") == 398_131_200 + 61_000_000 + 49_152
    # K9: the payload, 3 x 4096 (int64 start, int32 length) in, the symbols out
    assert w.bytes("decode_nway") == 61_000_000 + 147_456 + 398_131_200
    assert w.bytes("forward_quant") == 3 * 398_131_200      # int16 volume, uint8 symbols
    assert w.bytes("inverse_3d") == 8 * 398_131_200         # int32 in and out
    assert w.bytes("encode_words") is None
    assert ref.lane_sym_count(65_536, 4096) == 65_536
    assert ref.lane_sym_count(65_537, 4096) == 24 * 4096     # 17 rows, padded to 24
    # the batch: one K8 and one K9 launch over every chunk, K1 / K7 one a chunk
    from roofline import HBM_BYTES_PER_S, least_seconds

    four = [w] * 4
    least = least_seconds({"encode_pack_nway": 1, "decode_nway": 1, "forward_quant": 4,
                           "inverse_3d": 4}, four)
    assert least == pytest.approx(4 * (w.bytes("encode_pack_nway") + w.bytes("decode_nway")
                                       + 11 * 398_131_200) / HBM_BYTES_PER_S)


def _ctx(prof):
    return {"trace": True, "profile": prof, "peak_bytes": None, "encode_s": [],
            "decode_s": [], "batch": 4, "setup_s": 1.0}


NEW = ("alc2_host_ms", "nway_device_ms", "nway_roofline")
BATCH = "alice_codec_tpu_torch.parallel.batch"
NWAY = "alice_codec_tpu_torch.ops.kernels.rans_nway"


def test_metric_readers_read_nothing_without_the_recorder_or_the_events(monkeypatch):
    work = [Alc2Work(p=1000, n_sym=1024, n_lanes=8, payload=700)] * 4
    prof = devtrace.Profile(True, 4, 1.0, 0.5, 0.2, 0.3, {}, work)
    # no profile (a CPU run): nothing, whatever the port holds
    for m in NEW:
        assert harness.reader(ROOT, m)(_ctx(None)) is None
    # a port without the spans and the events (the parent commit)
    monkeypatch.setitem(sys.modules, BATCH, types.ModuleType(BATCH))
    monkeypatch.setitem(sys.modules, NWAY, types.ModuleType(NWAY))
    for m in NEW:
        assert harness.reader(ROOT, m)(_ctx(prof)) is None
    # the recorder and the events, but no call yet
    stages = types.SimpleNamespace(samples=collections.defaultdict(list))
    batch = types.ModuleType(BATCH)
    batch.STAGES = stages
    nway = types.ModuleType(NWAY)
    nway.encode_pack_nway, nway.decode_nway = object(), object()
    calls = {}
    nway.event_ms = lambda fn: calls.get(fn, [])
    monkeypatch.setitem(sys.modules, BATCH, batch)
    monkeypatch.setitem(sys.modules, NWAY, nway)
    for m in NEW:
        assert harness.reader(ROOT, m)(_ctx(prof)) is None
    # calls: medians of each span and each kernel, over the batch's 4 chunks
    for name, values in (("alc2.encode.tables", [0.004, 0.002, 0.003]),
                         ("alc2.encode.to_host", [0.010]),
                         ("alc2.decode.parse", [0.001, 0.005]),
                         ("alc2.decode.upload", [0.008, 0.006, 0.100])):
        stages.samples[name].extend(values)
    assert harness.reader(ROOT, "alc2_host_ms")(_ctx(prof)) == pytest.approx(
        (0.003 + 0.010 + 0.003 + 0.008) * 1e3 / 4)
    calls[nway.encode_pack_nway] = [3.0, 3.4, 9.0]
    calls[nway.decode_nway] = [3.1]
    assert harness.reader(ROOT, "nway_device_ms")(_ctx(prof)) == pytest.approx(6.5 / 4)
    least = (work[0].bytes("encode_pack_nway") + work[0].bytes("decode_nway")) / 3.35e12
    assert harness.reader(ROOT, "nway_roofline")(_ctx(prof)) == pytest.approx(
        least / (6.5e-3 / 4) * 100)
    # profiled chunks whose work does not count K8 / K9: no share
    other = devtrace.Profile(True, 4, 1.0, 0.5, 0.2, 0.3, {}, [types.SimpleNamespace(
        per_chunk=frozenset(), bytes=lambda wrapper: None)])
    assert harness.reader(ROOT, "nway_roofline")(_ctx(other)) is None
