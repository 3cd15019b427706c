"""The judge on the CPU: the plain reference agrees with the port's CPU
path at tiny shapes, its control (the reference in the program's place
at a lower precision, or the program's own non-exact inverse) comes out
not correct, and a run whose timed path is broken underneath comes out
not correct, once for each fault the cells can have."""

import time

import pytest
import torch

import checks
import harness
from conftest import BENCH, TINY_CHUNK
from reference import alc3_plain

CONTENT = {"gradient": [3, 2, 7], "noise_max": 15, "color_block": 64, "color_tblock": 16,
           "color_amp": 32}
STATIC = dict(CONTENT, noise_max=1, freeze_background=True,
              region={"size": 32, "speed": 4, "noise_max": 15})


def _config(quality, wavelet, sparse, exact):
    return {"chunk": dict(TINY_CHUNK),
            "codec": {"quality": quality, "wavelet": wavelet, "sparse": sparse, "s_seg": 16},
            "decode": {"exact": exact}, "lossless": quality >= 100 and exact,
            "reference": "alc3_plain"}


def _pool(content, seed):
    generate = harness.load_module(BENCH / "traffic" / "generate.py", "_traffic_generate")
    return generate.make_pool(content, 2, seed, TINY_CHUNK["frames"], TINY_CHUNK["height"],
                              TINY_CHUNK["width"], "cpu")


def _roundtrips(cfg, pool):
    from alice_codec_tpu_torch import Alc3Codec

    codec = Alc3Codec(**cfg["codec"], device="cpu")
    out = []
    for x in pool:
        c = codec.encode(x)
        out.append((x, c, codec.decode(c, exact=cfg["decode"]["exact"])))
    return out


CASES = [
    ("north_star", _config(90, "cdf53", True, False), CONTENT),
    ("lossless", _config(100, "haar", False, True), CONTENT),
    ("static", _config(90, "cdf53", True, False), STATIC),
    ("q50_static_sparse", _config(50, "cdf53", True, False), STATIC),
    ("gray_elided", _config(90, "cdf53", True, False), dict(CONTENT, color_amp=0)),
    ("dense_cdf97", _config(80, "cdf97", False, False), CONTENT),
]


@pytest.mark.parametrize("name,cfg,content", CASES, ids=[c[0] for c in CASES])
def test_reference_agrees_with_the_port(name, cfg, content):
    samples = _roundtrips(cfg, _pool(content, 11))
    numbers, failed = checks.judge(samples, cfg)
    assert failed == 0 and checks.passed(numbers), numbers
    spec = checks.spec_of(cfg)
    dense = alc3_plain.segment_geometry(alc3_plain.sparse_pp(spec.p), 16)[1]
    kcaps = [k for _, c, _ in samples for k in c.kcaps]
    if name == "q50_static_sparse":
        assert any(0 < k < dense for k in kcaps)
    if name == "gray_elided":        # grey content: both chroma planes elided
        assert kcaps.count(0) == 2 * len(samples)


@pytest.mark.parametrize("cell", ["ns1080.chunk", "lossless1080.chunk", "ns1080.batch4"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(tiny_root, cell, seed):
    """Each cell's control (``control.py``, run on the card at the cell's
    size) fails the cell's comparison: the lossy configuration's
    reference with an int8 store between its lift passes, the lossless
    configuration's program with its non-exact inverse."""
    import control

    c = harness.load_cell(tiny_root, cell)
    numbers, failed = checks.judge(control.control_samples(c, seed, "cpu"), c.config)
    assert failed == int(c.traffic["pool"]) and not checks.passed(numbers)
    assert numbers["rgb_max_err"] > 0
    if c.config.get("lossless"):
        assert numbers["input_max_err"] > 0
    else:
        assert numbers["symbol_mismatch"] > 0


def _run(root, cell, monkeypatch, seed=9):
    return harness.run_cell(harness.load_cell(root, cell), seed=seed, seconds=0.3,
                            trace=False, device="cpu", t_start=time.perf_counter(),
                            log=lambda s: None)


def _altered_symbol(monkeypatch):
    """A symbol altered where it is produced (phase 1's lift kernel)."""
    from alice_codec_tpu_torch import pipeline

    real = pipeline.forward_quant

    def broken(*a, **kw):
        out = real(*a, **kw).clone()
        out.view(-1)[12345] ^= 3
        return out

    monkeypatch.setattr(pipeline, "forward_quant", broken)


def _altered_word(monkeypatch):
    """A word of the wire altered where the entropy coder writes it."""
    from alice_codec_tpu_torch import alc3

    real = alc3.encode_words

    def broken(*a, **kw):
        streams, counts = real(*a, **kw)
        i = int(torch.nonzero(counts).view(-1)[0])
        streams[i].view(-1)[0] ^= 0x155
        return streams, counts

    monkeypatch.setattr(alc3, "encode_words", broken)


def _altered_pixel(monkeypatch):
    """A decoded pixel altered where the inverse colour produces it."""
    from alice_codec_tpu_torch import pipeline

    real = pipeline.color.ycocg_r_to_rgb

    def broken(*a):
        out = real(*a).clone()
        out.view(-1)[777] ^= 1
        return out

    monkeypatch.setattr(pipeline.color, "ycocg_r_to_rgb", broken)


def _stale_decode(monkeypatch):
    """A decode that returns the state it had (the last call's frames)."""
    from alice_codec_tpu_torch import Alc3Codec

    real = Alc3Codec.decode
    last = {}

    def broken(self, chunk, **kw):
        out = last.get("out")
        last["out"] = real(self, chunk, **kw)
        return last["out"] if out is None else out

    monkeypatch.setattr(Alc3Codec, "decode", broken)


def _half_batch(monkeypatch):
    """Half of the batch left out: its first half decoded twice."""
    from alice_codec_tpu_torch import Alc3Codec

    real = Alc3Codec.decode_batch

    def broken(self, chunks, **kw):
        half = len(chunks) // 2
        out = real(self, chunks[:half], **kw)
        return torch.cat([out, out])

    monkeypatch.setattr(Alc3Codec, "decode_batch", broken)


FAULTS = [
    ("ns1080.chunk", _altered_symbol), ("ns1080.chunk", _altered_word),
    ("ns1080.chunk", _altered_pixel), ("ns1080.chunk", _stale_decode),
    ("lossless1080.chunk", _altered_word), ("lossless1080.chunk", _altered_pixel),
    ("lossless1080.chunk", _stale_decode),
    ("ns1080.batch4", _half_batch), ("ns1080.batch4", _altered_pixel),
    ("ns1080.batch4", _altered_symbol), ("ns1080.batch4", _altered_word),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = _run(tiny_root, cell, monkeypatch)
    assert res["correct"] is False and res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
