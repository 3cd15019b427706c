"""The harness on the CPU: discovery by name, the contract's limits on
BENCHMARK.json, the result line, the import check, the roofline's bytes
and the reading of a device trace."""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

import devtrace
import harness
import roofline
from conftest import BENCH, ROOT, TINY_CHUNK, make_tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in b["workloads"])
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1 and w["config"] in names
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_finds_its_parts(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.config["chunk"] == {"frames": 64, "height": 1080, "width": 1920}
    assert c.traffic["loop"] in ("chunk", "batch")
    assert harness.generator(ROOT, c.traffic).make_pool
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "chunks_per_s"}
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(ROOT, m["name"]))
    assert (BENCH / "reference" / f"{c.config['reference']}.py").is_file()
    assert (BENCH / "drivers" / f"{c.config['driver']}.py").is_file()
    assert c.driver.DECODE_KEYS >= set(c.config["decode"])


ALC2_PROBE_DRIVER = '''"""A probe's driver: the port's ALC2 batch wire."""

DECODE_KEYS = frozenset({"device_entropy", "exact"})


class Driver:
    def __init__(self, config, device):
        from alice_codec_tpu_torch.parallel import BatchFrameDecoder, BatchFrameEncoder

        dec = dict(config["decode"])
        self.exact = dec.pop("exact")
        self.enc = BatchFrameEncoder(**config["codec"], device=device)
        self.dec = BatchFrameDecoder(**dec, device=device)

    def encode_batch(self, batch):
        return self.enc.encode(batch)

    def decode_batch(self, stream):
        return self.dec.decode(stream, exact=self.exact, as_numpy=False)

    @staticmethod
    def samples(inputs, stream, out):
        return [(inputs, stream, out)]

    @staticmethod
    def held(stream):
        return ()
'''

ALC2_PROBE_REFERENCE = '''"""A probe's judge of an ALC2 batch: ALC3's plain transform (ALC2 codes
the same symbols in another order) against the stream's header fields,
its stored histograms (the symbols' counts; the payload is not read) and
the decoded frames."""

import torch

from reference import alc3_plain as a3


def judge_one(inputs, stream, decoded, config):
    spec = a3.spec_of(config)
    head = sum(a != b for a, b in zip(
        (stream.width, stream.height, stream.frames, stream.n_chunks),
        (*spec.dims, len(inputs))))
    miss = err = 0
    for i, x in enumerate(inputs):
        sym = a3.forward_symbols(x, spec)
        for ch, hdr in enumerate(stream.chunk_headers[i]):
            head += (hdr.quant_step != spec.step) + (hdr.num_symbols != spec.p)
            want = torch.bincount(sym[ch].to(torch.int64), minlength=256)
            miss += int((want - torch.as_tensor(hdr.histogram.astype("int64"))).abs().sum())
        err = max(err, a3.max_err(decoded[i], a3.inverse_rgb(sym, spec)))
    return {"header_mismatch": head, "symbol_mismatch": miss, "rgb_max_err": err}
'''


def _alc3_probe(root):
    """Another ALC3 configuration: a config file, a two-chunk mix and a
    metric of its own."""
    cfg = json.loads((root / "benchmark/configs/alc3_cdf53_q90_sparse_1080p.json").read_text())
    cfg.update(name="alc3_cdf97_q50_probe", codec=dict(cfg["codec"], quality=50,
                                                      wavelet="cdf97"))
    mix = json.loads((root / "benchmark/traffic/natural4.chunk.json").read_text())
    (root / "benchmark/traffic/natural2.chunk.json").write_text(json.dumps(dict(mix, pool=2)))
    return cfg, "natural2.chunk"


def _alc2_probe(root):
    """Another codec: the ALC2 batch (``BatchFrameEncoder`` /
    ``BatchFrameDecoder``, N-lane byte-rANS on the device's plain path)
    through a driver and a reference of its own."""
    (root / "benchmark/drivers/alc2_probe.py").write_text(ALC2_PROBE_DRIVER)
    (root / "benchmark/reference/alc2_probe_plain.py").write_text(ALC2_PROBE_REFERENCE)
    cfg = {"name": "alc2_probe", "chunk": dict(TINY_CHUNK),
           "codec": {"quality": 90, "wavelet": "cdf53", "n_lanes": 4096,
                     "device_entropy": True},
           "decode": {"device_entropy": True, "exact": False},
           "driver": "alc2_probe", "reference": "alc2_probe_plain", "lossless": False}
    return cfg, "natural4.batch4"


@pytest.mark.parametrize("probe", [_alc3_probe, _alc2_probe], ids=["alc3", "alc2"])
def test_a_new_cell_is_files_and_entries_only(tmp_path, probe):
    """A configuration, a traffic mix, a metric, and for another codec a
    driver and a reference, added as new files plus new entries, with no
    harness file edited, run and report."""
    root = make_tiny_root(tmp_path)
    before = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*.py")}
    cfg, traffic = probe(root)
    (root / f"benchmark/configs/{cfg['name']}.json").write_text(json.dumps(cfg))
    (root / "benchmark/metrics/roundtrips_probe.py").write_text(
        "def read(ctx):\n    return float(ctx['roundtrips'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": "a probe",
                             "file": f"benchmark/configs/{cfg['name']}.json",
                             "reduced": [], "why": "a probe"})
    bench["workloads"].append({"name": "probe.cell", "config": cfg["name"],
                               "traffic": traffic, "chips": 1, "why": "a probe"})
    bench["end_to_end"].append({"name": "roundtrips_probe", "unit": "count",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["probe.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(root, "probe.cell")
    res = harness.run_cell(cell, seed=3, seconds=0.2, trace=False, device="cpu",
                           t_start=time.perf_counter(), log=lambda s: None)
    assert res["correct"] and res["metrics"]["roundtrips_probe"]["value"] >= 1
    assert all(c == {"value": 0, "limit": 0} for c in res["checks"].values())
    per = int(cell.traffic["pool"]) if cell.traffic["loop"] == "batch" else 1
    assert res["attempted"] >= per and res["attempted"] % per == 0   # chunks, not streams
    assert "roundtrips_probe" not in harness.load_cell(root, "ns1080.chunk").end_to_end
    after = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*.py")
             if p.relative_to(root) in before}
    assert after == before


def test_unknown_parts_are_refused(tiny_root):
    with pytest.raises(harness.CellError):
        harness.load_cell(tiny_root, "no.such.cell")
    with pytest.raises(harness.CellError):
        harness.reader(tiny_root, "no_such_metric")


@pytest.mark.parametrize("where,key,value", [
    ("traffic", "clients", 4), ("traffic", "batch", 2), ("traffic", "loop", "mesh"),
    ("config", "threads", 2), ("decode", "levels", 3), ("chunk", "channels", 4)])
def test_a_setting_the_harness_does_not_read_is_refused(tiny_root, where, key, value):
    """No file can seem to set what the run ignores."""
    if where == "traffic":
        path = tiny_root / "benchmark/traffic/natural4.chunk.json"
    else:
        path = tiny_root / "benchmark/configs/alc3_cdf53_q90_sparse_1080p.json"
    d = json.loads(path.read_text())
    (d if where in ("traffic", "config") else d[where])[key] = value
    path.write_text(json.dumps(d))
    with pytest.raises(harness.CellError, match=key if key != "loop" else "loop"):
        harness.load_cell(tiny_root, "ns1080.chunk")


def test_unknown_content_and_codec_settings_fail_the_run(tiny_root):
    path = tiny_root / "benchmark/traffic/natural4.chunk.json"
    d = json.loads(path.read_text())
    d["content"]["motion_blur"] = 2
    path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match="motion_blur"):
        harness.run_cell(harness.load_cell(tiny_root, "ns1080.chunk"), seed=1, seconds=0.1,
                         trace=False, device="cpu", t_start=time.perf_counter(),
                         log=lambda s: None)
    d["content"].pop("motion_blur")
    path.write_text(json.dumps(d))
    cpath = tiny_root / "benchmark/configs/alc3_cdf53_q90_sparse_1080p.json"
    c = json.loads(cpath.read_text())
    c["codec"]["lanes"] = 4096
    cpath.write_text(json.dumps(c))
    with pytest.raises(TypeError, match="lanes"):
        harness.run_cell(harness.load_cell(tiny_root, "ns1080.chunk"), seed=1, seconds=0.1,
                         trace=False, device="cpu", t_start=time.perf_counter(),
                         log=lambda s: None)


def test_the_reference_is_found_by_the_configs_name(tiny_root):
    cell = harness.load_cell(tiny_root, "ns1080.chunk")
    ref = harness.reference(tiny_root, cell.config)
    assert ref.__file__ == str(tiny_root / "benchmark/reference/alc3_plain.py")
    with pytest.raises(harness.CellError):
        harness.reference(tiny_root, dict(cell.config, reference="alc2_plain"))
    path = tiny_root / "benchmark/configs/alc3_cdf53_q90_sparse_1080p.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), reference="alc2_plain")))
    with pytest.raises(harness.CellError, match="alc2_plain"):
        harness.load_cell(tiny_root, "ns1080.chunk")


@pytest.mark.parametrize("driver", [None, "alc2_batch", "../drivers/alc3"])
def test_a_config_names_a_driver_that_exists(tiny_root, driver):
    """No driver, or one that is not a file of ``drivers/``, is refused
    before a run: there is no default codec."""
    path = tiny_root / "benchmark/configs/alc3_cdf53_q90_sparse_1080p.json"
    cfg = json.loads(path.read_text())
    cfg.pop("driver")
    if driver is not None:
        cfg["driver"] = driver
    path.write_text(json.dumps(cfg))
    with pytest.raises(harness.CellError, match="driver" if driver is None else "drivers"):
        harness.load_cell(tiny_root, "ns1080.chunk")
    assert harness.load_cell(tiny_root, "lossless1080.chunk").driver.Driver


@pytest.mark.parametrize("change,number", [("extra", "psnr_floor_db"),
                                           ("missing", "rgb_max_err")])
def test_a_number_the_limits_do_not_hold_fails_the_run(tiny_root, change, number):
    """A reference that reports a number ``checks.LIMITS`` has no limit
    for fails the run (it cannot bring its own limit); one that leaves
    out a number the configuration needs stops it."""
    body = (f"dict(one, {number}=0)" if change == "extra"
            else f"{{k: v for k, v in one.items() if k != {number!r}}}")
    (tiny_root / "benchmark/reference/alc3_probe.py").write_text(
        "from reference import alc3_plain\n\n\n"
        "def judge_one(rgb, chunk, decoded, config):\n"
        "    one = alc3_plain.judge_one(rgb, chunk, decoded, config)\n"
        f"    return {body}\n")
    path = tiny_root / "benchmark/configs/alc3_cdf53_q90_sparse_1080p.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), reference="alc3_probe")))
    cell = harness.load_cell(tiny_root, "ns1080.chunk")
    run = dict(seed=6, seconds=0.2, trace=False, device="cpu", t_start=time.perf_counter(),
               log=lambda s: None)
    if change == "missing":
        with pytest.raises(ValueError, match=number):
            harness.run_cell(cell, **run)
        return
    res = harness.run_cell(cell, **run)
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"][number] == {"value": 0, "limit": None}
    assert all(c == {"value": 0, "limit": 0} for n, c in res["checks"].items() if n != number)


class _Driver:
    """A stand-in driver whose coded chunks hold no tensors to count."""

    @staticmethod
    def samples(inputs, coded, out):
        return list(zip(inputs, coded, out))

    @staticmethod
    def held(chunk):
        return ()


def _offer_all(keeper, n):
    for i in range(n):
        keeper.offer(_Driver, i, [f"in{i}"], [object()], [f"out{i}"])


def test_the_keeper_judges_every_pool_chunk_over_the_whole_window(monkeypatch):
    """One roundtrip a slot, drawn uniformly from all of the slot's
    roundtrips (a reservoir of one from the seed): every pool chunk is
    judged, the draws reach the window's end, and a seed draws the same."""
    monkeypatch.setattr(harness, "_storage_bytes", lambda tensors, seen: 0)
    dev = harness.Device("cpu")
    draws = []
    for seed in range(400):
        k = harness.Keeper(dev, 2**31 + seed, 4)
        _offer_all(k, 800)
        assert [r % 4 for r in k.roundtrips] == [0, 1, 2, 3]
        assert [(x, y) for x, _, y in k.kept] == [(f"in{r}", f"out{r}") for r in k.roundtrips]
        draws += k.roundtrips
    # uniform over 0..799: mean ≈ 400, and a quarter of them past 600
    assert 370 < sum(draws) / len(draws) < 430
    assert 0.2 < sum(d >= 600 for d in draws) / len(draws) < 0.3
    again = harness.Keeper(dev, 2**31 + 399, 4)
    _offer_all(again, 800)
    assert again.roundtrips == draws[-4:]
    one = harness.Keeper(dev, 7, 1)                # the batch loop: one slot
    _offer_all(one, 50)
    assert len(one.roundtrips) == 1


def test_the_keeper_takes_its_kept_bytes_off_the_peak():
    class Dev:
        def __init__(self):
            self.now, self.top = 0, 0

        def alloc(self, n):
            self.now += n
            self.top = max(self.top, self.now)

        def peak(self):
            return self.top

        def reset_peak(self):
            self.top = self.now

    import torch

    from drivers.alc3 import Driver

    dev = Dev()
    k = harness.Keeper(dev, 1, 1)
    chunk = type("C", (), {"streams": torch.zeros(4, dtype=torch.int32),
                           "counts": torch.zeros(1, dtype=torch.int32),
                           "hists": torch.zeros(1, dtype=torch.int32)})
    for i in range(20):
        out = torch.zeros(100, dtype=torch.uint8)
        dev.alloc(1000)                      # the roundtrip's working set
        dev.alloc(124)                       # its outputs: 100 + 16 + 4 + 4 bytes
        dev.now -= 1000
        old = k.entries[0]
        k.offer(Driver, i, ["x"], chunk(), out)
        if k.entries[0][0] != i or old is not None:
            dev.now -= 124                   # not kept, or the one it replaced: freed
    assert k.bytes == 124
    assert k.peak() == 1124                  # the working set and one output


@pytest.mark.parametrize("cell", ["ns1080.chunk", "lossless1080.chunk", "ns1080.batch4"])
def test_result_line(tiny_root, cell):
    """The last line's keys, in order, with ``checks`` last; every number
    compared is at its limit on a sound run."""
    res = harness.run_cell(harness.load_cell(tiny_root, cell), seed=2**31 + 17,
                           seconds=0.3, trace=False, device="cpu",
                           t_start=time.perf_counter(), log=lambda s: None)
    line = json.dumps(res)
    assert "\n" not in line
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"chunks_per_s", "roundtrip_ms_p95", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert res["device"]["platform"] == "cpu"  # a CPU run never claims the card
    want = {"header_mismatch", "symbol_mismatch", "rgb_max_err"}
    if cell.startswith("lossless"):
        want.add("input_max_err")
    assert set(res["checks"]) == want
    assert all(c == {"value": 0, "limit": 0} for c in res["checks"].values())


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["alice_codec_tpu_torch.alc3", "jaxtyping",
                                      "benchmark_x", "torch"]) == []
    assert harness.forbidden_modules(["jax.numpy", "alice_codec_tpu.pipeline", "bench",
                                      "benches.x", "flax", "jaxlib.xla"]) == [
        "alice_codec_tpu", "bench", "benches", "flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax(tiny_root):
    """A whole CPU run in a fresh process leaves no forbidden module."""
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
        "import harness\n"
        f"cell = harness.load_cell({str(tiny_root)!r}, 'ns1080.chunk')\n"
        "res = harness.run_cell(cell, seed=5, seconds=0.2, trace=False, device='cpu',"
        " t_start=time.perf_counter(), log=lambda s: None)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "alice_codec_tpu_torch" in top
    assert not top & harness.FORBIDDEN


def test_run_refuses_without_a_card_or_the_port(tmp_path):
    """No CUDA card: exit code not 0 and no result; a directory holding
    only BENCHMARK.json and the benchmark: the same."""
    args = ["--workload", "ns1080.chunk", "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), *args],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    alone = tmp_path / "alone"
    make_tiny_root(alone)
    out = subprocess.run([sys.executable, "benchmark/run.py", *args], capture_output=True,
                         text=True, timeout=300, cwd=alone)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_roofline_bytes_from_geometry_and_counted_words():
    p = 64 * 1080 * 1920
    w = roofline.ChunkWork(p=p, pp=134217728, s_seg=2048, n_streams=1728,
                           words=29_307_668, channels=3, sparse_planes=0)
    assert w.bytes("forward_quant") == 3 * 3 * p
    assert w.bytes("inverse_3d") == 8 * 3 * p
    seg = 1728 * 2048 * 128
    assert w.bytes("encode_words") == seg + 4 * 29_307_668 + 4 * 1728
    assert w.bytes("decode_words") == seg + 4 * 29_307_668 + 4 * 1728
    assert w.bytes("compact") == 0
    assert w.bytes("encode_nway") is None
    # K1 + K2 + K3 + K4 of one north-star chunk: ≈ 1.2 ms at 3.35 TB/s,
    # far below the padded 1.8 GB stream buffer's count
    least = roofline.least_seconds({"forward_quant": 1, "encode_words": 1,
                                    "decode_words": 1, "inverse_dequant": 1}, [w])
    assert least == pytest.approx((18 * p + 2 * (seg + 4 * 29_307_668 + 4 * 1728))
                                  / 3.35e12)
    # a batch: K1 a chunk, one K2 over both chunks
    two = roofline.least_seconds({"forward_quant": 2, "encode_words": 1}, [w, w])
    assert two == pytest.approx(2 * (9 * p + seg + 4 * 29_307_668 + 4 * 1728) / 3.35e12)
    assert roofline.least_seconds({"decode_nway": 1}, [w]) is None
    sp = roofline.ChunkWork(p=1000, pp=2048, s_seg=16, n_streams=4, words=10,
                            channels=3, sparse_planes=2)
    assert sp.bytes("expand") == 2 * (256 + 1000)
    assert sp.bytes("compact") == 2 * (2048 + 8 + 256)
    # another driver's work type: least_seconds asks each item, and a
    # launched wrapper that no item counts gives no share

    class Lanes:
        per_chunk = frozenset()

        def bytes(self, wrapper):
            return 1000 if wrapper == "encode_pack_nway" else None

    assert roofline.least_seconds({"encode_pack_nway": 1}, [Lanes(), Lanes()]) == \
        pytest.approx(2000 / 3.35e12)
    assert roofline.least_seconds({"encode_pack_nway": 1, "forward_quant": 4},
                                  [Lanes()]) is None


def test_csrc_kernel_names_and_trace_reading():
    csrc = devtrace.csrc_kernels(ROOT / "alice_codec_tpu_torch" / "csrc")
    assert {"spatial_tiles", "temporal_quant_t64", "encode_words", "decode_words",
            "compact", "expand", "temporal_lift_t64"} <= csrc
    assert devtrace.base_name("void (anonymous namespace)::spatial_tiles<short, "
                              "(anonymous namespace)::F, true>(short const*, int)") \
        == "spatial_tiles"
    assert devtrace.base_name("void at::native::elementwise_kernel<128, 4>(int)") \
        == "at::native::elementwise_kernel"

    def x(cat, name, ts, dur, corr=None):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {} if corr is None else {"correlation": corr}}

    events = [
        x("kernel", "void spin_kernel(long)", 0, 50, 1),
        x("user_annotation", "pool", 100, 5), x("user_annotation", "encode", 105, 300),
        x("user_annotation", "decode", 405, 300), x("user_annotation", "sync", 705, 95),
        x("cuda_runtime", "cudaLaunchKernel", 110, 5, 2),
        x("kernel", "void (anonymous namespace)::spatial_tiles<short>(short*)", 120, 100, 2),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 250, 50, 3),
        x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 420, 80, 4),
        x("cuda_runtime", "cudaLaunchKernel", 500, 5, 5),
        x("kernel", "void decode_words(int const*)", 600, 150, 5),
    ]
    p = devtrace.read_trace(events, csrc, {"forward_quant": 1, "decode_words": 1}, 1, [])
    assert p.complete and p.chunks == 1
    assert p.window_s == pytest.approx(700e-6)
    assert p.csrc_s == pytest.approx(250e-6) and p.glue_s == pytest.approx(130e-6)
    assert p.busy_s == pytest.approx(380e-6)
    assert p.ops[0] == ("void decode_words(int const*)", pytest.approx(150e-6))
    # idle: 100-120 (encode 105-405 holds 105), 220-250, 300-420, 500-600, 750-800
    assert p.gaps[0] == ("encode", pytest.approx(120e-6))
    assert ("sync", pytest.approx(50e-6)) in p.gaps
    # a launch whose kernel record is missing, and fewer records than launches
    lost = devtrace.read_trace(events[:-1], csrc, {"forward_quant": 1, "decode_words": 1},
                               1, [])
    assert not lost.complete and lost.missing
    assert not devtrace.read_trace(events, csrc, {"forward_quant": 3}, 1, []).complete


def test_metric_readers_leave_out_what_they_cannot_read():
    ctx = {"trace": True, "profile": None, "peak_bytes": None, "encode_s": [],
           "decode_s": [], "batch": 1, "setup_s": 1.0}
    for m in _bench()["per_layer"]:
        assert harness.reader(ROOT, m["name"])(ctx) is None
    # a profile that missed a launch: no device number at all
    ctx["profile"] = devtrace.Profile(False, 4, 1.0, 0.5, 0.2, 0.3, {"forward_quant": 4}, [])
    for name in ("glue_device_ms", "kernel_device_ms", "kernels_roofline",
                 "device_idle_pct"):
        assert harness.reader(ROOT, name)(ctx) is None
    ctx["profile"] = devtrace.Profile(True, 4, 1.0, 0.5, 0.2, 0.3, {"forward_quant": 4}, [])
    assert harness.reader(ROOT, "glue_device_ms")(ctx) == pytest.approx(75.0)
    assert harness.reader(ROOT, "kernel_device_ms")(ctx) == pytest.approx(50.0)
    assert harness.reader(ROOT, "device_idle_pct")(ctx) == pytest.approx(50.0)


def test_percentile_is_numpys_linear():
    np = pytest.importorskip("numpy")
    xs = [5.0, 1.0, 3.0, 9.0, 7.0, 2.0, 8.0]
    for q in (0, 50, 95, 100):
        assert harness.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_no_harness_file_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(?:from|import)\s+([\w.]+)", re.M)
    for src in Path(BENCH).rglob("*.py"):
        tops = {m.split(".")[0] for m in pat.findall(src.read_text())}
        assert not tops & harness.FORBIDDEN, src


@pytest.mark.parametrize("name", ["jax", "alice_codec_tpu", "bench"])
def test_a_run_that_loaded_jax_gives_no_result(tiny_root, monkeypatch, name):
    import types

    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    with pytest.raises(harness.ForbiddenModules):
        harness.run_cell(harness.load_cell(tiny_root, "ns1080.chunk"), seed=4, seconds=0.1,
                         trace=False, device="cpu", t_start=time.perf_counter(),
                         log=lambda s: None)


def test_profiled_roundtrips_summarize_their_chunks(tiny_root):
    """The traced run's roundtrips (run here without the profiler) and the
    work their chunks report to the roofline."""
    cell = harness.load_cell(tiny_root, "ns1080.batch4")
    geo = cell.config["chunk"]
    pool = harness.generator(tiny_root, cell.traffic).make_pool(
        cell.traffic["content"], 4, 1, geo["frames"], geo["height"], geo["width"], "cpu")
    import torch

    batch = torch.stack(pool)
    drv = cell.driver.Driver(cell.config, "cpu")
    loop = harness.Loop(drv, list(batch.unbind(0)), harness.Device("cpu"), batch)
    chunks, work = harness.profiled(loop, 2)()
    assert chunks == 8 and len(work) == 8
    w = drv.work(work[0])
    p = geo["frames"] * geo["height"] * geo["width"]
    assert (w.p, w.channels, w.s_seg) == (p, 3, 16)
    assert 0 < w.words and w.n_streams > 0 and w.sparse_planes == 3
