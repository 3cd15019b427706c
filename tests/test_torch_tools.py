"""The port's tools against the JAX package's: the CLI, raw-video IO, the
`.alcs` chunk stream and the C ABI shim.

The sparse and mode CLI outputs are held to the committed JAX-written
goldens (``tests/golden/torch``: the live JAX sparse codec costs minutes
of CPU); the `.alc` and dense chunked ALC3 formats run the JAX CLI live,
once, in a module-scoped fixture at 6×8×8.  Byte equality everywhere.
"""

import contextlib
import ctypes
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench
from alice_codec_tpu import cli as jcli
from alice_codec_tpu import utils as jutils
from alice_codec_tpu.errors import InvalidBitstream as JInvalidBitstream
from alice_codec_tpu.errors import InvalidBufferSize as JInvalidBufferSize
from alice_codec_tpu.ffi import get_ffi_lib as jax_ffi_lib
from alice_codec_tpu.pipeline import EncodedChunk as JEncodedChunk
from alice_codec_tpu_torch import WaveletType, cli, ffi, psnr, utils
from alice_codec_tpu_torch.errors import InvalidBitstream, InvalidBufferSize
from alice_codec_tpu_torch.ffi import helpers
from alice_codec_tpu_torch.ops import wavelet
from alice_codec_tpu_torch.pipeline import EncodedChunk, FrameDecoder
from chip_smoke import golden_input

GOLDEN = Path(__file__).parent / "golden" / "torch"
T, H, W = 6, 8, 8
#: the formats run live against the JAX CLI: flags of ``encode``
LIVE = {"alc": ["-q", "90"],
        "alc3": ["-q", "90", "--format", "alc3", "--s-seg", "8",
                 "--chunk-size", "4"]}
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _light_cpu():
    """One torch thread, and the JAX programs of this module compiled with
    most XLA optimizations off (their results are the same; their compile
    is the cost here); both restored after the module."""
    threads = torch.get_num_threads()
    prev = jax.config.values["jax_disable_most_optimizations"]
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    torch.set_num_threads(threads)


def _run(main, argv) -> tuple[int, str, str]:
    """``main(argv)`` with its exit code, stdout and stderr."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    return code, out.getvalue(), err.getvalue()


def _encode_argv(src, dst, flags, t=T, h=H, w=W):
    return ["encode", str(src), "-o", str(dst), "-W", str(w), "-H", str(h),
            "-f", str(t), *flags]


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """Both CLIs on the same 6×8×8 input: each package encodes it in each
    live format, decodes the other's file and prints the other's info."""
    d = tmp_path_factory.mktemp("cli")
    raw = d / "in.rgb"
    raw.write_bytes(np.random.default_rng(3).integers(
        0, 256, (T, H, W, 3), dtype=np.uint8).tobytes())
    pkgs = {"torch": (cli.main, CPU), "jax": (jcli.main, [])}
    runs = {}
    for fmt, flags in LIVE.items():
        for pkg, (main, extra) in pkgs.items():
            runs["encode", pkg, fmt] = _run(
                main, _encode_argv(raw, d / f"{pkg}.{fmt}", flags + extra))
        for pkg, (main, extra) in pkgs.items():
            other = d / f"{'jax' if pkg == 'torch' else 'torch'}.{fmt}"
            runs["decode", pkg, fmt] = _run(
                main, ["decode", str(other), "-o", str(d / f"{pkg}.{fmt}.rgb"),
                       *extra])
            runs["info", pkg, fmt] = _run(main, ["info", str(other)])
    return d, runs


@pytest.mark.parametrize("fmt", list(LIVE))
def test_cli_writes_the_jax_cli_bytes(live, fmt):
    d, runs = live
    assert runs["encode", "torch", fmt] == runs["encode", "jax", fmt]
    assert runs["encode", "torch", fmt][0] == 0
    assert (d / f"torch.{fmt}").read_bytes() == (d / f"jax.{fmt}").read_bytes()


@pytest.mark.parametrize("fmt", list(LIVE))
def test_cli_decodes_and_describes_the_other_packages_file(live, fmt):
    d, runs = live
    for cmd in ("decode", "info"):
        assert runs[cmd, "torch", fmt] == runs[cmd, "jax", fmt]
        assert runs[cmd, "torch", fmt][0] == 0
    back = (d / f"torch.{fmt}.rgb").read_bytes()
    assert back == (d / f"jax.{fmt}.rgb").read_bytes()
    # 6 frames in chunks of 4: the second chunk pads with the last frame
    assert len(back) == (8 if fmt == "alc3" else T) * H * W * 3


def _golden_cases():
    dense = json.loads((GOLDEN / "manifest.json").read_text())
    cases = [pytest.param(
        GOLDEN / "dense.alc", ("chunk", dense["seed"], (dense["t"], dense["h"], dense["w"])),
        ["-q", "90", "--format", "alc3", "--s-seg", "16"],
        dense["sha256"]["dense.compat.rgb"], id="dense")]
    a = json.loads((GOLDEN / "sparse" / "manifest.json").read_text())["cases"]["a"]
    ck = a["chunks"][0]
    cases.append(pytest.param(
        GOLDEN / "sparse" / ck["file"], (ck["kind"], ck["seed"], ck["shape"]),
        ["-q", "50", "--format", "alc3", "--sparse", "--s-seg", "8"],
        ck["rgb_sha256"], id="sparse_a"))
    modes = json.loads((GOLDEN / "modes" / "manifest.json").read_text())["cases"]
    for name in ("deep", "deep_lossy", "rdo", "rdo_gray", "levels"):
        m, c = modes[name], modes[name]["codec"]
        flags = ["-q", str(c["quality"]), "-w", c["wavelet"], "--format", "alc3",
                 "--s-seg", str(c["s_seg"]), "--sparse"]
        flags += ["--rdo"] * c.get("rdo", False) + ["--deep"] * c.get("deep", False)
        flags += ["--levels", str(c["levels"])] if "levels" in c else []
        deep = c.get("deep") or c["quality"] >= 100
        cases.append(pytest.param(
            GOLDEN / "modes" / m["file"], (m["kind"], m["seed"], m["shape"]), flags,
            m["rgb_exact_sha256" if deep else "rgb_sha256"], id=f"mode_{name}"))
    return cases


@pytest.mark.parametrize("golden, src, flags, rgb_sha", _golden_cases())
def test_cli_writes_the_jax_goldens(tmp_path, golden, src, flags, rgb_sha):
    """The CLI's ALC3 files, in every mode flag, are the committed JAX
    containers byte for byte, and decode to the JAX decode's RGB (the exact
    inverse for deep files, as both CLIs decode them)."""
    rgb = golden_input(*src)
    t, h, w = rgb.shape[:3]
    (tmp_path / "in.rgb").write_bytes(rgb.tobytes())
    out, back = tmp_path / "out.alc", tmp_path / "back.rgb"
    code, _, err = _run(cli.main, _encode_argv(tmp_path / "in.rgb", out,
                                               flags + CPU, t, h, w))
    assert code == 0, err
    assert out.read_bytes() == golden.read_bytes()
    assert _run(cli.main, ["decode", str(golden), "-o", str(back), *CPU])[0] == 0
    assert hashlib.sha256(back.read_bytes()).hexdigest() == rgb_sha


def test_cli_bad_input_exit_codes_match_jax(tmp_path):
    bad = tmp_path / "bad.alc"
    bad.write_bytes(b"not an alc file at all")
    small = tmp_path / "small.rgb"
    small.write_bytes(b"abc")
    cases = [["info", str(bad)], ["decode", str(bad), "-o", str(tmp_path / "x")],
             ["info", str(tmp_path / "missing.alc")],
             ["decode", str(tmp_path / "missing.alc"), "-o", str(tmp_path / "x")],
             _encode_argv(small, tmp_path / "y", []),
             _encode_argv(small, tmp_path / "y", ["--format", "alc3"]),
             _encode_argv(tmp_path / "missing.rgb", tmp_path / "y", [])]
    for argv in cases:
        extra = CPU if argv[0] != "info" else []
        got, want = _run(cli.main, argv + extra), _run(jcli.main, argv)
        assert got == want == (1, "", got[2]), argv
        assert got[2].startswith("error: ")


def test_cli_without_a_card_fails(tmp_path, monkeypatch):
    """No card and no ``--device cpu``: exit 1 with resolve_device's error,
    and nothing written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = tmp_path / "in.rgb"
    raw.write_bytes(bytes(T * H * W * 3))
    for flags in ([], ["--format", "alc3"]):
        code, _, err = _run(cli.main, _encode_argv(raw, tmp_path / "o", flags))
        assert code == 1 and "no CUDA device" in err
        assert not (tmp_path / "o").exists()
    code, _, err = _run(cli.main, ["decode", str(GOLDEN / "dense.alc"), "-o",
                                   str(tmp_path / "o")])
    assert code == 1 and "no CUDA device" in err
    assert not (tmp_path / "o").exists()
    # info launches nothing: it parses on the host
    assert _run(cli.main, ["info", str(GOLDEN / "dense.alc")])[0] == 0


def test_cli_runs_as_a_module(tmp_path):
    r = subprocess.run([sys.executable, "-m", "alice_codec_tpu_torch.cli",
                        "info", str(GOLDEN / "dense.alc")],
                       capture_output=True, text=True, timeout=120,
                       cwd=Path(__file__).resolve().parent.parent)
    assert r.returncode == 0, r.stderr
    assert r.stdout == _run(jcli.main, ["info", str(GOLDEN / "dense.alc")])[1]


# ── raw IO and .alcs streams ────────────────────────────────────


def test_raw_rgb_io_matches_jax(tmp_path):
    frames = np.random.default_rng(0).integers(0, 256, (5, 4, 6, 3), np.uint8)
    utils.write_raw_rgb(tmp_path / "p.rgb", frames)
    jutils.write_raw_rgb(tmp_path / "j.rgb", frames)
    assert (tmp_path / "p.rgb").read_bytes() == (tmp_path / "j.rgb").read_bytes()
    for n in (None, 3):
        got = utils.read_raw_rgb(tmp_path / "p.rgb", 6, 4, frames=n)
        np.testing.assert_array_equal(got, jutils.read_raw_rgb(
            tmp_path / "p.rgb", 6, 4, frames=n))
    for args in ((6, 4, 99), (7, 4, None), (0, 4, None)):
        with pytest.raises(InvalidBufferSize) as e:
            utils.read_raw_rgb(tmp_path / "p.rgb", *args)
        with pytest.raises(JInvalidBufferSize) as je:
            jutils.read_raw_rgb(tmp_path / "p.rgb", *args)
        assert str(e.value) == str(je.value)
    for size in (1, 4, 10, 64):
        got = list(utils.iter_chunks(frames, chunk_size=size))
        want = list(jutils.iter_chunks(frames, chunk_size=size))
        assert [n for _, n in got] == [n for _, n in want]
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_alcs_stream_crosses_packages(tmp_path, live, writer):
    """An `.alcs` file written by one package reads in the other; truncated
    by 7 bytes it gives back its complete chunks, and the other package
    resumes it."""
    data = (live[0] / "jax.alc").read_bytes()
    pkgs = {"torch": (utils, EncodedChunk), "jax": (jutils, JEncodedChunk)}
    (wmod, wchunk), (rmod, rchunk) = pkgs[writer], pkgs[
        "jax" if writer == "torch" else "torch"]
    path = tmp_path / "v.alcs"
    with wmod.AlcStreamWriter(path) as w:
        for _ in range(3):
            w.append(wchunk.from_bytes(data))
        assert w.chunks_written == 3
    assert [c.to_bytes() for c in rmod.AlcStreamReader(path)] == [data] * 3
    path.write_bytes(path.read_bytes()[:-7])
    reader = rmod.AlcStreamReader(path)
    assert len(list(reader)) == 2
    assert reader.valid_end == 8 + 2 * (4 + len(data))
    with rmod.AlcStreamWriter(path, resume=True) as w:
        assert w.chunks_written == 2
        w.append(rchunk.from_bytes(data))
    assert path.stat().st_size == 8 + 3 * (4 + len(data))
    assert len(list(wmod.AlcStreamReader(path))) == 3
    # a chunk that does not parse ends the iteration
    path.write_bytes(path.read_bytes()[:8] + (12).to_bytes(4, "little")
                     + b"x" * 12)
    assert list(utils.AlcStreamReader(path)) == []
    for mod, err in ((utils, InvalidBitstream), (jutils, JInvalidBitstream)):
        bad = tmp_path / "bad.alcs"
        bad.write_bytes(b"NOPE")
        with pytest.raises(err):
            mod.AlcStreamReader(bad)


# ── the C ABI shim ──────────────────────────────────────────────

FFI_NAMES = [
    "alice_codec_wavelet1d_haar", "alice_codec_wavelet1d_cdf53",
    "alice_codec_wavelet1d_cdf97", "alice_codec_wavelet1d_destroy",
    "alice_codec_wavelet1d_forward", "alice_codec_wavelet1d_inverse",
    "alice_codec_encoder_create", "alice_codec_encoder_destroy",
    "alice_codec_encode", "alice_codec_decode",
    "alice_codec_chunk_destroy", "alice_codec_chunk_to_bytes",
    "alice_codec_chunk_from_bytes", "alice_codec_chunk_width",
    "alice_codec_chunk_height", "alice_codec_chunk_frames",
    "alice_codec_psnr", "alice_codec_data_free",
    "alice_codec_string_free", "alice_codec_version",
]


@pytest.fixture(scope="module")
def lib():
    """The port's shim, its encode / decode on the CPU.  Skips only where
    there is no C++ compiler or no CPython header; a failed build fails."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    if not (Path(sysconfig.get_path("include")) / "Python.h").exists():
        pytest.skip("no CPython development header")
    yield ffi.get_ffi_lib(device="cpu")
    helpers.set_device(None)


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _shim_encode(lib, rgb, w, h, f, quality=90) -> bytes | None:
    enc = lib.alice_codec_encoder_create(quality)
    chunk = lib.alice_codec_encode(enc, _u8p(rgb), rgb.size, w, h, f)
    lib.alice_codec_encoder_destroy(enc)
    if not chunk:
        return None
    n = ctypes.c_uint32(0)
    ptr = lib.alice_codec_chunk_to_bytes(chunk, ctypes.byref(n))
    data = ctypes.string_at(ptr, n.value)
    lib.alice_codec_data_free(ptr, n.value)
    lib.alice_codec_chunk_destroy(chunk)
    return data


def test_ffi_surface_is_20_functions(lib):
    assert len(FFI_NAMES) == 20
    for name in FFI_NAMES:
        assert hasattr(lib, name), f"missing FFI symbol {name}"
    assert ffi._SO.name.startswith("libalice_codec.")
    v = lib.alice_codec_version()
    assert ctypes.string_at(v).decode() == "0.1.2"
    lib.alice_codec_string_free(ctypes.cast(v, ctypes.c_char_p))


@pytest.mark.parametrize("wt", list(WaveletType))
@pytest.mark.parametrize("n", [2, 7, 64])
def test_ffi_wavelet_matches_port(lib, wt, n):
    w = getattr(lib, f"alice_codec_wavelet1d_{wt.name.lower()}")()
    assert w
    sig = np.random.default_rng(n).integers(-1000, 1000, n).astype(np.int32)
    out = sig.copy()
    lib.alice_codec_wavelet1d_forward(w, _i32p(out), n)
    fwd = wavelet.forward_1d(torch.from_numpy(sig), wt)
    np.testing.assert_array_equal(out, fwd.numpy())
    lib.alice_codec_wavelet1d_inverse(w, _i32p(out), n)
    np.testing.assert_array_equal(out, wavelet.inverse_1d(fwd, wt).numpy())
    lib.alice_codec_wavelet1d_destroy(w)


def test_ffi_encode_equals_jax_shim_with_both_loaded(lib, monkeypatch):
    """Both shims export the same 20 symbols; each one's encode reaches its
    own package's helpers, and the bytes are equal."""
    import alice_codec_tpu.ffi.helpers as jhelpers

    jlib = jax_ffi_lib()
    if jlib is None:
        pytest.skip("the JAX package's shim did not build")
    calls = []
    for name, mod in (("torch", helpers), ("jax", jhelpers)):
        def encode(*args, _name=name, _fn=mod.encode):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(mod, "encode", encode)
    rgb = np.random.default_rng(2).integers(0, 256, 8 * 8 * 2 * 3, dtype=np.uint8)
    ours = _shim_encode(lib, rgb, 8, 8, 2)
    assert calls == ["torch"]
    theirs = _shim_encode(jlib, rgb, 8, 8, 2)
    assert calls == ["torch", "jax"]
    assert ours is not None and ours == theirs


def test_ffi_encode_decode_roundtrip(lib):
    rgb = bench._test_chunk(3, 10, 14, seed=4).reshape(-1)
    data = _shim_encode(lib, rgb, 14, 10, 3, quality=85)
    chunk = lib.alice_codec_chunk_from_bytes(_u8p(np.frombuffer(data, np.uint8)),
                                             len(data))
    assert chunk
    assert (lib.alice_codec_chunk_width(chunk), lib.alice_codec_chunk_height(chunk),
            lib.alice_codec_chunk_frames(chunk)) == (14, 10, 3)
    n = ctypes.c_uint32(0)
    ptr = lib.alice_codec_decode(chunk, ctypes.byref(n))
    assert ptr and n.value == rgb.size
    decoded = np.ctypeslib.as_array(ptr, (n.value,)).copy()
    np.testing.assert_array_equal(decoded, FrameDecoder(device="cpu").decode(
        EncodedChunk.from_bytes(data)))
    db = lib.alice_codec_psnr(_u8p(rgb), _u8p(decoded), rgb.size)
    assert abs(db - psnr(rgb, decoded)) < 1e-9
    assert lib.alice_codec_psnr(_u8p(rgb), _u8p(rgb), rgb.size) == float("inf")
    lib.alice_codec_data_free(ptr, n.value)
    lib.alice_codec_chunk_destroy(chunk)


def test_ffi_null_safety_and_invalid_input(lib):
    lib.alice_codec_wavelet1d_destroy(None)
    lib.alice_codec_encoder_destroy(None)
    lib.alice_codec_chunk_destroy(None)
    lib.alice_codec_wavelet1d_forward(None, None, 0)
    assert lib.alice_codec_chunk_width(None) == 0
    assert lib.alice_codec_psnr(None, None, 4) == -1.0
    out_len = ctypes.c_uint32(0)
    assert not lib.alice_codec_decode(None, ctypes.byref(out_len))
    assert not lib.alice_codec_chunk_to_bytes(None, ctypes.byref(out_len))
    assert _shim_encode(lib, np.zeros(10, np.uint8), 8, 8, 2) is None  # wrong size
    bad = np.zeros(4, np.uint8)
    assert not lib.alice_codec_chunk_from_bytes(_u8p(bad), 4)


def test_ffi_without_a_card_returns_null(lib, monkeypatch):
    """The shim's default device is the card: with none, and no CPU request,
    encode returns NULL instead of coding on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rgb = np.zeros(8 * 8 * 2 * 3, np.uint8)
    try:
        assert ffi.get_ffi_lib() is lib
        assert _shim_encode(lib, rgb, 8, 8, 2) is None
    finally:
        ffi.get_ffi_lib(device="cpu")
    assert _shim_encode(lib, rgb, 8, 8, 2) is not None
