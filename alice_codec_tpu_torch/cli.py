"""Command-line interface: ``alice-codec-torch encode|decode|info`` (the
port of the JAX package's ``cli.py``, flag for flag, with the same output
text and exit codes).

Flag-for-flag port of the reference CLI (reference: src/bin/main.rs:22-196):
raw interleaved RGB in, `.alc` out, with size/ratio reporting on stderr.

Extensions beyond the reference surface:

* ``--format alc3`` selects the flagship container (with ``--rdo``,
  ``--sparse``, ``--deep``, ``--levels N`` mode flags); ``decode``/``info``
  sniff the magic, so ALC3 files need no flag;
* ``--device`` (``encode`` and ``decode``) names the device the codec runs
  on: the CUDA card by default, where the kernels run; ``--device cpu``
  runs their plain PyTorch versions.  Without a card and without
  ``--device cpu`` the command fails (exit 1): it never codes on the CPU
  unasked.  ``info`` launches nothing and parses on the host.

Run as ``python -m alice_codec_tpu_torch.cli``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ._device import resolve_device
from .errors import CodecError, InvalidBufferSize
from .pipeline import EncodedChunk, FrameDecoder, FrameEncoder

_DEVICE_HELP = ("device to code on: the CUDA card by default; 'cpu' runs the "
                "kernels' plain PyTorch versions")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="alice-codec-torch",
        description="ALICE-Codec (PyTorch/CUDA) — 3D wavelet video codec",
    )
    sub = p.add_subparsers(dest="command", required=True)

    enc = sub.add_parser("encode", help="Encode raw RGB frames to .alc")
    enc.add_argument("input", help="Raw RGB input file (interleaved bytes)")
    enc.add_argument("-o", "--output", required=True, help="Output .alc file")
    enc.add_argument("-W", "--width", type=int, required=True, help="Frame width")
    enc.add_argument("-H", "--height", type=int, required=True, help="Frame height")
    enc.add_argument("-f", "--frames", type=int, default=1, help="Number of frames")
    enc.add_argument("-q", "--quality", type=int, default=90, help="Quality 0-100")
    enc.add_argument(
        "-w", "--wavelet", default="cdf53", choices=["cdf53", "cdf97", "haar"],
        help="Wavelet filter",
    )
    enc.add_argument(
        "--format", default="alc", choices=["alc", "alc3"],
        help="Container: alc (reference-compatible) or alc3 (ALC3 chunks)",
    )
    enc.add_argument("--rdo", action="store_true",
                     help="[alc3] per-sub-band AnalyticalRDO quantization")
    enc.add_argument("--sparse", action="store_true",
                     help="[alc3] significance-bitmap sparse coding")
    enc.add_argument("--deep", action="store_true",
                     help="[alc3] 16-bit symbols (auto at -q 100)")
    enc.add_argument("--levels", type=int, default=1,
                     help="[alc3] dyadic decomposition depth 1-4")
    enc.add_argument(
        "--s-seg", type=int, default=0,
        help="[alc3] segment length in symbol rows (0 = default; smaller "
             "values suit small frames, larger amortize the per-segment "
             "state flush)",
    )
    enc.add_argument(
        "--chunk-size", type=int, default=0,
        help="[alc3] split the input into N-frame chunks (one multi-chunk "
             "container; the last chunk pads by repeating the final frame; "
             "0 = encode all frames as a single chunk)",
    )
    enc.add_argument("--device", default=None, help=_DEVICE_HELP)

    dec = sub.add_parser("decode", help="Decode .alc to raw RGB frames")
    dec.add_argument("input", help="Input .alc file")
    dec.add_argument("-o", "--output", required=True, help="Output raw RGB file")
    dec.add_argument("--device", default=None, help=_DEVICE_HELP)

    info = sub.add_parser("info", help="Print .alc stream info")
    info.add_argument("input", help="Input .alc file")
    return p


def cmd_encode(args) -> int:
    """Reference: src/bin/main.rs:107-145 (+ the ALC3 format extension)."""
    data = Path(args.input).read_bytes()
    if args.format == "alc3":
        from .alc3 import Alc3Codec

        kw = {"s_seg": args.s_seg} if args.s_seg else {}
        codec = Alc3Codec(
            quality=args.quality, wavelet=args.wavelet, rdo=args.rdo,
            sparse=args.sparse, deep=args.deep or None, levels=args.levels,
            device=args.device, **kw,
        )
        n = args.width * args.height * args.frames * 3
        if len(data) != n:
            raise InvalidBufferSize(n, len(data))
        rgb = np.frombuffer(data, np.uint8).reshape(
            args.frames, args.height, args.width, 3
        )
        if args.chunk_size:
            from .parallel.batch import chunk_frames

            # chunk by chunk, as the JAX CLI does (encode_batch's sparse
            # capacity rule differs, and so would the bytes)
            batch, _ = chunk_frames(rgb, args.chunk_size)
            out = Alc3Codec.to_bytes(
                [codec.encode(batch[i]) for i in range(batch.shape[0])]
            )
        else:
            out = Alc3Codec.to_bytes(codec.encode(rgb))
    else:
        encoder = FrameEncoder(quality=args.quality, wavelet=args.wavelet,
                               device=args.device)
        chunk = encoder.encode(
            np.frombuffer(data, np.uint8), args.width, args.height, args.frames
        )
        out = chunk.to_bytes()
    Path(args.output).write_bytes(out)
    raw_size = len(data)
    ratio = raw_size / len(out) if out else 0.0
    print(
        f"encoded {args.width}x{args.height}x{args.frames} "
        f"({raw_size} bytes) -> {len(out)} bytes ({ratio:.2f}x)",
        file=sys.stderr,
    )
    return 0


def cmd_decode(args) -> int:
    """Reference: src/bin/main.rs:147-165 (+ ALC3 magic sniffing)."""
    data = Path(args.input).read_bytes()
    if data[:4] == b"ALC3":
        from .alc3 import Alc3Codec

        codec, chunks = Alc3Codec.from_bytes(data, device=args.device)
        frames = [
            codec.decode(c, exact=codec.deep, as_numpy=True) for c in chunks
        ]
        rgb = np.concatenate(frames, axis=0)
        Path(args.output).write_bytes(rgb.tobytes())
        c0 = chunks[0]
        print(
            f"decoded {c0.width}x{c0.height}x{sum(c.frames for c in chunks)}"
            f" -> {rgb.size} bytes",
            file=sys.stderr,
        )
        return 0
    chunk = EncodedChunk.from_bytes(data)
    rgb = FrameDecoder(device=args.device).decode(chunk)
    Path(args.output).write_bytes(rgb.tobytes())
    print(
        f"decoded {chunk.width}x{chunk.height}x{chunk.frames} -> {rgb.size} bytes",
        file=sys.stderr,
    )
    return 0


def cmd_info(args) -> int:
    """Reference: src/bin/main.rs:167-196 (+ ALC3 magic sniffing)."""
    data = Path(args.input).read_bytes()
    if data[:4] == b"ALC3":
        from .alc3 import Alc3Codec

        codec, chunks = Alc3Codec.from_bytes(data, device="cpu")
        c0 = chunks[0]
        raw = c0.width * c0.height * sum(c.frames for c in chunks) * 3
        payload = sum(c.compressed_size for c in chunks)
        modes = [m for m, on in [("rdo", codec.rdo), ("deep", codec.deep),
                                 ("sparse", codec.sparse)] if on]
        if codec.levels > 1:
            modes.append(f"levels={codec.levels}")
        print(f"container:  ALC3 ({len(chunks)} chunk(s)"
              f"{', ' + ', '.join(modes) if modes else ''})")
        print(f"dimensions: {c0.width}x{c0.height}x{c0.frames}")
        print(f"wavelet:    {c0.wavelet_type.name.lower()}")
        print(f"payload:    {payload} bytes")
        print(f"file size:  {len(data)} bytes")
        print(f"ratio:      {raw / payload if payload else 0.0:.2f}x")
        return 0
    chunk = EncodedChunk.from_bytes(data)
    raw_size = chunk.width * chunk.height * chunk.frames * 3
    payload = chunk.compressed_size
    ratio = raw_size / payload if payload else 0.0
    print(f"dimensions: {chunk.width}x{chunk.height}x{chunk.frames}")
    print(f"wavelet:    {chunk.wavelet}")
    print(f"payload:    {payload} bytes")
    print(f"file size:  {len(data)} bytes")
    print(f"ratio:      {ratio:.2f}x")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command != "info":
        try:
            resolve_device(args.device)
        except RuntimeError as e:  # no card, and no --device cpu
            print(f"error: {e}", file=sys.stderr)
            return 1
    try:
        if args.command == "encode":
            return cmd_encode(args)
        if args.command == "decode":
            return cmd_decode(args)
        return cmd_info(args)
    except CodecError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # stdout consumer closed early (e.g. `alice-codec-torch info x | head`)
        return 0


if __name__ == "__main__":
    sys.exit(main())
