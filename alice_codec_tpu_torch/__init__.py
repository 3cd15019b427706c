"""ALICE codec in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``alice_codec_tpu`` (JAX/Pallas on a TPU), which stays the
reference.  This package imports neither JAX nor the JAX package.  It
covers the ALC3 chunk codec (:class:`Alc3Codec`) in every mode — dense
or sparse, fixed-step or AnalyticalRDO, 8-bit or deep 16-bit symbols,
1-4 decomposition levels — and the two compat wires: the
reference-compatible single-chunk `.alc` (:class:`FrameEncoder` /
:class:`FrameDecoder`, host rANS) and the batched ALC2
(:mod:`.parallel`: ``BatchFrameEncoder`` / ``BatchFrameDecoder``, N-lane
rANS on the host or the card).  Its containers are byte-identical to the
JAX package's, and each package decodes the other's.  Batches
(``Alc3Codec.encode_batch`` / ``decode_batch``) run one word-rANS launch
each way over the whole batch, optionally over a chunk mesh of several
devices (:mod:`.parallel`: ``chunk_mesh``, ``shard_batch``), and
:mod:`.streaming` pipelines chunk streams and their `.alcs3` files.

Around the codec: quality metrics (:mod:`.metrics`, :mod:`.ssim`, host
f64 and on-device f32), rate control (:mod:`.rate_control`), motion and
chroma segmentation (:mod:`.segment`), the lossless CDF 5/3 transform
(:mod:`.lossless`), the reference-layout wavelets on any size
(:class:`Wavelet1D` / :class:`Wavelet2D` / :class:`Wavelet3D`), the host
quantizers, container probing (:mod:`.container`), presets
(:mod:`.models`) and stage timing (:mod:`.profiling`).

The tools: the command line (:mod:`.cli`, ``alice-codec-torch`` or
``python -m alice_codec_tpu_torch.cli encode|decode|info``), raw-video IO
and the `.alcs` chunk stream (:mod:`.utils`), the bridges (:mod:`.bridges`:
ternary ML inference, the decoded-frame cache, the metrics time series,
sealing and BLAKE3) and the C ABI shim of the Unity / UE5 wrappers
(:mod:`.ffi`, built at first use).  With them the port covers every
module of the JAX package.

Entry points run on the CUDA card unless given ``device="cpu"``; on the
CPU every kernel is replaced by its plain PyTorch version.
"""

import numpy as np
import torch

from .alc3 import DEFAULT_S_SEG, Alc3Codec, DeviceChunk
from .core import (
    DEFAULT_CHUNK_SIZE,
    VERSION,
    SubBand3D,
    WaveletType,
    quality_to_step,
)
from .errors import (
    CodecError,
    DimensionOverflow,
    InvalidBitstream,
    InvalidBufferSize,
    InvalidDimensions,
    InvalidQuantStep,
)
from .lossless import LosslessEncoder, verify_roundtrip_1d, verify_roundtrip_2d
from .metrics import mse, psnr
from .ops import color as _color
from .ops.quant import (
    AnalyticalRDO,
    FastQuantizer,
    Quantizer,
    build_histogram,
    dequantize_subband,
    from_symbols,
    quantize_subband,
    to_symbols,
)
from .ops.rans import (
    FrequencyTable,
    InterleavedRansDecoder,
    InterleavedRansEncoder,
    RansDecoder,
    RansEncoder,
    SimdRansDecoder,
)
from .ops.wavelet import Wavelet1D, Wavelet2D, Wavelet3D
from .pipeline import EncodedChunk, FrameDecoder, FrameEncoder
from .rate_control import RateControlConfig, RateController, estimate_quality
from .segment import (
    SegmentConfig,
    SegmentResult,
    crop_bbox_numpy,
    crop_to_bbox,
    paste_bbox_numpy,
    paste_from_bbox,
    rle_encode_numpy,
    segment_by_chroma,
    segment_by_motion,
    segment_chroma_numpy,
    segment_motion_numpy,
)
from .ssim import ms_ssim, ssim
from .streaming import (
    Alc3StreamReader,
    Alc3StreamWriter,
    decode_stream,
    encode_stream,
)


def version() -> str:
    """Library version (reference: src/python.rs:274-277)."""
    return VERSION


def rgb_to_ycocg_r_numpy(rgb_bytes):
    """Interleaved RGB bytes → planar (y, co, cg) int16 NumPy arrays
    (host; mirror of the reference binding, src/python.rs:497-530)."""
    flat = np.asarray(rgb_bytes, np.uint8).reshape(-1)
    if flat.size % 3 != 0:
        raise InvalidBufferSize((flat.size // 3 + 1) * 3, flat.size)
    y, co, cg = _color.rgb_to_ycocg_r(torch.from_numpy(flat.reshape(-1, 3)))
    return y.numpy(), co.numpy(), cg.numpy()


def ycocg_r_to_rgb_numpy(y, co, cg):
    """Planar (y, co, cg) int16 → interleaved RGB uint8 NumPy array (host;
    mirror of the reference binding, src/python.rs:543-583)."""
    y = np.asarray(y, np.int16).reshape(-1)
    co = np.asarray(co, np.int16).reshape(-1)
    cg = np.asarray(cg, np.int16).reshape(-1)
    if y.size != co.size or y.size != cg.size:
        raise InvalidBufferSize(y.size, min(co.size, cg.size))
    rgb = _color.ycocg_r_to_rgb(*(torch.from_numpy(c) for c in (y, co, cg)))
    return rgb.numpy().reshape(-1)


__version__ = VERSION

__all__ = [
    "Alc3Codec",
    "Alc3StreamReader",
    "Alc3StreamWriter",
    "AnalyticalRDO",
    "CodecError",
    "DEFAULT_CHUNK_SIZE",
    "DEFAULT_S_SEG",
    "DeviceChunk",
    "DimensionOverflow",
    "EncodedChunk",
    "FastQuantizer",
    "FrameDecoder",
    "FrameEncoder",
    "FrequencyTable",
    "InterleavedRansDecoder",
    "InterleavedRansEncoder",
    "InvalidBitstream",
    "InvalidBufferSize",
    "InvalidDimensions",
    "InvalidQuantStep",
    "LosslessEncoder",
    "Quantizer",
    "RansDecoder",
    "RansEncoder",
    "RateControlConfig",
    "RateController",
    "SimdRansDecoder",
    "SegmentConfig",
    "SegmentResult",
    "SubBand3D",
    "VERSION",
    "Wavelet1D",
    "Wavelet2D",
    "Wavelet3D",
    "WaveletType",
    "build_histogram",
    "crop_bbox_numpy",
    "crop_to_bbox",
    "decode_stream",
    "dequantize_subband",
    "encode_stream",
    "estimate_quality",
    "from_symbols",
    "ms_ssim",
    "mse",
    "paste_bbox_numpy",
    "paste_from_bbox",
    "psnr",
    "quality_to_step",
    "quantize_subband",
    "rgb_to_ycocg_r_numpy",
    "rle_encode_numpy",
    "segment_by_chroma",
    "segment_by_motion",
    "segment_chroma_numpy",
    "segment_motion_numpy",
    "ssim",
    "to_symbols",
    "verify_roundtrip_1d",
    "verify_roundtrip_2d",
    "version",
    "ycocg_r_to_rgb_numpy",
]
