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

Entry points run on the CUDA card unless given ``device="cpu"``; on the
CPU every kernel is replaced by its plain PyTorch version.
"""

from .alc3 import DEFAULT_S_SEG, Alc3Codec, DeviceChunk
from .core import WaveletType, quality_to_step
from .errors import (
    CodecError,
    DimensionOverflow,
    InvalidBitstream,
    InvalidBufferSize,
    InvalidDimensions,
    InvalidQuantStep,
)
from .ops.rans import (
    FrequencyTable,
    InterleavedRansDecoder,
    InterleavedRansEncoder,
    RansDecoder,
    RansEncoder,
    SimdRansDecoder,
)
from .pipeline import EncodedChunk, FrameDecoder, FrameEncoder
from .streaming import (
    Alc3StreamReader,
    Alc3StreamWriter,
    decode_stream,
    encode_stream,
)

__all__ = [
    "Alc3Codec",
    "Alc3StreamReader",
    "Alc3StreamWriter",
    "CodecError",
    "DEFAULT_S_SEG",
    "DeviceChunk",
    "decode_stream",
    "DimensionOverflow",
    "EncodedChunk",
    "encode_stream",
    "FrameDecoder",
    "FrameEncoder",
    "FrequencyTable",
    "InterleavedRansDecoder",
    "InterleavedRansEncoder",
    "InvalidBitstream",
    "InvalidBufferSize",
    "InvalidDimensions",
    "InvalidQuantStep",
    "quality_to_step",
    "RansDecoder",
    "RansEncoder",
    "SimdRansDecoder",
    "WaveletType",
]
