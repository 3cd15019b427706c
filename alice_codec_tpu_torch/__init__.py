"""ALICE codec in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``alice_codec_tpu`` (JAX/Pallas on a TPU), which stays the
reference.  This package imports neither JAX nor the JAX package.  It
covers the dense ALC3 roundtrip (:class:`Alc3Codec` with its defaults):
its containers are byte-identical to the JAX package's, and each
package decodes the other's.

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

__all__ = [
    "Alc3Codec",
    "CodecError",
    "DEFAULT_S_SEG",
    "DeviceChunk",
    "DimensionOverflow",
    "InvalidBitstream",
    "InvalidBufferSize",
    "InvalidDimensions",
    "InvalidQuantStep",
    "WaveletType",
    "quality_to_step",
]
