"""Error hierarchy for the PyTorch port of the ALICE codec.

Mirrors the five error variants of the reference ``CodecError`` enum
(reference: src/error.rs:12-23) as a Python exception hierarchy.  All
public APIs that can fail raise a subclass of :class:`CodecError`.
"""

from __future__ import annotations


class CodecError(ValueError):
    """Base class for all codec errors (reference: src/error.rs:12)."""


class InvalidBufferSize(CodecError):
    """Input buffer size does not match the declared dimensions.

    Reference: src/error.rs:14 (``InvalidBufferSize { expected, got }``).
    """

    def __init__(self, expected: int, got: int):
        self.expected = expected
        self.got = got
        super().__init__(f"buffer size mismatch: expected {expected}, got {got}")


class InvalidDimensions(CodecError):
    """Width or height is zero (reference: src/error.rs:16)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        super().__init__(f"invalid dimensions: {width}x{height}")


class DimensionOverflow(CodecError):
    """Dimensions overflow when multiplied together (reference: src/error.rs:18)."""

    def __init__(self) -> None:
        super().__init__("dimensions overflow usize")


class InvalidBitstream(CodecError):
    """The compressed bitstream is malformed or truncated (reference: src/error.rs:20)."""

    def __init__(self, msg: str):
        self.msg = msg
        super().__init__(f"invalid bitstream: {msg}")


class InvalidQuantStep(CodecError):
    """Quantization step size is not positive (reference: src/error.rs:22)."""

    def __init__(self, step: int):
        self.step = step
        super().__init__(f"quantization step must be positive, got {step}")
