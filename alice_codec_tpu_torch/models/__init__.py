"""Codec model presets: named encode configurations.

The reference exposes its operating points informally (wavelet choice ×
quality × rate control — README.md usage recipes); this module names them
as reusable presets for the scalar and batched pipelines (PyTorch port of
``alice_codec_tpu/models``).
"""

from .presets import (  # noqa: F401
    CodecPreset,
    PRESETS,
    ARCHIVAL,
    LOSSLESS,
    REALTIME,
    STREAMING,
    get_preset,
)
