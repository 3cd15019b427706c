"""Chunk batches and the ALC2 batched container (the port of
``alice_codec_tpu/parallel/``; mesh sharding is not ported yet)."""

from .batch import (  # noqa: F401
    DEFAULT_LANES,
    BatchFrameDecoder,
    BatchFrameEncoder,
    EncodedChunkStream,
    chunk_frames,
)
