"""Chunk batches, the ALC2 batched container and chunk meshes (the port
of ``alice_codec_tpu/parallel/``)."""

from .batch import (  # noqa: F401
    DEFAULT_LANES,
    BatchFrameDecoder,
    BatchFrameEncoder,
    EncodedChunkStream,
    chunk_frames,
)
from .mesh import chunk_mesh, shard_batch  # noqa: F401
