"""The driver of ALC2 batch configurations (``"driver": "alc2"``): the
port's ``BatchFrameEncoder`` built from the configuration's ``codec``
keywords and its ``BatchFrameDecoder`` from its ``decode`` keys, the
pool coded as one multi-chunk ALC2 stream a roundtrip.  It gives what
``drivers/alc3.py``'s docstring lists; the coded form of a roundtrip is
the :class:`EncodedChunkStream`, host bytes and header fields.

ALC2 codes batches only: the chunk loop is refused.
"""

from __future__ import annotations

from types import SimpleNamespace

#: the keys of a configuration's ``decode``: ``BatchFrameDecoder``'s
#: ``device_entropy`` and ``decode``'s ``exact``
DECODE_KEYS = frozenset({"device_entropy", "exact"})
BATCH_ONLY = ("the ALC2 driver codes batches only: its cells take a traffic mix "
              "with \"loop\": \"batch\"")


class Driver:
    """``BatchFrameEncoder(**config["codec"])`` and
    ``BatchFrameDecoder(device_entropy=...)`` on ``device``."""

    def __init__(self, config: dict, device: str):
        from alice_codec_tpu_torch.parallel import BatchFrameDecoder, BatchFrameEncoder

        dec = config["decode"]
        self.enc = BatchFrameEncoder(**config["codec"], device=device)
        self.dec = BatchFrameDecoder(device_entropy=bool(dec["device_entropy"]),
                                     device=device)
        self.exact = bool(dec["exact"])

    def encode(self, chunk):
        raise ValueError(BATCH_ONLY)

    def decode(self, coded):
        raise ValueError(BATCH_ONLY)

    def encode_batch(self, batch):
        return self.enc.encode(batch)

    def decode_batch(self, stream):
        return self.dec.decode(stream, exact=self.exact, as_numpy=False)

    @staticmethod
    def samples(inputs, stream, out) -> list:
        """One judged unit a batch: (the pool's chunks, the stream, the
        frames)."""
        return [(list(inputs), stream, out)]

    @staticmethod
    def held(stream) -> tuple:
        return ()                   # the stream is host bytes

    @staticmethod
    def summaries(stream) -> list[SimpleNamespace]:
        """One summary a chunk, from the stream's header and lane table."""
        return [SimpleNamespace(width=stream.width, height=stream.height,
                                frames=stream.frames, n_lanes=stream.n_lanes,
                                payload=int(stream.lane_lens[ci].sum()))
                for ci in range(stream.n_chunks)]

    @staticmethod
    def work(s: SimpleNamespace):
        """A chunk summary's :class:`alc2_work.Alc2Work`."""
        from alc2_work import Alc2Work
        from reference.alc2_nway_plain import lane_sym_count
        from reference.alc3_plain import padded_dims

        pw, ph, pf = padded_dims(s.width, s.height, s.frames)
        p = pw * ph * pf
        return Alc2Work(p=p, n_sym=lane_sym_count(p, s.n_lanes), n_lanes=s.n_lanes,
                        payload=s.payload)
