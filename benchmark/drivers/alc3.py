"""The driver of ALC3 configurations (``"driver": "alc3"``): the port's
``Alc3Codec``, built from the configuration's ``codec`` keywords and
decoding with its ``decode`` keys.

A driver module (``benchmark/drivers/<driver>.py``) gives the harness:

* ``DECODE_KEYS``: the keys of the configuration's ``decode`` it reads
  (any other is refused before a run);
* ``Driver(config, device)``: the codec under test, whose ``encode`` /
  ``decode`` serve the chunk loop (one (T, H, W, 3) uint8 chunk) and
  ``encode_batch`` / ``decode_batch`` the batch loop (the pool stacked to
  (B, T, H, W, 3)).  What the encodes return is opaque to the harness; it
  only hands it back to the driver:
* ``samples(inputs, coded, out)``: a roundtrip's units to judge, as
  (input, coded, decoded) triples for the configuration's reference;
* ``held(coded)``: the device tensors one judged unit's coded part holds,
  which the harness takes off the window's memory peak;
* ``summaries(coded)``: what the roofline needs of a roundtrip's chunks,
  read without a device synchronization, one a chunk; and ``work(s)``,
  a summary's work item (``bytes(wrapper)``, ``per_chunk``), read once
  the profile has been taken.
"""

from __future__ import annotations

from types import SimpleNamespace

#: the keys of a configuration's ``decode``: ``Alc3Codec.decode``'s
DECODE_KEYS = frozenset({"exact"})


class Driver:
    """``Alc3Codec(**config["codec"])`` on ``device``; a batch's coded form
    is ``encode_batch``'s list of chunks."""

    def __init__(self, config: dict, device: str):
        from alice_codec_tpu_torch import Alc3Codec

        self.codec = Alc3Codec(**config["codec"], device=device)
        self.exact = bool(config["decode"]["exact"])

    def encode(self, x):
        return self.codec.encode(x)

    def decode(self, chunk):
        return self.codec.decode(chunk, exact=self.exact)

    def encode_batch(self, batch):
        return self.codec.encode_batch(batch)

    def decode_batch(self, chunks):
        return self.codec.decode_batch(chunks, exact=self.exact)

    @staticmethod
    def samples(inputs, coded, out) -> list:
        """One (input, chunk, frames) triple a chunk."""
        if isinstance(coded, list):
            return list(zip(inputs, coded, out.unbind(0)))
        return [(inputs[0], coded, out)]

    @staticmethod
    def held(chunk) -> tuple:
        return (chunk.streams, chunk.counts, chunk.hists)

    @staticmethod
    def summaries(coded) -> list[SimpleNamespace]:
        """What :meth:`work` needs of each coded chunk, read without a
        device synchronization (its counts stay a tensor)."""
        return [SimpleNamespace(width=c.width, height=c.height, frames=c.frames,
                                s_seg=c.s_seg, n_streams=int(c.streams.shape[0]),
                                counts=c.counts, kcaps=tuple(c.kcaps),
                                sparse=c.sparse, deep=c.deep)
                for c in (coded if isinstance(coded, list) else [coded])]

    @staticmethod
    def work(c: SimpleNamespace):
        """A chunk summary's :class:`roofline.ChunkWork` (reads its counts)."""
        import torch

        from reference.alc3_plain import padded_dims, segment_geometry, sparse_pp
        from roofline import ChunkWork

        pw, ph, pf = padded_dims(c.width, c.height, c.frames)
        p = pw * ph * pf
        pp = sparse_pp(p)
        dense = segment_geometry(pp, c.s_seg)[1]
        lifted = sum(1 for k in c.kcaps[:3] if k > 0) if c.sparse and not c.deep else 3
        return ChunkWork(p=p, pp=pp, s_seg=c.s_seg, n_streams=c.n_streams,
                         words=int(c.counts.to(torch.int64).sum().item()),
                         channels=lifted or 1,
                         sparse_planes=sum(1 for k in c.kcaps if 0 < k < dense))
