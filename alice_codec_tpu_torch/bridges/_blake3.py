"""Compact pure-Python BLAKE3 (hash / keyed / derive-key modes; a copy of
the JAX package's ``bridges/_blake3.py``).

Implements the public BLAKE3 specification (chunked Merkle tree over the
ChaCha-derived compression function).  Used by the crypto bridge for content
hashing and key derivation (reference: src/crypto_bridge.rs:56-68, which
delegates to the external alice-crypto BLAKE3).  Pure Python: correctness
over speed — bitstream hashes are small-metadata operations here.
"""

from __future__ import annotations

import struct

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3
KEYED_HASH = 1 << 4
DERIVE_KEY_CONTEXT = 1 << 5
DERIVE_KEY_MATERIAL = 1 << 6

_BLOCK_LEN = 64
_CHUNK_LEN = 1024
_MASK = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _g(state, a, b, c, d, mx, my):
    state[a] = (state[a] + state[b] + mx) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 7)


def _compress(cv, block_words, counter, block_len, flags):
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & _MASK, (counter >> 32) & _MASK, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _g(state, 0, 4, 8, 12, m[0], m[1])
        _g(state, 1, 5, 9, 13, m[2], m[3])
        _g(state, 2, 6, 10, 14, m[4], m[5])
        _g(state, 3, 7, 11, 15, m[6], m[7])
        _g(state, 0, 5, 10, 15, m[8], m[9])
        _g(state, 1, 6, 11, 12, m[10], m[11])
        _g(state, 2, 7, 8, 13, m[12], m[13])
        _g(state, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[p] for p in MSG_PERMUTATION]
    return [
        state[i] ^ state[i + 8] for i in range(8)
    ] + [state[i + 8] ^ cv[i] for i in range(8)]


def _words(block: bytes) -> list[int]:
    block = block.ljust(_BLOCK_LEN, b"\x00")
    return list(struct.unpack("<16I", block))


class _Output:
    def __init__(self, cv, block_words, counter, block_len, flags):
        self.cv = cv
        self.block_words = block_words
        self.counter = counter
        self.block_len = block_len
        self.flags = flags

    def chaining_value(self):
        return _compress(self.cv, self.block_words, self.counter,
                         self.block_len, self.flags)[:8]

    def root_bytes(self, length: int) -> bytes:
        out = bytearray()
        counter = 0
        while len(out) < length:
            words = _compress(self.cv, self.block_words, counter,
                              self.block_len, self.flags | ROOT)
            out += struct.pack("<16I", *words)
            counter += 1
        return bytes(out[:length])


def _chunk_output(chunk: bytes, key, counter: int, flags: int) -> _Output:
    cv = list(key)
    blocks = [chunk[i : i + _BLOCK_LEN] for i in range(0, max(len(chunk), 1), _BLOCK_LEN)]
    for i, blk in enumerate(blocks[:-1]):
        start = CHUNK_START if i == 0 else 0
        cv = _compress(cv, _words(blk), counter, _BLOCK_LEN, flags | start)[:8]
    last = blocks[-1]
    start = CHUNK_START if len(blocks) == 1 else 0
    return _Output(cv, _words(last), counter, len(last), flags | start | CHUNK_END)


def _parent_output(left_cv, right_cv, key, flags: int) -> _Output:
    return _Output(list(key), left_cv + right_cv, 0, _BLOCK_LEN, flags | PARENT)


def _hash_internal(data: bytes, key, flags: int, out_len: int) -> bytes:
    chunks = [data[i : i + _CHUNK_LEN] for i in range(0, max(len(data), 1), _CHUNK_LEN)]
    outputs = [
        _chunk_output(chunk, key, i, flags) for i, chunk in enumerate(chunks)
    ]
    if len(outputs) == 1:
        return outputs[0].root_bytes(out_len)
    # Merkle tree: the left subtree of each parent is a complete tree.
    cvs = [o.chaining_value() for o in outputs]
    while len(cvs) > 2:
        next_cvs = []
        for i in range(0, len(cvs) - 1, 2):
            next_cvs.append(
                _parent_output(cvs[i], cvs[i + 1], key, flags).chaining_value()
            )
        if len(cvs) % 2 == 1:
            next_cvs.append(cvs[-1])
        cvs = next_cvs
    return _parent_output(cvs[0], cvs[1], key, flags).root_bytes(out_len)


def blake3(data: bytes, *, key: bytes | None = None, out_len: int = 32) -> bytes:
    """BLAKE3 hash (default or keyed mode)."""
    if key is not None:
        if len(key) != 32:
            raise ValueError("key must be 32 bytes")
        kwords = list(struct.unpack("<8I", key))
        return _hash_internal(bytes(data), kwords, KEYED_HASH, out_len)
    return _hash_internal(bytes(data), list(IV), 0, out_len)


def blake3_derive_key(context: str, key_material: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 derive_key mode: context string → context key → derived key."""
    ckey = _hash_internal(context.encode(), list(IV), DERIVE_KEY_CONTEXT, 32)
    kwords = list(struct.unpack("<8I", ckey))
    return _hash_internal(bytes(key_material), kwords, DERIVE_KEY_MATERIAL, out_len)
