"""Crypto bridge: AEAD sealing for encoded bitstreams (a copy of the JAX
package's ``bridges/crypto.py``: each package opens the other's seals).

Re-implements the reference crypto bridge (reference: src/crypto_bridge.rs):
XChaCha20-Poly1305 with the wire format ``[nonce 24B][ciphertext][tag 16B]``,
BLAKE3 content hashing and BLAKE3 derive-key.

XChaCha20 is built as HChaCha20(key, nonce[:16]) → ChaCha20-Poly1305 with a
zero-prefixed 12-byte nonce (the standard construction), on top of the
``cryptography`` package.  BLAKE3 is the pure-Python implementation in
``_blake3.py``.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

from ._blake3 import blake3, blake3_derive_key

__all__ = [
    "CipherError",
    "Key",
    "Hash",
    "SealedBitstream",
    "seal_bitstream",
    "open_bitstream",
    "content_hash",
    "derive_key",
    "seal",
    "open_sealed",
    "hash_data",
]

_NONCE_LEN = 24
_TAG_LEN = 16


class CipherError(Exception):
    """AEAD operation failure (wrong key, tampered data, bad sizes)."""


@dataclass(frozen=True)
class Key:
    """32-byte symmetric key (reference alice-crypto ``Key``)."""

    _bytes: bytes

    def __post_init__(self):
        if len(self._bytes) != 32:
            raise CipherError("key must be 32 bytes")

    @classmethod
    def generate(cls) -> "Key":
        return cls(os.urandom(32))

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Key":
        return cls(bytes(raw))

    def as_bytes(self) -> bytes:
        return self._bytes


@dataclass(frozen=True)
class Hash:
    """BLAKE3 digest wrapper."""

    _bytes: bytes

    def as_bytes(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()


@dataclass
class SealedBitstream:
    """Encrypted bitstream (reference src/crypto_bridge.rs:15-24).

    Format: ``[nonce 24B][ciphertext][tag 16B]``.
    """

    data: bytes
    plaintext_len: int


# ── XChaCha20-Poly1305 construction ─────────────────────────────

_CHACHA_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """HChaCha20: 20-round ChaCha core, returns words 0-3 and 12-15."""
    state = list(_CHACHA_CONSTANTS)
    state += list(struct.unpack("<8I", key))
    state += list(struct.unpack("<4I", nonce16))

    def quarter(s, a, b, c, d):
        s[a] = (s[a] + s[b]) & 0xFFFFFFFF
        s[d] = _rotl(s[d] ^ s[a], 16)
        s[c] = (s[c] + s[d]) & 0xFFFFFFFF
        s[b] = _rotl(s[b] ^ s[c], 12)
        s[a] = (s[a] + s[b]) & 0xFFFFFFFF
        s[d] = _rotl(s[d] ^ s[a], 8)
        s[c] = (s[c] + s[d]) & 0xFFFFFFFF
        s[b] = _rotl(s[b] ^ s[c], 7)

    for _ in range(10):
        quarter(state, 0, 4, 8, 12)
        quarter(state, 1, 5, 9, 13)
        quarter(state, 2, 6, 10, 14)
        quarter(state, 3, 7, 11, 15)
        quarter(state, 0, 5, 10, 15)
        quarter(state, 1, 6, 11, 12)
        quarter(state, 2, 7, 8, 13)
        quarter(state, 3, 4, 9, 14)

    return struct.pack("<8I", *(state[0:4] + state[12:16]))


def _xchacha_cipher(key: bytes, nonce24: bytes):
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

    subkey = _hchacha20(key, nonce24[:16])
    nonce12 = b"\x00\x00\x00\x00" + nonce24[16:24]
    return ChaCha20Poly1305(subkey), nonce12


def seal(key: Key, plaintext: bytes) -> bytes:
    """Encrypt: returns ``nonce(24) || ciphertext || tag(16)``."""
    nonce = os.urandom(_NONCE_LEN)
    cipher, nonce12 = _xchacha_cipher(key.as_bytes(), nonce)
    ct = cipher.encrypt(nonce12, bytes(plaintext), None)  # ct||tag
    return nonce + ct


def open_sealed(key: Key, data: bytes) -> bytes:
    """Decrypt the output of :func:`seal`."""
    if len(data) < _NONCE_LEN + _TAG_LEN:
        raise CipherError("sealed data too short")
    nonce = data[:_NONCE_LEN]
    cipher, nonce12 = _xchacha_cipher(key.as_bytes(), nonce)
    try:
        return cipher.decrypt(nonce12, bytes(data[_NONCE_LEN:]), None)
    except Exception as e:  # InvalidTag
        raise CipherError("decryption failed (wrong key or tampered data)") from e


def seal_bitstream(plaintext: bytes, key: Key) -> SealedBitstream:
    """Encrypt a compressed bitstream (reference src/crypto_bridge.rs:34-42)."""
    return SealedBitstream(data=seal(key, plaintext), plaintext_len=len(plaintext))


def open_bitstream(sealed: SealedBitstream, key: Key) -> bytes:
    """Decrypt a sealed bitstream (reference src/crypto_bridge.rs:47-49)."""
    return open_sealed(key, sealed.data)


def content_hash(data: bytes) -> Hash:
    """BLAKE3 content hash (reference src/crypto_bridge.rs:56-58)."""
    return Hash(blake3(bytes(data)))


def hash_data(data: bytes) -> Hash:
    """Alias matching the alice-crypto ``hash`` function name."""
    return content_hash(data)


def derive_key(context: str, passphrase: bytes) -> Key:
    """BLAKE3 key derivation (reference src/crypto_bridge.rs:65-68)."""
    return Key.from_bytes(blake3_derive_key(context, bytes(passphrase)))
