"""Ecosystem bridges: ML inference, metrics DB, crypto sealing, frame cache
(the port of the JAX package's ``bridges/``).

Native equivalents of the reference's feature-gated bridges to its sibling
crates (reference: src/ml_bridge.rs, src/db_bridge.rs, src/crypto_bridge.rs,
src/cache_bridge.rs) — here always available, no external dependencies
(sealing needs the ``cryptography`` package, imported only when it runs).
"""

from . import cache, crypto, db, ml  # noqa: F401
