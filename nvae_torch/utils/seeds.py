"""Generator seeds derived from a run's seed and a position in the run."""

from __future__ import annotations

import hashlib


def derive_seed(*parts) -> int:
    """The first 8 bytes, little-endian, of the BLAKE2b digest of the parts
    joined by ``":"`` (integers in decimal, strings as they are), masked to
    63 bits.  A pure function of the parts, so any draw can be replayed, and
    distinct tags (``"eval"``, ``"data"``, ...) give unrelated streams."""
    text = ":".join(str(p) if isinstance(p, str) else str(int(p))
                    for p in parts)
    digest = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)
