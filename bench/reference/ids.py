"""Chunk ids: the 20-byte SHA-1 digest of the chunk's bytes."""

from __future__ import annotations

import hashlib


def chunk_id(chunk: bytes) -> bytes:
    return hashlib.sha1(chunk).digest()
