"""SHA-256 helpers: BIP-340/341 tagged hashes for the taptree.

Reference parity: rust-bitcoin TapNodeHash/TapLeafHash tagged hashing
(used by the taptree builder, tap-stark's basic/src/tcs/builder.rs:26-64):
    tagged_hash(tag, m) = sha256(sha256(tag) || sha256(tag) || m)
    TapLeaf  hash: tag "TapLeaf",  m = leaf_version || compact_size(len) || script
    TapBranch hash: tag "TapBranch", m = min(h1,h2) || max(h1,h2)
"""

from __future__ import annotations

import functools
import hashlib

TAPSCRIPT_LEAF_VERSION = 0xC0


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


@functools.lru_cache(maxsize=None)
def _tag_midstate(tag: bytes) -> bytes:
    t = sha256(tag)
    return t + t


def tagged_hash(tag: bytes, msg: bytes) -> bytes:
    return sha256(_tag_midstate(tag) + msg)


def compact_size(n: int) -> bytes:
    if n < 0xFD:
        return bytes([n])
    if n <= 0xFFFF:
        return b"\xfd" + n.to_bytes(2, "little")
    if n <= 0xFFFFFFFF:
        return b"\xfe" + n.to_bytes(4, "little")
    return b"\xff" + n.to_bytes(8, "little")


def tapleaf_hash(script: bytes, leaf_version: int = TAPSCRIPT_LEAF_VERSION) -> bytes:
    return tagged_hash(
        b"TapLeaf", bytes([leaf_version]) + compact_size(len(script)) + script
    )


def tapbranch_hash(a: bytes, b: bytes) -> bytes:
    lo, hi = (a, b) if a <= b else (b, a)
    return tagged_hash(b"TapBranch", lo + hi)
