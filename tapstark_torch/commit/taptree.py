"""Taproot leaf openings: the opened leaf and its inclusion check.

Behavioral port of the reference's taproot hashing (tap-stark's
basic/src/tcs/builder.rs, complete_taptree.rs, on rust-bitcoin):

- leaf hash = tagged_hash("TapLeaf", 0xc0 || compact_size(len) || script)
- branch hash = tagged_hash("TapBranch", min(h1,h2) || max(h1,h2))

The trees themselves are built by the native engine or the CUDA kernels
(commit/tcs.py); their openings are `LeafNode`s.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..hashes.sha256 import tapbranch_hash, tapleaf_hash


@dataclass
class LeafNode:
    script: bytes
    leaf_hash: bytes
    merkle_branch: list[bytes] = field(default_factory=list)


def verify_inclusion(root_hash: bytes, leaf: LeafNode) -> bool:
    h = leaf.leaf_hash
    if leaf.leaf_hash != tapleaf_hash(leaf.script):
        return False
    for sibling in leaf.merkle_branch:
        h = tapbranch_hash(h, sibling)
    return h == root_hash
