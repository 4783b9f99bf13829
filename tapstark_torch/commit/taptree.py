"""Taproot script-tree with ordered combination and index bookkeeping, and
the leaf openings' inclusion check.

Behavioral port of the reference's TreeBuilder / CompleteTaptree
(tap-stark's basic/src/tcs/builder.rs, complete_taptree.rs) and the
rust-bitcoin taproot hashing it relies on:

- leaf hash = tagged_hash("TapLeaf", 0xc0 || compact_size(len) || script)
- branch hash = tagged_hash("TapBranch", min(h1,h2) || max(h1,h2))
- `combine_with_order`: children are physically ordered by hash
  (lexicographic), and the builder tracks the induced logical→physical leaf
  permutation (builder.rs:38-93).

The commits' trees are built by the native engine or the CUDA kernels
(commit/tcs.py), and their openings are `LeafNode`s. `build_taptree` and
`combine_taptrees` are library API beside them: no commit calls them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..hashes.sha256 import tapbranch_hash, tapleaf_hash


@dataclass
class LeafNode:
    script: bytes
    leaf_hash: bytes
    merkle_branch: list[bytes] = field(default_factory=list)


@dataclass
class NodeInfo:
    hash: bytes
    leaves: list[LeafNode]

    @staticmethod
    def new_leaf(script: bytes) -> "NodeInfo":
        h = tapleaf_hash(script)
        return NodeInfo(hash=h, leaves=[LeafNode(script=script, leaf_hash=h)])


def combine_with_order(a: NodeInfo, b: NodeInfo) -> tuple[NodeInfo, bool]:
    """Combine two nodes; returns (parent, left_first) where left_first means
    a's leaves stay physically before b's (a.hash <= b.hash)."""
    for leaf in a.leaves:
        leaf.merkle_branch.append(b.hash)
    for leaf in b.leaves:
        leaf.merkle_branch.append(a.hash)
    left_first = a.hash <= b.hash
    leaves = a.leaves + b.leaves if left_first else b.leaves + a.leaves
    return NodeInfo(hash=tapbranch_hash(a.hash, b.hash), leaves=leaves), left_first


class CompleteTaptree:
    def __init__(self, root: NodeInfo, leaf_indices: list[int]):
        self.root_node = root
        self.leaf_indices = leaf_indices  # logical index -> physical position

    @property
    def root_hash(self) -> bytes:
        return self.root_node.hash

    def root_words(self) -> list[int]:
        """Root as 8 LE u32 words (TreeRoot, taptree_mmcs.rs:17,105-111)."""
        h = self.root_node.hash
        return [int.from_bytes(h[4 * i : 4 * i + 4], "little") for i in range(8)]

    def leaf_count(self) -> int:
        return len(self.root_node.leaves)

    def get_tapleaf(self, logical_index: int) -> LeafNode:
        return self.root_node.leaves[self.leaf_indices[logical_index]]


def verify_inclusion(root_hash: bytes, leaf: LeafNode) -> bool:
    h = leaf.leaf_hash
    if leaf.leaf_hash != tapleaf_hash(leaf.script):
        return False
    for sibling in leaf.merkle_branch:
        h = tapbranch_hash(h, sibling)
    return h == root_hash


def build_taptree(scripts: list[bytes]) -> CompleteTaptree:
    """Build a complete (power-of-two) taptree over the scripts in logical
    order, tracking the hash-ordering permutation."""
    n = len(scripts)
    assert n > 0 and (n & (n - 1)) == 0, "leaf count must be a power of two"
    working = [NodeInfo.new_leaf(s) for s in scripts]
    # physical position -> logical (merkle) index
    t_to_m = list(range(n))
    start_sizes = [1] * n
    while len(working) > 1:
        nxt: list[NodeInfo] = []
        nxt_sizes: list[int] = []
        a_start = 0
        for k in range(0, len(working), 2):
            a, b = working[k], working[k + 1]
            a_size, b_size = start_sizes[k], start_sizes[k + 1]
            parent, left_first = combine_with_order(a, b)
            if not left_first:
                seg = t_to_m[a_start : a_start + a_size + b_size]
                t_to_m[a_start : a_start + a_size + b_size] = (
                    seg[a_size:] + seg[:a_size]
                )
            nxt.append(parent)
            nxt_sizes.append(a_size + b_size)
            a_start += a_size + b_size
        working = nxt
        start_sizes = nxt_sizes
    leaf_indices = [0] * n
    for pos, m_idx in enumerate(t_to_m):
        leaf_indices[m_idx] = pos
    return CompleteTaptree(working[0], leaf_indices)


def combine_taptrees(a: CompleteTaptree, b: CompleteTaptree) -> CompleteTaptree:
    """Combine two complete taptrees into one, preserving logical indexing
    (a's leaves keep indices 0..len(a)-1, b's follow; reference
    complete_taptree.rs:96-133 combine semantics)."""
    import copy

    ra = copy.deepcopy(a.root_node)
    rb = copy.deepcopy(b.root_node)
    parent, left_first = combine_with_order(ra, rb)
    if left_first:
        indices = list(a.leaf_indices) + [
            p + a.leaf_count() for p in b.leaf_indices
        ]
    else:
        indices = [p + b.leaf_count() for p in a.leaf_indices] + list(
            b.leaf_indices
        )
    return CompleteTaptree(parent, indices)
