"""Whole taptrees in lanes: every leaf's TapLeaf hash from its shard's
midstate and suffix blocks, then every TapBranch level, many trees at
once, keeping of each tree its root and one leaf's path."""

from __future__ import annotations

import torch

from . import hashes as H
from .script import Shard, leaf_suffix_words, tag_midstate

_ROWS = 1 << 21  # lanes a compression call takes at most


def _compress_blocks(state: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    for b in range(words.shape[1] // 16):
        state = H.sha256_compress(state, words[:, 16 * b : 16 * (b + 1)])
    return state


def leaf_digests(shard: Shard, values: torch.Tensor) -> torch.Tensor:
    """(n, 8) TapLeaf digests (SHA-256 words) of the n leaves of a shard,
    values (n, v, limbs) canonical."""
    n = values.shape[0]
    out = torch.empty((n, 8), dtype=torch.int64, device=values.device)
    for r0 in range(0, n, _ROWS):
        vals = values[r0 : r0 + _ROWS]
        idx = torch.arange(r0, r0 + vals.shape[0], dtype=torch.int64, device=values.device)
        state, words = leaf_suffix_words(shard, vals, idx)
        st = torch.tensor(state, dtype=torch.int64, device=values.device).expand(vals.shape[0], 8)
        out[r0 : r0 + vals.shape[0]] = _compress_blocks(st, words)
    return out


_BRANCH_PAD = [0x80000000] + [0] * 14 + [1024]  # the padding block of a 128-byte message


def _branch(a: torch.Tensor, b: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
    """TapBranch digests of (N, 8) pairs, children in byte order."""
    differ = a != b
    first = torch.argmax(differ.to(torch.int8), dim=1, keepdim=True)
    a_low = (torch.gather(a, 1, first) < torch.gather(b, 1, first))[:, 0] | ~differ.any(1)
    lo = torch.where(a_low[:, None], a, b)
    hi = torch.where(a_low[:, None], b, a)
    st = H.sha256_compress(mid.expand(a.shape[0], 8), torch.cat([lo, hi], dim=1))
    pad = torch.tensor(_BRANCH_PAD, dtype=torch.int64, device=a.device).expand(a.shape[0], 16)
    return H.sha256_compress(st, pad)


def roots_and_paths(leaves: list[torch.Tensor], queries: list[int]) -> list[tuple[bytes, list[bytes]]]:
    """For each tree (its (n, 8) leaf digests, n a power of two) its root
    and the path of leaf `queries[t]`, level by level for all trees at
    once."""
    dev = leaves[0].device
    mid = torch.tensor(tag_midstate(b"TapBranch"), dtype=torch.int64, device=dev)
    level = list(leaves)
    paths: list[list[bytes]] = [[] for _ in leaves]
    while True:
        live = [t for t, lv in enumerate(level) if lv.shape[0] > 1]
        if not live:
            break
        for t in live:
            sib = level[t][(queries[t] >> len(paths[t])) ^ 1]
            paths[t].append(H.words_to_bytes(sib.tolist()))
        cat = torch.cat([level[t] for t in live]).view(-1, 2, 8)
        parents = torch.cat([
            _branch(cat[r : r + _ROWS, 0], cat[r : r + _ROWS, 1], mid) for r in range(0, cat.shape[0], _ROWS)
        ])
        pos = 0
        for t in live:
            k = level[t].shape[0] // 2
            level[t] = parents[pos : pos + k]
            pos += k
    return [(H.words_to_bytes(level[t][0].tolist()), paths[t]) for t in range(len(leaves))]
