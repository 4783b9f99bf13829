"""Taptree commit hashing where the matrices' tensors live (the port of
`tapstark.commit.device_commit`): leaf-tail construction and SHA-256.

- every leaf script of a shard is head || tail(i) || NOP-pad to one fixed
  length, so the SHA-256 midstate through the multi-KB head is ONE host
  computation per (repetition, shard) and only the 1-2 tail blocks hash
  per leaf;
- the tail bytes (minimal-CScriptNum value pushes + FROMALTSTACK/
  EQUALVERIFY pairs + index push + OP_1) are DATA-DEPENDENT in length, so
  each slot's bytes are scattered at cumsum offsets — byte-exact with
  script.builder.push_int;
- tails are repetition-independent: the suffix words are built once and
  every repetition's tapleaf compressions run from its own head midstate;
  the same launch hashes the first TapBranch levels above the leaves in
  shared memory (`tapleaf_subtrees`, K5's counterpart), so no level below
  the fourth reaches device memory;
- the TapBranch levels above it hash in natural node order, several per
  launch (`tapbranch_levels`, K6's counterpart); only the root and the
  levels >= the cutoff are kept (the sparse layout of
  native.tcs_commit_sparse_native, so openings reuse the host leaf-block
  rebuild);
- the kept levels and the padding matrix stay where they were made
  (`DeviceUppers`, `DeviceValues`): an opening copies its path and its
  2^cutoff-row leaf block, and the FRI prover copies every opening's in
  one copy.

On a CUDA tensor the hashing runs on the card's kernels, on a CPU tensor
through their plain versions. The suffix builder is plain torch on both.
The reference's names for its hash layer (`compress_batch`,
`compress_batch_wm`, `sha256`, `tapbranch_fused_wm`) are the port's, and
`bitrev_rows_dev` is `poly.ntt.bit_reverse_rows`.

Reference anchor: the num_queries-cloned tree commit this re-architects is
tap-stark's basic/src/tcs/mod.rs:197-292.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.device import from_mont
from ..hashes.sha256 import compact_size, sha256  # noqa: F401 (the reference's names)
from ..hashes.sha256_device import (  # noqa: F401 (compress_batch*, tapbranch_fused_wm: the reference's names)
    BRANCH_LEVELS,
    LEAF_LEVELS,
    compress_batch,
    compress_batch_wm,
    tag_midstate_words,
    tapbranch_fused_wm,
    tapbranch_levels,
    tapleaf_subtrees,
)
from ..poly.ntt import bit_reverse_rows
from ..script import opcodes as op

_OP_FROMALT = op.OP_FROMALTSTACK
_OP_EQV = op.OP_EQUALVERIFY
_OP_1 = op.OP_1
_OP_NOP = op.OP_NOP

# bytes of one tail slot: push opcode, up to 4 CScriptNum data bytes,
# FROMALTSTACK, EQUALVERIFY and, on the index slot, OP_1
_SLOT_BYTES = 8


def bitrev_rows_dev(x: torch.Tensor, log_n: int) -> torch.Tensor:
    """y[p] = x[brv(p)] along axis 0 of a 2^log_n-row tensor, where it lies."""
    if x.shape[0] != 1 << log_n:
        raise ValueError(f"bitrev_rows_dev: {x.shape[0]} rows, expected 2^{log_n}")
    return bit_reverse_rows(x)


def _pack_words_np(bytes_arr: np.ndarray) -> np.ndarray:
    """(..., 4*W) uint8 -> (..., W) uint32 big-endian words."""
    b = bytes_arr.astype(np.uint32)
    return (
        (b[..., 0::4] << np.uint32(24))
        | (b[..., 1::4] << np.uint32(16))
        | (b[..., 2::4] << np.uint32(8))
        | b[..., 3::4]
    )


class ShardSuffixPlan:
    """Host-side layout plan for one shard's tapleaf hashing: where the tail
    starts inside the SHA stream and the constant padding."""

    def __init__(self, head_len: int, fixed_len: int, leaf_version: int = 0xC0):
        self.head_len = head_len
        self.fixed_len = fixed_len
        cs = compact_size(fixed_len)
        self.pre_script = bytes([leaf_version]) + cs
        # bytes before the tail in the full tagged-hash stream
        before = 64 + len(self.pre_script) + head_len
        self.full_blocks = before // 64
        self.rem_len = before % 64
        self.tail_span = fixed_len - head_len
        total_msg = 64 + len(self.pre_script) + fixed_len
        suf_payload = self.rem_len + self.tail_span + 9
        self.n_suffix_blocks = -(-suf_payload // 64)
        suf_bytes = self.n_suffix_blocks * 64
        pad = np.zeros(suf_bytes, dtype=np.uint8)
        pe = self.rem_len + self.tail_span
        pad[pe] = 0x80
        bitlen = total_msg * 8
        pad[suf_bytes - 8 :] = np.frombuffer(
            int(bitlen).to_bytes(8, "big"), dtype=np.uint8
        )
        self.pad_words = _pack_words_np(pad)
        self.suf_words = suf_bytes // 4

    def head_midstates_batch(self, heads: list[bytes]):
        """All repetitions at once: (R, 8) SHA midstates after every full
        block through each head (host SHA-NI: a few KB x R messages), plus
        (R, suf_words) leftover head bytes packed as zero-padded suffix
        words."""
        r = len(heads)
        msgs = [self.pre_script + h for h in heads]
        full = (len(msgs[0]) + 64) // 64 * 64 - 64
        assert all(len(m) == len(msgs[0]) for m in msgs)
        tag_state = tag_midstate_words(b"TapLeaf")
        from .. import native

        if full:
            states = native.sha256_midstates_native([m[:full] for m in msgs], tag_state)
        else:
            states = np.broadcast_to(tag_state, (r, 8))
        rems = np.zeros((r, self.suf_words * 4), dtype=np.uint8)
        for i, m in enumerate(msgs):
            rem = m[full:]
            assert len(rem) == self.rem_len
            rems[i, : len(rem)] = np.frombuffer(rem, dtype=np.uint8)
        return np.ascontiguousarray(states), _pack_words_np(rems)


def padding_matrix_dev(matrices) -> torch.Tensor:
    """Twin of tcs.padding_matrix_np over the matrices' `dev` tensors
    (Montgomery int32): (N, K, L) canonical int32 where they live."""
    largest_first = sorted(matrices, key=lambda m: -m.height)
    max_h = largest_first[0].height
    cols = []
    for m in largest_first:
        v = from_mont(m.dev)
        if not m.ext:
            v = v[..., None]
        rep = max_h // v.shape[0]
        cols.append(v.repeat_interleave(rep, dim=0) if rep > 1 else v)
    return torch.cat(cols, dim=1)


# leaves per pass of the suffix builder: its (S, 8, N) temporaries take ~100
# bytes per slot and leaf (~12 GB in one pass over a 2^24-leaf shard)
_SUFFIX_CHUNK_LEAVES = 1 << 20


def build_tail_suffix_words(
    values_shard: torch.Tensor, plan: ShardSuffixPlan, base_index: int = 0
) -> torch.Tensor:
    """values_shard (N, K, L) canonical int32 -> WORD-MAJOR (suf_words, N)
    int32: the repetition-independent part of each leaf's suffix blocks
    (rem region zeroed, SHA padding included), leaf n committing index
    base_index + n. Built _SUFFIX_CHUNK_LEAVES leaves at a time."""
    n = values_shard.shape[0]
    out = torch.empty((plan.suf_words, n), dtype=torch.int32, device=values_shard.device)
    for c0 in range(0, n, _SUFFIX_CHUNK_LEAVES):
        c1 = min(c0 + _SUFFIX_CHUNK_LEAVES, n)
        out[:, c0:c1] = _suffix_words_pass(values_shard[c0:c1], plan, base_index + c0)
    return out


def _suffix_words_pass(values_shard: torch.Tensor, plan: ShardSuffixPlan, base_index: int) -> torch.Tensor:
    """`build_tail_suffix_words` over one chunk of leaves.

    Everything is slot-major (S, N), so the cumsum runs across slots. Each
    slot (values reversed, limbs in order, then the index) is at most 8
    bytes; one scatter along the byte axis places every slot's bytes at its
    cumsum offset in an OP_NOP-filled tail, and the bytes pack into
    big-endian words."""
    dev = values_shard.device
    n, k, l = values_shard.shape
    slot_vals = values_shard.flip(1).reshape(n, k * l).T.to(torch.int32)
    idx = base_index + torch.arange(n, dtype=torch.int32, device=dev)
    v = torch.cat([slot_vals, idx[None, :]])  # (S, n); the last slot is the index
    s = v.shape[0]
    zero = v == 0
    small = (v >= 1) & (v <= 16)
    ndata = 1 + (v >= 0x80).int() + (v >= 0x8000).int() + (v >= 0x800000).int()
    enc = torch.where(zero | small, 1, 1 + ndata)
    first = torch.where(zero, 0, torch.where(small, _OP_1 - 1 + v, ndata))
    extra = torch.full((s, 1), 2, dtype=torch.int32, device=dev)
    extra[-1] = 3  # FROMALT + EQV (+ OP_1 on the index slot)
    slot_len = enc + extra
    starts = torch.cumsum(slot_len, dim=0, dtype=torch.int32) - slot_len  # (S, n)

    # byte p of every slot: push opcode, data bytes (v >> 8(p-1)), FROMALT,
    # EQV, OP_1; positions past the slot go to a junk row
    p = torch.arange(_SLOT_BYTES, dtype=torch.int32, device=dev)[:, None]  # (8, 1)
    shift = (8 * (p - 1)).clamp(0, 24)
    e = enc[:, None]  # (S, 1, n)
    byte = torch.where(
        p == 0,
        first[:, None],
        torch.where(
            p < e,
            (v[:, None] >> shift) & 0xFF,
            torch.where(p == e, _OP_FROMALT, torch.where(p == e + 1, _OP_EQV, _OP_1)),
        ),
    )  # (S, 8, n)
    suf_bytes = plan.suf_words * 4
    pos = torch.where(p < slot_len[:, None], plan.rem_len + starts[:, None] + p, suf_bytes)
    buf = torch.zeros((suf_bytes + 1, n), dtype=torch.uint8, device=dev)
    buf[plan.rem_len : plan.rem_len + plan.tail_span] = _OP_NOP
    buf.scatter_(0, pos.reshape(s * _SLOT_BYTES, n).long(), byte.reshape(s * _SLOT_BYTES, n).to(torch.uint8))
    b = buf[:suf_bytes].view(plan.suf_words, 4, n).int()
    pad = torch.from_numpy(plan.pad_words.view(np.int32).copy()).to(dev)
    return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3] | pad[:, None]


def shard_trees_rep_group(
    suffix_words: torch.Tensor, midstates: np.ndarray, rem_words: np.ndarray, cutoff: int
):
    """A group of repetitions of one shard: suffix (W, N) word-major where
    the tree is hashed, midstates (R, 8) and rem_words (R, W) uint32 on the
    host. Returns (roots (R, 8), uppers (R, T, 8)) int32 digest words on
    suffix_words' device: uppers concatenates levels l in [cutoff, depth)
    (level l has N >> l nodes) in natural node order along T.

    Levels cutoff..depth (the root last) are written into one (8, R, T + 1)
    buffer: the leaf launch hashes up to LEAF_LEVELS levels, a TapBranch
    launch takes the rest up to the cutoff (writing the cutoff level only),
    then one launch per BRANCH_LEVELS levels writes every level up to the
    root."""
    dev = suffix_words.device
    n = suffix_words.shape[1]
    if n & (n - 1):
        raise ValueError(f"shard_trees_rep_group: {n} leaves is not a power of two")
    mids = torch.from_numpy(np.ascontiguousarray(midstates.T).view(np.int32)).to(dev)
    rem = torch.from_numpy(np.ascontiguousarray(rem_words.T).view(np.int32)).to(dev)
    r = mids.shape[1]
    depth = max((n - 1).bit_length(), 0)
    offs = np.cumsum([0] + [n >> l for l in range(cutoff, depth + 1)]).tolist()  # level cutoff + i at offs[i]
    buf = torch.empty((8, r, offs[-1]), dtype=torch.int32, device=dev)

    def cols(lo: int, hi: int) -> torch.Tensor:  # levels lo..hi of the buffer
        return buf[:, :, offs[lo - cutoff] : offs[hi - cutoff + 1]]

    first = min(LEAF_LEVELS, cutoff)
    if first == cutoff:
        tapleaf_subtrees(mids, suffix_words, rem, first, out=cols(cutoff, cutoff))
    else:
        below = tapleaf_subtrees(mids, suffix_words, rem, first)
        tapbranch_levels(below, cutoff - first, cutoff - first, out=cols(cutoff, cutoff))
    for l in range(cutoff, depth, BRANCH_LEVELS):
        top = min(l + BRANCH_LEVELS, depth)
        tapbranch_levels(cols(l, l), top - l, out=cols(l + 1, top))
    return buf[:, :, -1].T, buf[:, :, :-1].permute(1, 2, 0)


def roots_to_bytes(roots_np: np.ndarray) -> list[bytes]:
    """(R, 8) uint32 root words -> R x 32-byte big-endian root hashes."""
    return [
        np.ascontiguousarray(roots_np[r].astype(">u4")).tobytes()
        for r in range(roots_np.shape[0])
    ]


def to_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """int32 tensors of one device -> uint32 numpy arrays of their shapes, in
    ONE device-to-host copy: flattened and concatenated where they live,
    copied into one pinned buffer on the card (a plain copy on the CPU)."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if flat.device.type == "cuda":
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat)
    else:
        host = flat
    words = host.numpy().view(np.uint32)
    sizes = np.cumsum([t.numel() for t in tensors])[:-1]
    return [a.reshape(t.shape) for a, t in zip(np.split(words, sizes), tensors)]


def shard_trees_rep_group_async(
    suffix_words: torch.Tensor, midstates: np.ndarray, rem_words: np.ndarray, cutoff: int
):
    """`shard_trees_rep_group` with nothing copied to the host: returns
    (roots (R, 8) on the card, DeviceUppers over the kept levels). The
    caller copies the roots of every rep-group of a commit in one copy
    (or, in the FRI commit phase, hands them to the device transcript
    chain first); openings gather their paths from the DeviceUppers."""
    n = suffix_words.shape[1]
    roots, uppers = shard_trees_rep_group(suffix_words, midstates, rem_words, cutoff)
    return roots, DeviceUppers(uppers, n, cutoff)


def _upper_offsets(n: int, cutoff: int) -> list[int]:
    """Offset along T of each kept level l in [cutoff, depth) in the
    concatenated uppers (level l holds n >> l nodes)."""
    depth = max((n - 1).bit_length(), 0)
    return np.cumsum([0] + [n >> l for l in range(cutoff, depth)])[:-1].tolist()


def _nodes_to_bytes(nodes: np.ndarray) -> list[bytes]:
    """(L, 8) uint32 big-endian digest words -> L x 32-byte hashes."""
    b = np.ascontiguousarray(nodes.astype(">u4")).view(np.uint8).reshape(-1, 32)
    return [bytes(row) for row in b]


class DeviceUppers:
    """The kept levels of one shard's rep-group, left where they were hashed.

    An opening reads depth - cutoff sibling nodes of one repetition (each
    repetition's tree serves one FRI query), so copying whole levels to the
    host moves ~32 B · n / 2^cutoff per repetition for ~32 B · log n.
    Openings gather their path where the levels live instead; the FRI
    prover plans every query's gathers and copies them in one
    (`tcs.materialize_path_plans`)."""

    def __init__(self, flat: torch.Tensor, n: int, cutoff: int):
        self.flat = flat  # (R, T, 8) int32, levels in natural node order along T
        self.n = n
        self.cutoff = cutoff
        self.depth = max((n - 1).bit_length(), 0)
        self.offsets = _upper_offsets(n, cutoff)
        self._offs = torch.tensor(self.offsets, dtype=torch.int64).to(flat.device)
        self._levels = torch.arange(cutoff, self.depth, dtype=torch.int64).to(flat.device)

    def view(self, rep: int) -> "DeviceUppersPath":
        return DeviceUppersPath(self, rep)

    def gather(self, rep: int, i: int) -> torch.Tensor:
        """(depth - cutoff, 8) sibling nodes of leaf i's path, gathered where
        the levels live: level l's sibling is node ((i >> l) ^ 1) of it (the
        port's levels are in natural order; the JAX package's are
        bit-reversed)."""
        nodes = self._offs + ((i >> self._levels) ^ 1)
        return self.flat[rep].index_select(0, nodes)


class DeviceUppersPath:
    """One repetition's path accessor, the `upper_levels` of a
    SparseNativeTaptree: plan(i) gathers leaf i's siblings above the
    cutoff without copying them, materialize(i, words) takes the copy,
    path_bytes(i) returns them (gathered and copied alone if unplanned)."""

    def __init__(self, group: DeviceUppers, rep: int):
        self._g = group
        self._rep = rep
        self._pending: dict[int, torch.Tensor] = {}
        self._cache: dict[int, list[bytes]] = {}

    def plan(self, i: int) -> torch.Tensor | None:
        """The gather of leaf i's path (on the card, not yet copied), or None
        when it is planned or copied already or the tree keeps no level."""
        if i in self._cache or i in self._pending or not self._g.offsets:
            return None
        h = self._pending[i] = self._g.gather(self._rep, i)
        return h

    def materialize(self, i: int, words: np.ndarray) -> None:
        self._pending.pop(i, None)
        self._cache[i] = _nodes_to_bytes(words)

    def path_bytes(self, i: int) -> list[bytes]:
        if i not in self._cache:
            if not self._g.offsets:
                return []
            h = self._pending.pop(i, None)
            if h is None:
                h = self._g.gather(self._rep, i)
            self._cache[i] = _nodes_to_bytes(to_host([h])[0])
        return self._cache[i]


class DeviceValues:
    """A commit's canonical padding matrix (N, K, L) int32, kept where it was
    built through the openings. An opening reads one 2^cutoff-row block
    per (query, commit): the rows its leaf-block rebuild hashes, the opened
    row among them. plan_tuple(i) names that block (a slice, not yet
    copied); the FRI prover copies every planned block and path in one
    (`tcs.materialize_path_plans`). `full()` copies the whole matrix, a
    fallback no prove takes: `full_calls` counts it."""

    full_calls = 0

    def __init__(self, vals: torch.Tensor, cutoff: int):
        self.dev = vals
        self.n = int(vals.shape[0])
        self.block = min(1 << cutoff, self.n) if self.n else 1
        self._pending: dict[int, torch.Tensor] = {}
        self._cache: dict[int, np.ndarray] = {}
        self._full: np.ndarray | None = None

    def _base(self, i: int) -> int:
        return (int(i) // self.block) * self.block

    def plan_tuple(self, i: int):
        """(self, base, block) for `tcs.materialize_path_plans`, or None when
        the block of row i is planned or copied already."""
        base = self._base(i)
        if self._full is not None or base in self._cache or base in self._pending:
            return None
        h = self._pending[base] = self.dev[base : base + self.block]
        return (self, base, h)

    def materialize(self, base: int, words: np.ndarray) -> None:
        self._pending.pop(base, None)
        self._cache[base] = words

    def _block(self, base: int) -> np.ndarray:
        if self._full is not None:
            return self._full[base : base + self.block]
        if base not in self._cache:
            h = self._pending.pop(base, None)
            if h is None:
                h = self.dev[base : base + self.block]
            self._cache[base] = to_host([h])[0]
        return self._cache[base]

    def full(self) -> np.ndarray:
        """The whole matrix on the host (counted in `full_calls`)."""
        if self._full is None:
            DeviceValues.full_calls += 1
            self._full = to_host([self.dev])[0]
        return self._full

    def __getitem__(self, k):
        if isinstance(k, (int, np.integer)):
            base = self._base(k)
            return self._block(base)[int(k) - base]
        return self.full()[k]

    def shard(self, lo: int, hi: int) -> "DeviceValuesShard":
        return DeviceValuesShard(self, lo, hi)


class DeviceValuesShard:
    """Columns [lo, hi) of a DeviceValues, the `values_shard` of a
    SparseNativeTaptree: a row, or a slice inside one block, comes from
    that block; anything else from `full()`."""

    def __init__(self, dv: DeviceValues, lo: int, hi: int):
        self._dv = dv
        self._lo, self._hi = lo, hi

    def __getitem__(self, k):
        if isinstance(k, slice) and k.step is None:
            start = k.start or 0
            base = self._dv._base(start)
            if k.stop is not None and k.stop <= base + self._dv.block:
                blk = self._dv._block(base)
                return np.ascontiguousarray(blk[start - base : k.stop - base, self._lo : self._hi])
        if isinstance(k, (int, np.integer)):
            return self._dv[k][self._lo : self._hi]
        return np.ascontiguousarray(self._dv.full()[k, self._lo : self._hi])
