"""TCS — the taptree commitment scheme over polynomial evaluation matrices.

Behavioral port of tap-stark's basic/src/tcs/mod.rs:

- `padding_matrix` interleaves all matrices' rows into per-evaluation-point
  leaves: matrices sorted by descending height; a row of a height-2^k matrix
  is replicated into the 2^(log_max - k) leaves it covers (mod.rs:339-378).
- Each leaf is a Tapscript that verifies Winternitz signatures for
  (query index, every evaluation limb) and checks them against the values
  embedded as constants (CommitedLeaf::generate_script role, mod.rs:197-226).
  Layout redesign (constant-head): all locks run FIRST, parking recovered
  values on the altstack; a short variable tail pops and EQUALVERIFYs them,
  NOP-padded to a shard-wide fixed length. This makes the tapleaf-hash
  preimage prefix (tag block, leaf version, compact_size, all lock bytes)
  identical across leaves, so committing hashes a shared midstate plus ~2
  SHA-256 blocks per leaf instead of the multi-KB lock bytes per leaf.
- A commitment is the taptree root; `commit_poly_with_query_times` commits
  `num_queries` independent trees with FRESH bit-commitment assignments
  (one-time-signature hygiene per query repetition, mod.rs:284-292).
- verify = taptree inclusion + executing the leaf script with the
  signature witness (mod.rs:140-144, 423-434).

The bulk work (leaf-script assembly, tapleaf hashing, ordered tree build)
runs in the native C++ engine (tapstark_torch.native) — the role the
reference fills with native Rust; a failed engine build raises.
Matrices that carry a torch tensor hash their trees where the tensor lives
instead (commit/device_commit.py: the CUDA kernels on the card, their plain
versions on the CPU), and their leaf values and upper tree levels stay
there: an opening copies its leaf block and path, and the FRI prover plans
every opening's and copies them in one (`materialize_path_plans`). Leaf
scripts are reconstructed lazily for openings.

Matrices are numpy arrays of CANONICAL u32 limbs: base field (h, w),
extension field (h, w, 4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..hashes.sha256 import compact_size, sha256
from ..script import opcodes as op
from ..script.builder import push_int
from ..utils import log2_ceil  # noqa: F401 (the reference's name)
from ..utils.profiling import span
from .bitcomm import (
    COMMIT_TYPE_U128,
    COMMIT_TYPE_U32,
    BcManager,
    BitCommitment,
)
from .taptree import LeafNode, verify_inclusion


class FMatrix:
    """Canonical-u32 matrix: (h, w) base or (h, w, 4) extension.

    `dev` optionally carries the same matrix as a torch tensor of Montgomery
    words (int32), on any device: a commit of matrices that all carry one
    hashes its trees where that tensor lives (commit/device_commit.py). The
    canonical host copy is fetched from it on first use when not given, or,
    for `FMatrix.lazy`, started at once and joined on first use."""

    def __init__(self, values: np.ndarray | None = None, dev=None):
        if values is None and dev is None:
            raise ValueError("FMatrix needs host values or a device tensor")
        self._values = values
        self.dev = dev
        self._copy = None  # (pinned host tensor, CUDA event) of a lazy copy

    @classmethod
    def lazy(cls, dev: torch.Tensor) -> "FMatrix":
        """A matrix whose canonical host copy starts now: on the card a
        non-blocking copy into pinned host memory, joined (its event
        synchronized) at `.values`; on the CPU a plain copy."""
        from ..field.device import fetch_canonical, from_mont

        m = cls(dev=dev)
        if dev.device.type != "cuda":
            m._values = fetch_canonical(dev)
            return m
        canon = from_mont(dev)
        host = torch.empty(canon.shape, dtype=canon.dtype, pin_memory=True)
        host.copy_(canon, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev.device))
        m._copy = (host, done)
        return m

    @property
    def values(self) -> np.ndarray:
        if self._values is None:
            if self._copy is not None:
                host, done = self._copy
                done.synchronize()
                self._values, self._copy = host.numpy().view(np.uint32), None
            else:
                from ..field.device import fetch_canonical

                self._values = fetch_canonical(self.dev)
        return self._values

    @property
    def _shape(self):
        return self._values.shape if self._values is not None else self.dev.shape

    @property
    def ext(self) -> bool:
        return len(self._shape) == 3

    @property
    def height(self) -> int:
        return int(self._shape[0])

    @property
    def width(self) -> int:
        return int(self._shape[1])

    def row_limbs(self, r: int) -> list[list[int]]:
        """Row as a list of per-value limb lists."""
        if self.ext:
            return [[int(x) for x in self.values[r, j]] for j in range(self.width)]
        return [[int(self.values[r, j])] for j in range(self.width)]


@dataclass
class UseBComm:
    index_bc: BitCommitment
    evaluations_bc: list[BitCommitment]


@dataclass
class CommitedProof:
    leaf: LeafNode
    use_bcs: UseBComm
    query_index: int


# Bitcoin Tapscript caps the combined stack+altstack at 1000 elements during
# execution; each committed u32's witness is 20 items (10 digit signatures +
# 10 digit values) plus the index commitment's 20. Leaves wider than this
# bound are split column-wise into multiple taptrees ("shards"), each with
# its own index/eval bit-commitments and its own root, so every leaf script
# executes within consensus limits. The reference does NOT do this — its
# wide-table README rows are flagged as estimates for exactly this reason
# (tap-stark's README.md:90).
MAX_LEAF_VALUES = 40


def shard_bounds(num_values: int) -> list[tuple[int, int]]:
    """Balanced contiguous column ranges, each of size <= MAX_LEAF_VALUES."""
    if num_values <= MAX_LEAF_VALUES:
        return [(0, num_values)]
    k = -(-num_values // MAX_LEAF_VALUES)
    base, rem = divmod(num_values, k)
    bounds = []
    lo = 0
    for s in range(k):
        hi = lo + base + (1 if s < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


@dataclass
class ShardedCommitedProof:
    """Opening of one leaf across the column shards of a wide commitment
    (one CommitedProof per shard, same query index)."""

    shards: list[CommitedProof]

    @property
    def query_index(self) -> int:
        return self.shards[0].query_index


def padding_matrix_np(matrices: list[FMatrix]) -> np.ndarray:
    """(num_leaves, num_values, num_limbs) canonical u32 interleaved leaves
    (vectorized reference padding_matrix, mod.rs:339-378)."""
    largest_first = sorted(matrices, key=lambda m: -m.height)
    max_height = largest_first[0].height
    num_limbs = 4 if largest_first[0].ext else 1
    cols = []
    for m in largest_first:
        v = m.values
        if not m.ext:
            v = v[:, :, None]
        rep = max_height // m.height
        cols.append(np.repeat(v, rep, axis=0))
    return np.concatenate(cols, axis=1).astype(np.uint32)


def padding_matrix(matrices: list[FMatrix]) -> list[list[list[int]]]:
    """Reference-shaped view: leaf -> value -> limbs (tests/compat)."""
    arr = padding_matrix_np(matrices)
    return [
        [[int(x) for x in arr[i, j]] for j in range(arr.shape[1])]
        for i in range(arr.shape[0])
    ]


def _leaf_head(index_lock_parked: bytes, eval_locks_parked: list[bytes]) -> bytes:
    """Constant head shared by every leaf of a (repetition, shard): all
    Winternitz locks run first, parking the recovered index + limbs on the
    altstack (index deepest; value K-1 limb 0 on top)."""
    return index_lock_parked + b"".join(eval_locks_parked)


def _leaf_tail(index: int, row: np.ndarray) -> bytes:
    """Variable tail: pop each parked limb and EQUALVERIFY it against the
    claimed value pushed as a minimal-encoded constant. Pops come in reverse
    park order: value K-1 limb 0 first ... value 0 limb n-1, index last."""
    pop_eqv = bytes([op.OP_FROMALTSTACK, op.OP_EQUALVERIFY])
    parts = []
    for limbs in row[::-1]:
        for v in limbs:
            parts.append(push_int(int(v)))
            parts.append(pop_eqv)
    parts.append(push_int(index))
    parts.append(pop_eqv)
    parts.append(bytes([op.OP_1]))
    return b"".join(parts)


def _max_tail_len(num_values: int, num_limbs: int) -> int:
    """Upper bound on the tail: each push is <= 5 bytes (values and indices
    are < 2^31) plus FROMALTSTACK + EQUALVERIFY, then OP_1."""
    return (num_values * num_limbs + 1) * 7 + 1


def _head_align_pad(head_len: int, tail_span: int) -> int:
    """OP_NOP bytes appended to the constant head so each leaf's variable
    SHA-256 suffix spans the fewest 64-byte blocks.

    Head bytes are FREE per leaf — the tagged-hash midstate over (tag block
    || leaf_version || compact_size || head) is computed once per
    (repetition, shard) — while suffix blocks are hashed PER LEAF (device
    scan kernel / host SHA-NI). Aligning the midstate remainder
    rem = (len(pre_script) + head_len) % 64 toward 0 drops
    ceil((rem + tail_span + 9) / 64) by one block for most shard shapes:
    e.g. the north-star trace shard (tail_span 22) goes from 2 suffix
    compressions per leaf to 1. compact_size(fixed_len) can change width
    as the pad grows, so each candidate recomputes it."""
    best_d, best_b = 0, None
    for d in range(64):
        hl = head_len + d
        pre = 1 + len(compact_size(hl + tail_span))
        rem = (pre + hl) % 64
        b = -(-(rem + tail_span + 9) // 64)
        if best_b is None or b < best_b:
            best_b, best_d = b, d
    return best_d


def _leaf_script_from_row(
    head: bytes, fixed_len: int, index: int, row: np.ndarray
) -> bytes:
    """Assemble one leaf script: constant head || variable tail || OP_NOP
    padding to the shard-wide fixed length.

    The fixed length makes the compact_size prefix of the tapleaf hash —
    and therefore the SHA-256 midstate over (tag block || leaf_version ||
    compact_size || head) — identical across all leaves of a shard, so
    per-leaf hashing is ~2 compressions instead of rehashing the multi-KB
    lock bytes (reference rehashes the whole script per leaf,
    basic/src/tcs/mod.rs:197-226)."""
    tail = _leaf_tail(index, row)
    pad = fixed_len - len(head) - len(tail)
    assert pad >= 0
    return head + tail + bytes([op.OP_NOP]) * pad


# openings rebuild a 2^LEVEL_CUTOFF-leaf block (a few hundred SHA-256
# compressions); the commit stores only level hashes >= the cutoff
# (~n/2^LEVEL_CUTOFF entries instead of ~2n).
LEVEL_CUTOFF = 8

# rep-group size of a device commit, in (repetition, leaf) lanes. Leaf
# digests and the levels below the fourth stay in shared memory
# (device_commit.shard_trees_rep_group), so a lane holds 2 B of level 4
# (32 B per 16 leaves) and ~0.25 B of the kept levels (cutoff 8 up to the
# root): 2^30 lanes peak at ~2.4 GB, 3 % of an 80 GB H100, beside the
# group's shared suffix words. The 2^22 and 2^23 proves' 28 repetitions of
# 2^24 and 2^25 leaves are one group; the 2^24 of the JAX package was sized
# for a 16 GB TPU.
_DEVICE_GROUP_LANES = 1 << 30


def device_commit_will_serve(height: int, device) -> bool:
    """True when a commit of `height` leaves whose matrices carry tensors on
    `device` hashes where they lie (`_commit_device`) and serves its leaf
    values from there. The port's rule takes that path whenever every
    matrix holds a tensor, on the card or on the CPU, whatever the height;
    host matrices (device None) take the native engine."""
    if device is None:
        return False
    if height < 1:
        raise ValueError(f"device_commit_will_serve: {height} leaves")
    return torch.device(device).type in ("cpu", "cuda")


_TREE_POOL = None


def _tree_pool():
    """Persistent thread pool for native tree builds: worker threads (and
    their reusable native scratch buffers) survive across commits — fresh
    scratch every commit would re-fault GBs of pages per prove."""
    global _TREE_POOL
    if _TREE_POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        _TREE_POOL = ThreadPoolExecutor(os.cpu_count() or 4)
    return _TREE_POOL


class SparseNativeTaptree:
    """Memory-lean taptree: the native commit returns only the root and the
    level hash arrays at or above LEVEL_CUTOFF; leaf hashes and bottom
    levels are recomputed per opened query from the shard's values (the
    branch arrays are position-indexed — the BIP-341 lexicographic pair sort
    affects only each parent's preimage order, so no permutation bookkeeping
    exists; verification re-sorts per step)."""

    def __init__(self, root, upper_levels, num_leaves, head, fixed_len, values_shard):
        self.root_hash = root
        self._upper = upper_levels  # [L_cutoff, ..., L_{depth-1}]
        self._n = num_leaves
        self._head = head
        self._fixed_len = fixed_len
        self._values = values_shard

    def root_words(self) -> list[int]:
        return [
            int.from_bytes(self.root_hash[4 * i : 4 * i + 4], "little")
            for i in range(8)
        ]

    def leaf_count(self) -> int:
        return self._n

    def _script_fn(self, i: int) -> bytes:
        return _leaf_script_from_row(
            self._head, self._fixed_len, i, self._values[i]
        )

    def plan_path(self, logical_index: int):
        """A tree whose levels stay on the card (DeviceUppersPath): gather
        the path above the cutoff without copying it, for
        `materialize_path_plans`. Returns (path view, index, gathered
        tensor), or None (host trees, or the path planned already)."""
        plan = getattr(self._upper, "plan", None)
        if plan is None:
            return None
        h = plan(logical_index)
        return (self._upper, logical_index, h) if h is not None else None

    def get_tapleaf(self, logical_index: int) -> LeafNode:
        from .. import native

        i = logical_index
        depth = max((self._n - 1).bit_length(), 0)
        cutoff = min(LEVEL_CUTOFF, depth)
        block_n = 1 << cutoff
        base = (i >> cutoff) << cutoff
        sub = native.tcs_leaf_block_native(
            self._head,
            self._fixed_len,
            self._values[base : base + block_n],
            base,
            sha256(b"TapLeaf"),
            sha256(b"TapBranch"),
        )
        branch = [
            bytes(sub[l][(((i - base) >> l) ^ 1)]) for l in range(cutoff)
        ]
        path_bytes = getattr(self._upper, "path_bytes", None)
        if path_bytes is not None:  # levels on the card: one path's gather
            branch.extend(path_bytes(i))
        else:
            for l in range(cutoff, depth):
                branch.append(bytes(self._upper[l - cutoff][(i >> l) ^ 1]))
        return LeafNode(
            script=self._script_fn(i),
            leaf_hash=bytes(sub[0][i - base]),
            merkle_branch=branch,
        )


@dataclass
class CommitedData:
    leaves: list[FMatrix]
    trees: list  # one SparseNativeTaptree per column shard
    use_bcs_list: list[UseBComm]  # one per shard
    bounds: list[tuple[int, int]]  # column range per shard
    values_np: "np.ndarray"  # or device_commit.DeviceValues (left on the card)

    @property
    def commit_taptree(self):
        assert len(self.trees) == 1, "sharded commitment has no single tree"
        return self.trees[0]

    @property
    def use_bcs(self) -> UseBComm:
        assert len(self.use_bcs_list) == 1
        return self.use_bcs_list[0]

    def root_words(self) -> list[int]:
        """Concatenated 8-word LE roots of every shard tree."""
        out: list[int] = []
        for t in self.trees:
            out.extend(t.root_words())
        return out

    def get_max_height(self) -> int:
        return max(m.height for m in self.leaves)

    def leaf_limbs(self, i: int) -> list[list[int]]:
        return [[int(x) for x in v] for v in self.values_np[i]]

    def plan_query(self, query_index: int) -> list:
        """The gathers an opening of `query_index` reads, for
        `materialize_path_plans`: its leaf block where the values stay on
        the card (DeviceValues) and its path in every shard tree whose
        levels stay there. Host-built commits plan nothing."""
        plans = []
        plan_vals = getattr(self.values_np, "plan_tuple", None)
        if plan_vals is not None:
            p = plan_vals(query_index)
            if p is not None:
                plans.append(p)
        for tree in self.trees:
            p = tree.plan_path(query_index)
            if p is not None:
                plans.append(p)
        return plans

    def query_proof(self, query_index: int):
        proofs = [
            CommitedProof(
                leaf=tree.get_tapleaf(query_index),
                use_bcs=use_bcs,
                query_index=query_index,
            )
            for tree, use_bcs in zip(self.trees, self.use_bcs_list)
        ]
        if len(proofs) == 1:
            return proofs[0]
        return ShardedCommitedProof(shards=proofs)


class DeferredDeviceCommit:
    """A commit hashed where its matrices live whose roots have not been
    copied: one (R_g, 8) root tensor per (shard, rep-group), in dispatch
    order. The FRI prover's device transcript chain reads them where they
    are (challenger/device_tail.py); `finalize` builds the CommitedData
    list from their copy, which the prover makes once for every deferred
    layer (fri/prover.py, flush)."""

    def __init__(self, root_handles: list, num_shards: int, finalize_fn):
        self.root_handles = root_handles
        self.num_shards = num_shards
        self._finalize = finalize_fn
        self._done = None

    @property
    def num_groups(self) -> int:
        return len(self.root_handles)

    def roots_rep_order_dev(self) -> torch.Tensor:
        """(R, 8) root words of every repetition in order (a one-shard
        commit's rep-groups follow the repetitions)."""
        if self.num_shards != 1:
            raise ValueError("a sharded commit has no single root order")
        if len(self.root_handles) == 1:
            return self.root_handles[0]
        return torch.cat(self.root_handles)

    def finalize(self, fetched: list) -> list[CommitedData]:
        """fetched: the (R_g, 8) uint32 root words of each rep-group."""
        if self._done is None:
            self._done = self._finalize(fetched)
        return self._done


def materialize_path_plans(plans: list) -> None:
    """Copy every planned gather (`CommitedData.plan_query`: leaf blocks and
    paths) to the host in ONE copy, and hand each view its words."""
    from .device_commit import to_host

    for (view, key, _), words in zip(plans, to_host([h for _, _, h in plans])):
        view.materialize(key, words)


def _leaf_witness(use_bcs: UseBComm, index: int, values: list[list[int]]) -> list[bytes]:
    """Witness: evaluation signatures in reverse bc order, then the index
    signature on top (mod.rs:173-182)."""
    from .winternitz import N0, sign_many, to_digits

    wins, msgs = [], []
    for bc, limbs in zip(reversed(use_bcs.evaluations_bc), reversed(values)):
        bc.set_values(list(limbs))
        for c in bc.commitments:
            wins.append(c.winternitz)
            msgs.append(to_digits(c.value, N0))
    use_bcs.index_bc.set_values([index])
    for c in use_bcs.index_bc.commitments:
        wins.append(c.winternitz)
        msgs.append(to_digits(c.value, N0))
    out: list[bytes] = []
    for items in sign_many(wins, msgs):
        out.extend(items)
    return out


class TCS:
    def __init__(self, manager: BcManager):
        self.manager = manager

    def _assign_locks(self, num_values: int, ext: bool):
        """Deterministic (sequential) bit-commitment assignment + the shard's
        constant leaf head and fixed script length."""
        commit_type = COMMIT_TYPE_U128 if ext else COMMIT_TYPE_U32
        index_bc = self.manager.assign_bc(COMMIT_TYPE_U32)
        evaluations_bc = self.manager.assign_bcs(commit_type, num_values)
        use_bcs = UseBComm(index_bc=index_bc, evaluations_bc=evaluations_bc)
        index_lock = index_bc.locking_script_parked().build()
        eval_locks = [bc.locking_script_parked().build() for bc in evaluations_bc]
        head = _leaf_head(index_lock, eval_locks)
        num_limbs = 4 if ext else 1
        tail_span = _max_tail_len(num_values, num_limbs)
        # SHA-block alignment: NOP-pad the (midstate-absorbed, per-leaf-free)
        # head so the per-leaf suffix covers the fewest compression blocks
        head = head + bytes([op.OP_NOP]) * _head_align_pad(len(head), tail_span)
        fixed_len = len(head) + tail_span
        return use_bcs, head, fixed_len

    def _build_shard(self, values_shard, use_bcs, head, fixed_len):
        from .. import native

        num_leaves = values_shard.shape[0]
        depth = max((num_leaves - 1).bit_length(), 0)
        root, upper = native.tcs_commit_sparse_native(
            head,
            fixed_len,
            values_shard,
            sha256(b"TapLeaf"),
            sha256(b"TapBranch"),
            min(LEVEL_CUTOFF, depth),
        )
        return SparseNativeTaptree(root, upper, num_leaves, head, fixed_len, values_shard)

    def _build(self, matrices, values_np, shard_args, bounds):
        trees = []
        use_list = []
        for (use_bcs, head, fixed_len), (lo, hi) in zip(shard_args, bounds):
            vs = np.ascontiguousarray(values_np[:, lo:hi])
            trees.append(self._build_shard(vs, use_bcs, head, fixed_len))
            use_list.append(use_bcs)
        return CommitedData(
            leaves=matrices,
            trees=trees,
            use_bcs_list=use_list,
            bounds=bounds,
            values_np=values_np,
        )

    def _assign_rep(self, bounds, ext):
        """Sequential lock assignment for every shard of one repetition."""
        return [self._assign_locks(hi - lo, ext) for lo, hi in bounds]

    def commit_polys(self, matrices: list[FMatrix]) -> CommitedData:
        values_np = padding_matrix_np(matrices)
        bounds = shard_bounds(values_np.shape[1])
        shard_args = self._assign_rep(bounds, matrices[0].ext)
        return self._build(matrices, values_np, shard_args, bounds)

    def commit_poly_with_query_times(
        self, matrices: list[FMatrix], total_query_times: int
    ) -> list[CommitedData]:
        """One tree (per shard) per query repetition, fresh bit commitments
        each (mod.rs:284-292). Assignment is sequential (deterministic
        secrets). When every matrix carries a torch tensor the tapleaf/branch
        hashing runs where it lives (_commit_device); otherwise the native
        tree builds release the GIL and run on a thread pool."""
        return self._commit_common(matrices, total_query_times, defer=False)

    def commit_poly_deferred(self, matrices: list[FMatrix], total_query_times: int):
        """The commit of matrices that all carry a tensor, without copying
        its roots: a DeferredDeviceCommit (the FRI commit phase's device
        transcript chain reads the roots where they are). None when a
        matrix has no tensor (the caller commits synchronously)."""
        return self._commit_common(matrices, total_query_times, defer=True)

    def _commit_common(self, matrices, total_query_times, defer: bool):
        on_device = all(isinstance(m.dev, torch.Tensor) for m in matrices)
        if defer and not on_device:
            return None
        ext = matrices[0].ext
        bounds = shard_bounds(sum(m.width for m in matrices))
        with span("tcs/assign-keygen"):
            assignments = [
                self._assign_rep(bounds, ext) for _ in range(total_query_times)
            ]
        if on_device:
            return self._commit_device(matrices, assignments, bounds, defer)
        with span("tcs/padding-matrix"):
            values_np = padding_matrix_np(matrices)
        if total_query_times > 1:
            with span("tcs/tree-builds"):
                return list(
                    _tree_pool().map(
                        lambda a: self._build(matrices, values_np, a, bounds),
                        assignments,
                    )
                )
        with span("tcs/tree-builds"):
            return [self._build(matrices, values_np, a, bounds) for a in assignments]

    def _commit_device(self, matrices, assignments, bounds, defer=False):
        """Tree builds where the matrices' tensors live: the padding matrix
        built there and left there (DeviceValues: openings copy their leaf
        blocks); per shard, the repetition-independent leaf suffix words
        once; then per rep-group every repetition's tapleaf compressions
        from its own head midstate with the first TapBranch levels (one
        tapleaf_subtrees launch) and the levels above them
        (tapbranch_levels, several levels a launch), the kept levels left
        there too (DeviceUppers: openings gather their paths). The roots of
        the whole commit come to the host in one copy, or, with `defer`,
        stay there: a DeferredDeviceCommit. Roots and openings are
        byte-identical to the host engine's (SparseNativeTaptree rebuilds
        each opening's leaf block on the host from the copied block)."""
        from . import device_commit as dc

        dev = matrices[0].dev.device
        reps = len(assignments)
        with span("tcs/dev-padding-matrix", dev):
            vals_dev = dc.padding_matrix_dev(matrices)
        n = vals_dev.shape[0]
        depth = max((n - 1).bit_length(), 0)
        cutoff = min(LEVEL_CUTOFF, depth)
        dvals = dc.DeviceValues(vals_dev, cutoff)
        group = max(1, min(reps, _DEVICE_GROUP_LANES // n))
        dispatched = []  # (shard, first rep, roots, DeviceUppers), on the card
        for s, (lo, hi) in enumerate(bounds):
            heads = [assignments[r][s][1] for r in range(reps)]
            fixed0 = assignments[0][s][2]
            for r in range(reps):
                assert (
                    len(assignments[r][s][1]) == len(heads[0])
                    and assignments[r][s][2] == fixed0
                )
            plan = dc.ShardSuffixPlan(len(heads[0]), fixed0)
            with span("tcs/dev-suffix", dev):
                suffix = dc.build_tail_suffix_words(vals_dev[:, lo:hi], plan)
            with span("tcs/dev-midstates"):
                mids, remws = plan.head_midstates_batch(heads)
            for g0 in range(0, reps, group):
                g1 = min(g0 + group, reps)
                with span("tcs/dev-trees", dev):
                    roots, uppers = dc.shard_trees_rep_group_async(
                        suffix, mids[g0:g1], remws[g0:g1], cutoff
                    )
                dispatched.append((s, g0, roots, uppers))

        def finalize(fetched):
            shards = [dvals.shard(lo, hi) for lo, hi in bounds]
            trees_by_rep = [[None] * len(bounds) for _ in range(reps)]
            for (s, g0, _, uppers), roots_np in zip(dispatched, fetched):
                for j, root in enumerate(dc.roots_to_bytes(roots_np)):
                    _, head, fixed_len = assignments[g0 + j][s]
                    trees_by_rep[g0 + j][s] = SparseNativeTaptree(
                        root, uppers.view(j), n, head, fixed_len, shards[s]
                    )
            return [
                CommitedData(
                    leaves=matrices,
                    trees=trees_by_rep[r],
                    use_bcs_list=[assignments[r][s][0] for s in range(len(bounds))],
                    bounds=bounds,
                    values_np=dvals,
                )
                for r in range(reps)
            ]

        if defer:
            return DeferredDeviceCommit([d[2] for d in dispatched], len(bounds), finalize)
        with span("tcs/dev-fetch", dev):
            fetched = dc.to_host([d[2] for d in dispatched])
        return finalize(fetched)

    def open_with_one_query(
        self, query_times_index: int, query_index: int, prover_data: list[CommitedData]
    ) -> tuple[CommitedProof, list[list[int]]]:
        data = prover_data[query_times_index]
        return data.query_proof(query_index), data.leaf_limbs(query_index)

    @staticmethod
    def verify(root_hash: bytes, proof: CommitedProof, opening_limbs: list[list[int]]) -> bool:
        witness = _leaf_witness(proof.use_bcs, proof.query_index, opening_limbs)
        if not verify_inclusion(root_hash, proof.leaf):
            return False
        from ..script.interpreter import MAX_STACK, execute_script

        # Sharded commits keep every leaf under Bitcoin's 1000-element stack
        # limit by construction; the relaxed limit remains only as a guard
        # for direct single-tree use beyond MAX_LEAF_VALUES.
        limit = max(MAX_STACK, len(witness) + 64)
        return execute_script(proof.leaf.script, witness, stack_limit=limit).success

    @staticmethod
    def verify_words(
        root_words: list[int], proof, opening_limbs: list[list[int]]
    ) -> bool:
        """Verify against a commitment's (possibly sharded) root-word list:
        8 LE words per shard tree, column ranges re-derived from the opened
        value count (shard_bounds is deterministic)."""
        if isinstance(proof, ShardedCommitedProof):
            bounds = shard_bounds(len(opening_limbs))
            if len(bounds) != len(proof.shards):
                return False
            if len(root_words) != 8 * len(bounds):
                return False
            for s, ((lo, hi), sp) in enumerate(zip(bounds, proof.shards)):
                root_hash = b"".join(
                    int(w).to_bytes(4, "little") for w in root_words[8 * s : 8 * s + 8]
                )
                if not TCS.verify(root_hash, sp, opening_limbs[lo:hi]):
                    return False
            return True
        if len(root_words) != 8:
            return False
        root_hash = b"".join(int(w).to_bytes(4, "little") for w in root_words)
        return TCS.verify(root_hash, proof, opening_limbs)
