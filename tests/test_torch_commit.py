"""The port's taptree commit layer (tapstark_torch.hashes.sha256_device,
tapstark_torch.commit.device_commit, the device path of
tapstark_torch.commit.tcs) against the JAX package's, word for word.

On the CPU the kernel wrappers run their plain versions; the CUDA kernels
are held against those plain versions by the `cuda`-marked tests (and by
chip_smoke.py on the card). The JAX side runs its CPU scan path: the Pallas
kernels K5/K6 are not run in interpret mode (multi-minute XLA:CPU
compiles). Exact equality throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapstark.commit import BcManager as JBcManager
from tapstark.commit import device_commit as jdc
from tapstark.commit import taptree as jtt
from tapstark.commit.taptree import build_taptree
from tapstark.commit.tcs import TCS as JTCS
from tapstark.commit.tcs import FMatrix as JFMatrix
from tapstark.commit.tcs import _leaf_script_from_row, _max_tail_len
from tapstark.field.constants import P
from tapstark.field.device import np_to_mont
from tapstark.hashes import sha256_device as jsd
from tapstark.hashes.sha256 import tapbranch_hash
from tapstark.utils import bitrev_indices
from tapstark_torch.commit import BcManager
from tapstark_torch.commit import taptree as ttt
from tapstark_torch.commit import device_commit as dc
from tapstark_torch.commit import tcs
from tapstark_torch.hashes import sha256_device as sd
from tapstark_torch.interop import mont_np_from_tensor, tensor_from_mont_np

EDGE = [0, 1, 16, 17, 0x7F, 0x80, 0x7FFF, 0x8000, 0x7FFFFF, 0x800000, P - 1]


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return tensor_from_mont_np(a, "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return mont_np_from_tensor(t)


def test_compress_plain_matches_jax_and_numpy():
    rng = np.random.default_rng(30)
    m = 37
    state, block = _words(rng, 8, m), _words(rng, 32, m)
    got = _np(sd.compress_wm(_t(state), _t(block)))
    # two chained compressions per lane, through the JAX scan path
    want = jsd.compress_batch_wm(jnp.asarray(state), jnp.asarray(block[:16]))
    want = np.asarray(jsd.compress_batch_wm(want, jnp.asarray(block[16:])))
    np.testing.assert_array_equal(got, want)
    for i in (0, 17, m - 1):
        one = jsd._compress_np(jsd._compress_np(state[:, i], block[:16, i]), block[16:, i])
        np.testing.assert_array_equal(got[:, i], one)


def test_compress_leaf_form_matches_materialized_blocks():
    """The leaf form (shared suffix | per-repetition remainder, per-repetition
    midstates) equals the JAX compression of the materialized blocks."""
    rng = np.random.default_rng(31)
    r, n = 3, 24
    mids, suffix, rem = _words(rng, 8, r), _words(rng, 32, n), _words(rng, 32, r)
    got = _np(sd.compress_wm(_t(mids), _t(suffix), _t(rem)))
    assert got.shape == (8, r, n)
    state = jnp.broadcast_to(jnp.asarray(mids)[:, :, None], (8, r, n))
    for b in range(2):
        blk = suffix[16 * b : 16 * b + 16, None, :] | rem[16 * b : 16 * b + 16, :, None]
        state = jsd.compress_batch_wm(state, jnp.asarray(blk))
    np.testing.assert_array_equal(got, np.asarray(state))


def test_tapbranch_plain_matches_jax_and_host():
    rng = np.random.default_rng(32)
    m = 21
    h1, h2 = _words(rng, 8, m), _words(rng, 8, m)
    h2[:, ::3] = h1[:, ::3]  # equal pairs: the lexicographic tie
    h2[:3, 1::3] = h1[:3, 1::3]  # pairs that first differ at word 3
    got = _np(sd.tapbranch_wm(_t(h1), _t(h2)))
    np.testing.assert_array_equal(got, np.asarray(jsd.tapbranch_hash_batch_wm(jnp.asarray(h1), jnp.asarray(h2))))
    for i in range(m):
        want = tapbranch_hash(h1[:, i].astype(">u4").tobytes(), h2[:, i].astype(">u4").tobytes())
        assert got[:, i].astype(">u4").tobytes() == want
    # strided children, as a tree level passes them
    level = _t(np.stack([h1, h2], axis=2).reshape(8, 2 * m)).view(8, m, 2)
    np.testing.assert_array_equal(_np(sd.tapbranch_wm(level[:, :, 0], level[:, :, 1])), got)


def _jax_suffix(vals, jplan, idx):
    """The JAX package's suffix words in its one-hot form. Its word-major
    builder (`build_tail_suffix_words`) computes the same words (the JAX
    package's tests/test_device_commit.py holds the two equal at these
    shapes) but compiles for 14-25 s per shape on XLA:CPU, except at
    (300, 2, 1), where the test below holds the port against it."""
    return np.asarray(
        jdc._suffix_all_jit(
            jnp.asarray(vals), jnp.asarray(jplan.pad_words), jnp.asarray(idx, dtype=jnp.uint32),
            jplan.tail_span, jplan.rem_len, jplan.suf_words, 1 << 16,
        )
    ).T


def _suffix_case(n, k, l):
    """Seeded (n, k, l) values with the edge values planted, a head length
    and the shard's fixed script length."""
    rng = np.random.default_rng(11)
    vals = rng.integers(0, P, (n, k, l), dtype=np.uint64).astype(np.uint32)
    for i, v in enumerate(EDGE):
        vals[i % n, i % k, i % l] = v
    head = bytes(rng.integers(0, 256, 731, dtype=np.uint8))
    return vals, len(head), len(head) + _max_tail_len(k, l)


@pytest.mark.parametrize("n,k,l", [(64, 3, 4), (300, 2, 1), (256, 8, 1), (512, 2, 4)])
def test_suffix_words_match_jax(n, k, l, monkeypatch):
    monkeypatch.setattr(dc, "_SUFFIX_CHUNK_LEAVES", 128)  # several passes, a ragged last one
    vals, head_len, fixed_len = _suffix_case(n, k, l)
    plan = dc.ShardSuffixPlan(head_len, fixed_len)
    jplan = jdc.ShardSuffixPlan(head_len, fixed_len)
    got = _np(dc.build_tail_suffix_words(_t(vals), plan, base_index=7))
    want = _jax_suffix(vals, jplan, 7 + np.arange(n))
    assert got.shape == (plan.suf_words, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plan.pad_words, jplan.pad_words)


def test_suffix_words_match_jax_word_major_builder():
    """Against the JAX package's `build_tail_suffix_words` itself, at the
    one shape of the four above whose XLA:CPU compile takes seconds, not
    tens of seconds (300 leaves of 2 base-field values)."""
    vals, head_len, fixed_len = _suffix_case(300, 2, 1)
    got = _np(dc.build_tail_suffix_words(_t(vals), dc.ShardSuffixPlan(head_len, fixed_len), base_index=7))
    want = jdc.build_tail_suffix_words(vals, jdc.ShardSuffixPlan(head_len, fixed_len), base_index=7)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_shard_trees_match_jax_and_host_taptree():
    """Roots and the paths above the cutoff against the JAX package's
    device-commit trees and the host taptree (n = 64, 3 reps, cutoff 3)."""
    rng = np.random.default_rng(2)
    n, k, l, cutoff = 64, 3, 4, 3
    heads = [bytes(rng.integers(0, 256, 731, dtype=np.uint8)) for _ in range(3)]
    vals = rng.integers(0, P, (n, k, l), dtype=np.uint64).astype(np.uint32)
    for i, v in enumerate(EDGE):
        vals[i, 0, 0] = v
    fixed_len = len(heads[0]) + _max_tail_len(k, l)

    plan = dc.ShardSuffixPlan(len(heads[0]), fixed_len)
    mids, rems = plan.head_midstates_batch(heads)
    suffix = dc.build_tail_suffix_words(_t(vals), plan)
    roots, uppers = dc.shard_trees_rep_group_async(suffix, mids, rems, cutoff)
    root_bytes = dc.roots_to_bytes(_np(roots))

    jplan = jdc.ShardSuffixPlan(len(heads[0]), fixed_len)
    jmids, jrems = jplan.head_midstates_batch(heads)
    np.testing.assert_array_equal(mids, jmids)
    np.testing.assert_array_equal(rems, jrems)
    # the JAX trees keep leaves in bit-reversed lane order
    jsuffix = jnp.asarray(_jax_suffix(vals[bitrev_indices(6)], jplan, bitrev_indices(6)))
    jroots, juppers = jdc.shard_trees_rep_group(jsuffix, jmids, jrems, cutoff)
    assert root_bytes == jroots
    np.testing.assert_array_equal(_np(roots), np.stack([np.frombuffer(b, ">u4") for b in jroots]))
    assert tuple(uppers.flat.shape) == (3, sum(n >> lvl for lvl in range(cutoff, 6)), 8)

    for r, head in enumerate(heads):
        t = build_taptree([_leaf_script_from_row(head, fixed_len, i, vals[i]) for i in range(n)])
        assert root_bytes[r] == t.root_hash
        for i in (0, 5, 37, n - 1):
            above = uppers.view(r).path_bytes(i)
            assert above == t.get_tapleaf(i).merkle_branch[cutoff:] == juppers.view(r).path_bytes(i)


def _chain_levels(mids, suffix, rem, depth):
    """Today's one-step chain: leaf digests by `compress_wm_plain`, then one
    `tapbranch_wm_plain` per level; every level (8, R, n >> l), leaves first."""
    level = sd.compress_wm_plain(mids, suffix, rem)
    out = [level]
    for _ in range(depth):
        pairs = level.reshape(8, -1, 2)
        level = sd.tapbranch_wm_plain(pairs[:, :, 0], pairs[:, :, 1]).view(8, level.shape[1], -1)
        out.append(level)
    return out


# (leaves, suffix blocks per leaf, repetitions): depth below, at and past
# the cutoff; 2^13 leaves have 5 levels above the cutoff, one launch of
# BRANCH_LEVELS and one of a single level
SUBTREE_SHAPES = [(n, nb, r) for n in (1, 2, 1 << 5, 1 << 8, 1 << 13) for nb in (1, 2) for r in (1, 3)]


def test_subtree_kernels_plain_match_chain_jax_and_host_taptree():
    """The new kernels' plain versions (`tapleaf_subtrees_plain`,
    `tapbranch_levels_plain`) against today's chain at every level, and the
    roots and kept levels of `shard_trees_rep_group` (the commit's launch
    plan) against the chain and the host taptree over SUBTREE_SHAPES, and
    against the JAX package's device-commit trees at its 3-repetition
    shapes. Heads of 731 and 740 bytes put the
    (2, 1)-value tails in one and in two suffix blocks."""
    rng = np.random.default_rng(60)
    k, l = 2, 1
    for n, nb, r in SUBTREE_SHAPES:
        head_len = 731 if nb == 1 else 740
        heads = [bytes(rng.integers(0, 256, head_len, dtype=np.uint8)) for _ in range(r)]
        vals = rng.integers(0, P, (n, k, l), dtype=np.uint64).astype(np.uint32)
        for i, v in enumerate(EDGE[:n]):
            vals[i, 0, 0] = v
        fixed_len = head_len + _max_tail_len(k, l)
        plan = dc.ShardSuffixPlan(head_len, fixed_len)
        assert plan.suf_words == 16 * nb
        mids, rems = plan.head_midstates_batch(heads)
        suffix = dc.build_tail_suffix_words(_t(vals), plan)
        tm, tr = _t(np.ascontiguousarray(mids.T)), _t(np.ascontiguousarray(rems.T))
        depth = n.bit_length() - 1
        cutoff = min(tcs.LEVEL_CUTOFF, depth)
        chain = _chain_levels(tm, suffix, tr, depth)
        first = min(sd.LEAF_LEVELS, cutoff)
        for lv in {first, min(depth, sd.MAX_TILE_LEVELS)}:
            assert torch.equal(sd.tapleaf_subtrees_plain(tm, suffix, tr, lv), chain[lv]), (n, nb, r, lv)
        if cutoff > first:  # up to the cutoff, its level only
            got = sd.tapbranch_levels_plain(chain[first], cutoff - first, cutoff - first)
            assert torch.equal(got, chain[cutoff]), (n, nb, r)
        if depth > cutoff:  # every level above it, as many as a launch takes
            top = min(depth, cutoff + sd.MAX_TILE_LEVELS)
            got = sd.tapbranch_levels_plain(chain[cutoff], top - cutoff)
            assert torch.equal(got, torch.cat(chain[cutoff + 1 : top + 1], dim=2)), (n, nb, r)

        roots, uppers = dc.shard_trees_rep_group(suffix, mids, rems, cutoff)
        assert torch.equal(roots, chain[depth][:, :, 0].T)
        kept = [chain[lv] for lv in range(cutoff, depth)]
        want = torch.cat(kept, dim=2) if kept else chain[depth][:, :, :0]
        assert torch.equal(uppers, want.permute(1, 2, 0))
        root_bytes, paths = dc.roots_to_bytes(_np(roots)), dc.DeviceUppers(uppers, n, cutoff)

        if r > 1:  # the JAX trees (one compile per shape); they keep bit-reversed order
            jplan = jdc.ShardSuffixPlan(head_len, fixed_len)
            brv = bitrev_indices(depth)
            jsuffix = jnp.asarray(_jax_suffix(vals[brv], jplan, brv))
            jroots, juppers = jdc.shard_trees_rep_group(jsuffix, mids, rems, cutoff)
            assert root_bytes == jroots, (n, nb, r)
            jflat = np.asarray(juppers.flat)
            for lv, off in zip(range(cutoff, depth), juppers.offsets):
                natural = jflat[:, off + bitrev_indices(depth - lv)]  # (R, n >> lv, 8)
                np.testing.assert_array_equal(_np(uppers[:, off : off + (n >> lv)]), natural)

        for j, head in enumerate(heads):
            t = build_taptree([_leaf_script_from_row(head, fixed_len, i, vals[i]) for i in range(n)])
            assert root_bytes[j] == t.root_hash
            for i in {0, n // 3, n - 1}:
                assert paths.view(j).path_bytes(i) == t.get_tapleaf(i).merkle_branch[cutoff:]


def _leaf_bytes(proof):
    return [(s.leaf.script, s.leaf.leaf_hash, s.leaf.merkle_branch) for s in getattr(proof, "shards", [proof])]


def _open_all(datas, queries):
    return [[_leaf_bytes(d.query_proof(q)) for q in queries] for d in datas]


TCS_SHAPES = [
    [(64, 3)],  # one base-field matrix
    [(32, 2, 4)],  # an FRI layer: (half, 2) extension values
    [(64, 2), (16, 1)],  # two heights: rows repeat in the padding matrix
    [(16, 41)],  # 41 values: two column shards
]


@pytest.mark.parametrize("shapes", TCS_SHAPES)
def test_tcs_device_path_matches_host_paths(shapes):
    """The port's TCS on CPU tensors (the device path, through the kernels'
    plain versions) against its host path and the JAX package's host
    commit: roots, openings and the leaf values they open."""
    rng = np.random.default_rng(40)
    reps = 2
    canon = [rng.integers(0, P, s).astype(np.uint32) for s in shapes]
    for a in canon:
        a.reshape(-1)[: len(EDGE)] = EDGE[: a.size]
    mats_dev = [tcs.FMatrix(dev=_t(np_to_mont(a))) for a in canon]
    on_dev = tcs.TCS(BcManager()).commit_poly_with_query_times(mats_dev, reps)
    on_host = tcs.TCS(BcManager()).commit_poly_with_query_times([tcs.FMatrix(a) for a in canon], reps)
    ref = JTCS(JBcManager()).commit_poly_with_query_times([JFMatrix(a) for a in canon], reps)

    n = shapes[0][0]
    queries = [0, 1, n // 2 + 3, n - 1]
    assert [d.root_words() for d in on_dev] == [d.root_words() for d in on_host] == [d.root_words() for d in ref]
    assert _open_all(on_dev, queries) == _open_all(on_host, queries) == _open_all(ref, queries)
    for q in queries:
        assert on_dev[1].leaf_limbs(q) == ref[1].leaf_limbs(q)
        proof, limbs = tcs.TCS(BcManager()).open_with_one_query(1, q, on_dev)
        assert tcs.TCS.verify_words(on_dev[1].root_words(), proof, limbs)


def test_deferred_commit_and_path_plans_match(monkeypatch):
    """At the shapes of test_tcs_device_path_matches_host_paths: the
    deferred commit (roots left where they were hashed) finalized from one
    copy of its roots gives the roots and openings of the synchronous
    commit and of the JAX package's host commit; every opening's leaf
    block and path, planned (`plan_query`) and copied by one
    `materialize_path_plans`, gives the same leaf bytes with no further
    copy; `DeviceValues.full()` is never reached."""
    copies = []
    real_to_host = dc.to_host

    def counted(tensors):
        copies.append(len(tensors))
        return real_to_host(tensors)

    monkeypatch.setattr(dc, "to_host", counted)
    monkeypatch.setattr(tcs, "LEVEL_CUTOFF", 3)  # trees of 16-64 leaves keep levels above it
    rng = np.random.default_rng(43)
    reps, full_before = 2, dc.DeviceValues.full_calls
    for shapes in TCS_SHAPES:
        canon = [rng.integers(0, P, s).astype(np.uint32) for s in shapes]
        for a in canon:
            a.reshape(-1)[: len(EDGE)] = EDGE[: a.size]

        def mats():
            return [tcs.FMatrix(dev=_t(np_to_mont(a))) for a in canon]

        sync = tcs.TCS(BcManager()).commit_poly_with_query_times(mats(), reps)
        dfr = tcs.TCS(BcManager()).commit_poly_deferred(mats(), reps)
        assert tcs.TCS(BcManager()).commit_poly_deferred([tcs.FMatrix(a) for a in canon], reps) is None
        ref = JTCS(JBcManager()).commit_poly_with_query_times([JFMatrix(a) for a in canon], reps)
        shards = len(tcs.shard_bounds(sum(s[1] for s in shapes)))
        assert dfr.num_groups == shards  # one rep-group a shard at these sizes
        fetched = dc.to_host(dfr.root_handles)
        deferred = dfr.finalize(fetched)
        assert dfr.finalize(None) is deferred
        assert [d.root_words() for d in deferred] == [d.root_words() for d in sync] == [d.root_words() for d in ref]
        if shards == 1:
            np.testing.assert_array_equal(_np(dfr.roots_rep_order_dev()), fetched[0])
        else:
            with pytest.raises(ValueError):
                dfr.roots_rep_order_dev()

        n = shapes[0][0]
        queries = [0, 1, n // 2 + 3, n - 1]
        plans = [p for q in queries for d in deferred for p in d.plan_query(q)]
        # a leaf block per distinct block (the repetitions share the values)
        # and a path per (repetition, shard tree, query)
        assert len(plans) == len({q >> 3 for q in queries}) + reps * shards * len(queries)
        del copies[:]
        tcs.materialize_path_plans(plans)
        assert copies == [len(plans)]
        opened = _open_all(deferred, queries)
        limbs = [deferred[1].leaf_limbs(q) for q in queries]
        assert copies == [len(plans)]  # the openings copied nothing more
        assert opened == _open_all(sync, queries) == _open_all(ref, queries)
        assert limbs == [ref[1].leaf_limbs(q) for q in queries]
        assert not [p for q in queries for d in deferred for p in d.plan_query(q)]
    assert dc.DeviceValues.full_calls == full_before


def test_device_commit_group_split(monkeypatch):
    """Repetitions split into several rep-groups commit to the same roots."""
    rng = np.random.default_rng(41)
    a = rng.integers(0, P, (32, 2)).astype(np.uint32)
    whole = tcs.TCS(BcManager()).commit_poly_with_query_times([tcs.FMatrix(dev=_t(np_to_mont(a)))], 3)
    monkeypatch.setattr(tcs, "_DEVICE_GROUP_LANES", 64)  # 2 repetitions of 32 leaves per group
    split = tcs.TCS(BcManager()).commit_poly_with_query_times([tcs.FMatrix(dev=_t(np_to_mont(a)))], 3)
    assert [d.root_words() for d in split] == [d.root_words() for d in whole]
    assert _open_all(split, [0, 31]) == _open_all(whole, [0, 31])


def test_sha256_batch_api_matches_jax_and_hashlib():
    """The word-minor and word-major compressions (a lane shape of two
    axes, a broadcast state) and `sha256_blocks` against the JAX package's
    scan path; `sha256_blocks` of padded messages of 0-130 bytes against
    hashlib; each `*_plain` twin equal."""
    import hashlib

    rng = np.random.default_rng(31)
    state, block = _words(rng, 5, 3, 8), _words(rng, 5, 3, 16)
    want = jsd.compress_batch(jnp.asarray(state), jnp.asarray(block))
    np.testing.assert_array_equal(_np(sd.compress_batch(_t(state), _t(block))), np.asarray(want))
    got = sd.compress_batch(_t(state[0, 0]), _t(block))  # one state for every lane
    every = np.broadcast_to(state[0, 0], state.shape)
    np.testing.assert_array_equal(_np(got), np.asarray(jsd.compress_batch(jnp.asarray(every), jnp.asarray(block))))
    state, block = _words(rng, 8, 4, 3), _words(rng, 16, 4, 3)
    want = jsd.compress_batch_wm(jnp.asarray(state), jnp.asarray(block))
    np.testing.assert_array_equal(_np(sd.compress_batch_wm(_t(state), _t(block))), np.asarray(want))
    blocks = _words(rng, 9, 3, 16)
    want = np.asarray(jsd.sha256_blocks(jnp.asarray(blocks)))
    np.testing.assert_array_equal(_np(sd.sha256_blocks(_t(blocks))), want)
    np.testing.assert_array_equal(_np(sd.sha256_blocks_plain(_t(blocks))), want)
    for size in (0, 55, 56, 64, 130):
        msg = bytes(rng.integers(0, 256, size, dtype=np.uint8))
        padded = msg + b"\x80" + b"\0" * ((55 - size) % 64) + (8 * size).to_bytes(8, "big")
        words = np.frombuffer(padded, ">u4").astype(np.uint32).reshape(1, -1, 16)
        assert _np(sd.sha256_blocks(_t(words)))[0].astype(">u4").tobytes() == hashlib.sha256(msg).digest()


def test_tagged_and_tapbranch_batch_api_match_jax():
    """`tagged_hash_fixed_batch` (TapLeaf and another tag; 1-3 blocks a
    lane), `tapbranch_hash_batch` and its word-major form, and
    `tapbranch_fused_wm` against the JAX package's scan path, pairs equal
    and sharing prefixes included; each `*_plain` twin equal; a message
    length other than 4 words a word raises."""
    rng = np.random.default_rng(32)
    for tag, w in ((b"TapLeaf", 12), (b"TapLeaf", 3), (b"tapstark/x", 20)):
        msg = _words(rng, 6, 2, w)
        want = np.asarray(jsd.tagged_hash_fixed_batch(tag, jnp.asarray(msg), 4 * w))
        np.testing.assert_array_equal(_np(sd.tagged_hash_fixed_batch(tag, _t(msg), 4 * w)), want)
        np.testing.assert_array_equal(_np(sd.tagged_hash_fixed_batch_plain(tag, _t(msg), 4 * w)), want)
    with pytest.raises(ValueError):
        sd.tagged_hash_fixed_batch(b"TapLeaf", _t(msg), 4 * w + 1)
    h1, h2 = _words(rng, 11, 8), _words(rng, 11, 8)
    h2[0] = h1[0]
    h2[1, :3] = h1[1, :3]
    h2[2, :7] = h1[2, :7]
    h2[3, 0] = h1[3, 0] ^ 0x80000000  # differ in the top bit: an unsigned compare
    want = np.asarray(jsd.tapbranch_hash_batch(jnp.asarray(h1), jnp.asarray(h2)))
    np.testing.assert_array_equal(_np(sd.tapbranch_hash_batch(_t(h1), _t(h2))), want)
    np.testing.assert_array_equal(_np(sd.tapbranch_hash_batch_plain(_t(h1), _t(h2))), want)
    assert _np(sd.tapbranch_hash_batch(_t(h1[3:4]), _t(h2[3:4])))[0].astype(">u4").tobytes() == tapbranch_hash(
        h1[3].astype(">u4").tobytes(), h2[3].astype(">u4").tobytes())
    a, b = _words(rng, 8, 4, 3), _words(rng, 8, 4, 3)
    b[:, 0] = a[:, 0]
    want = np.asarray(jsd.tapbranch_hash_batch_wm(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_np(sd.tapbranch_hash_batch_wm(_t(a), _t(b))), want)
    np.testing.assert_array_equal(_np(sd.tapbranch_fused_wm(_t(a), _t(b))), want)
    np.testing.assert_array_equal(np.asarray(jsd.tapbranch_fused_wm(jnp.asarray(a), jnp.asarray(b))), want)


def _scripts(rng, n):
    return [bytes(rng.integers(0, 256, int(rng.integers(1, 90)), dtype=np.uint8)) for _ in range(n)]


def _same_tree(t, j):
    assert t.root_hash == j.root_hash and t.root_words() == j.root_words()
    assert t.leaf_indices == j.leaf_indices and t.leaf_count() == j.leaf_count()
    for i in range(t.leaf_count()):
        a, b = t.get_tapleaf(i), j.get_tapleaf(i)
        assert (a.script, a.leaf_hash, a.merkle_branch) == (b.script, b.leaf_hash, b.merkle_branch)
        assert ttt.verify_inclusion(t.root_hash, a)


def test_taptree_builder_matches_jax():
    """`build_taptree` over 1-16 leaf scripts and `combine_taptrees` both
    ways and nested against the JAX package's: the same roots, leaf
    indices and inclusion proofs; `combine_with_order` and `NodeInfo`
    likewise, and a leaf count other than a power of two raises."""
    rng = np.random.default_rng(33)
    trees = {}
    for n in (1, 2, 8, 16):
        scripts = _scripts(rng, n)
        trees[n] = (ttt.build_taptree(scripts), jtt.build_taptree(scripts))
        _same_tree(*trees[n])
    for x, y in ((8, 16), (16, 8), (2, 1)):
        _same_tree(ttt.combine_taptrees(trees[x][0], trees[y][0]), jtt.combine_taptrees(trees[x][1], trees[y][1]))
    nested = ttt.combine_taptrees(ttt.combine_taptrees(trees[2][0], trees[8][0]), trees[1][0])
    _same_tree(nested, jtt.combine_taptrees(jtt.combine_taptrees(trees[2][1], trees[8][1]), trees[1][1]))
    a, b = _scripts(rng, 2)
    (pt, ft), (pj, fj) = (m.combine_with_order(m.NodeInfo.new_leaf(a), m.NodeInfo.new_leaf(b)) for m in (ttt, jtt))
    assert (pt.hash, ft, [l.merkle_branch for l in pt.leaves]) == (pj.hash, fj, [l.merkle_branch for l in pj.leaves])
    with pytest.raises(AssertionError):
        ttt.build_taptree(_scripts(rng, 3))


def test_taptree_root_matches_native_commit():
    """`build_taptree` over the leaf scripts of a commit (two column shards,
    two repetitions) against the native engine's roots and openings, and
    the commit module's other names: `device_commit_will_serve`,
    `log2_ceil`, `bitrev_rows_dev` and the reference's hash-layer names."""
    rng = np.random.default_rng(34)
    a = rng.integers(0, P, (16, 41)).astype(np.uint32)
    for data in tcs.TCS(BcManager()).commit_poly_with_query_times([tcs.FMatrix(a)], 2):
        assert len(data.trees) == 2
        for tree in data.trees:
            built = ttt.build_taptree([tree._script_fn(i) for i in range(tree.leaf_count())])
            assert built.root_hash == tree.root_hash and built.root_words() == tree.root_words()
            for i in (0, 5, 15):
                got, want = tree.get_tapleaf(i), built.get_tapleaf(i)
                assert (got.script, got.leaf_hash, got.merkle_branch) == (want.script, want.leaf_hash, want.merkle_branch)
    assert tcs.device_commit_will_serve(1 << 20, "cpu") and tcs.device_commit_will_serve(4, torch.device("cuda", 0))
    assert not tcs.device_commit_will_serve(1 << 20, None)
    assert [tcs.log2_ceil(n) for n in (1, 2, 3, 1000)] == [0, 1, 2, 10]
    x = _t(_words(rng, 8, 3))
    want = np.asarray(jdc.bitrev_rows_dev(jnp.asarray(_np(x)), 3))
    np.testing.assert_array_equal(_np(dc.bitrev_rows_dev(x, 3)), want)
    with pytest.raises(ValueError):
        dc.bitrev_rows_dev(x, 2)
    assert (dc.compress_batch, dc.compress_batch_wm, dc.tapbranch_fused_wm) == (
        sd.compress_batch, sd.compress_batch_wm, sd.tapbranch_fused_wm)
    assert dc.sha256(b"abc") == jdc.sha256(b"abc")


def test_sha_wrappers_raise_off_cpu_and_cuda():
    x = torch.empty((8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sd.compress_wm(x, torch.empty((16, 4), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        sd.tapbranch_wm(x, x)


@pytest.mark.cuda
def test_cuda_sha_kernels_match_plain():
    """The one-step forms at 2^12 and 4099 lanes, and `tapleaf_subtrees` /
    `tapbranch_levels` over trees of 2^5 and 2^13 leaves (3 repetitions, 1
    and 2 suffix blocks) as the commit launches them, against their plain
    versions, launches counted; then a commit of 2^12 FRI-layer leaves on
    the card against the host engine. One test, not many cases: see
    ROADMAP.md on how the suite's item count places the slow pre-port
    tests in the parallel run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(50)
    for lanes in (1 << 12, 4099):
        state, block = _t(_words(rng, 8, lanes)).cuda(), _t(_words(rng, 32, lanes)).cuda()
        h1, h2 = _t(_words(rng, 8, lanes)).cuda(), _t(_words(rng, 8, lanes)).cuda()
        h2[:, ::3] = h1[:, ::3]
        before = dict(sd.launches)
        assert torch.equal(sd.compress_wm(state, block), sd.compress_wm_plain(state, block))
        assert torch.equal(sd.tapbranch_wm(h1, h2), sd.tapbranch_wm_plain(h1, h2))
        mids, rem = _t(_words(rng, 8, 5)).cuda(), _t(_words(rng, 32, 5)).cuda()
        suffix = block[:, :4096].contiguous()
        assert torch.equal(sd.compress_wm(mids, suffix, rem), sd.compress_wm_plain(mids, suffix, rem))
        assert sd.launches["tapleaf_subtrees"] == before["tapleaf_subtrees"] + 2
        assert sd.launches["tapbranch_levels"] == before["tapbranch_levels"] + 1
        for n, nb in ((1 << 5, 1), (1 << 13, 2)):
            mids, suffix, rem = (_t(_words(rng, *shape)).cuda() for shape in ((8, 3), (16 * nb, n), (16 * nb, 3)))
            before = dict(sd.launches)
            level4 = sd.tapleaf_subtrees(mids, suffix, rem, 4)
            assert torch.equal(level4, sd.tapleaf_subtrees_plain(mids, suffix, rem, 4))
            depth = n.bit_length() - 1
            top = min(depth - 4, sd.MAX_TILE_LEVELS)
            assert torch.equal(sd.tapbranch_levels(level4, top), sd.tapbranch_levels_plain(level4, top))
            assert torch.equal(sd.tapbranch_levels(level4, top, top), sd.tapbranch_levels_plain(level4, top, top))
            assert sd.launches["tapleaf_subtrees"] == before["tapleaf_subtrees"] + 1
            assert sd.launches["tapbranch_levels"] == before["tapbranch_levels"] + 2

    # the batch API on K5/K6's kernels against its plain versions
    blocks = _t(_words(rng, 4099, 2, 16)).cuda()
    msg, h1, h2 = _t(_words(rng, 4099, 12)).cuda(), _t(_words(rng, 4099, 8)).cuda(), _t(_words(rng, 4099, 8)).cuda()
    h2[::3] = h1[::3]
    before = dict(sd.launches)
    assert torch.equal(sd.sha256_blocks(blocks), sd.sha256_blocks_plain(blocks))
    assert torch.equal(sd.tagged_hash_fixed_batch(b"TapLeaf", msg, 48), sd.tagged_hash_fixed_batch_plain(b"TapLeaf", msg, 48))
    assert torch.equal(sd.tapbranch_hash_batch(h1, h2), sd.tapbranch_hash_batch_plain(h1, h2))
    assert torch.equal(sd.tapbranch_fused_wm(h1.T, h2.T), sd.tapbranch_hash_batch_plain(h1, h2).T)
    assert sd.launches["tapleaf_subtrees"] == before["tapleaf_subtrees"] + 3
    assert sd.launches["tapbranch_levels"] == before["tapbranch_levels"] + 1

    rng = np.random.default_rng(51)
    a = rng.integers(0, P, (1 << 12, 2, 4)).astype(np.uint32)
    on_card = tcs.TCS(BcManager()).commit_poly_with_query_times([tcs.FMatrix(dev=_t(np_to_mont(a)).cuda())], 3)
    on_host = tcs.TCS(BcManager()).commit_poly_with_query_times([tcs.FMatrix(a)], 3)
    assert [d.root_words() for d in on_card] == [d.root_words() for d in on_host]
    assert _open_all(on_card, [0, 7, 4095]) == _open_all(on_host, [0, 7, 4095])
