"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `tapstark_torch/csrc/`, holds each one
(and both forms of `dit_cols`: the plain column transform and the first
member of a forward coset LDE; of `dif_cols`: the plain column transform
and the last member of an inverse transform; and of `mod_matmul`: the
natural output and the one written for the next recursion level, also on
extreme inputs) against its plain PyTorch version on the card (exact
equality: the words are integers), holds a north-star
trace-commit shard, an FRI layer and two
small trees hashed on the card against the host SHA-NI engine, holds the blocks LDE
route (2^22 rows) and the limb-matmul LDE (2^20 rows) against the fused
route, runs the phase "surface" (the API no prove calls, on the same
kernels: the gather-free LDE and its halves, the SHA-256 batch API,
`interpolate_coset` with its largest allocation bounded), proves the frozen golden Fibonacci configuration on the card and
checks its proof bytes, then proves and verifies Fibonacci at 2^20 rows
(the north star, on the fused LDE route) and at 2^22 rows (the blocks
route), blowup 4, 28 queries and 8 PoW bits, through `tapstark_torch`'s
entry points, with the kernels' launch counts read around each run, and
holds both proofs to the bytes frozen from the tree before the SHA-256
kernels' redesign. It emits the golden proof's Bitcoin-Script verifier
and holds its report to numbers frozen from the JAX package, and proves
the repo's widest verifier row (RecursionAir, 2^18 rows x 163 columns,
blowup 16, 16 queries, 8 PoW bits, a final polynomial of degree < 2^5)
through `standard_config`, verifies it and emits and executes its script
verifier, holding the proof and the report to the JAX package's. Last
it proves the flagship, a Blake3 sponge chain of 1024 compressions
(Blake3SpongeChainAir, 65,536 rows x 1548 columns, blowup 2, 16 queries, 4
PoW bits; and of 64 compressions, held to the JAX package's proof), checks
the AIR's digest against the host challenger's, verifies it, and holds
the quotient kernels (the AIR's constraint program as straight-line
segments generated for each AIR, built before the first prove that runs
them) word for word against the selectors and the eager constraint folder
at the quotient shapes of the flagship, the two Fibonacci proves and the
wide row. Every prove runs each segment of its AIR's program once, after
one launch of `bit_reverse_cols` (the gather that writes the quotient's
coset by columns), which is held against its plain version too. Each
prove's FRI layers folded on the card take their betas from the device
transcript chain (`transcript_step`, csrc/transcript.cu, held against its
plain version in chains of 3 steps): the smoke asserts its steps in every
prove (CHAIN_STEPS), and that no opening copied a whole padding matrix.
Last, the phase "mesh" runs the device mesh on MESH_SHARDS shards of the
one card: the distributed NTT, its inverse and coset LDE against one
device's, the sharded prover step against its one-shard composition, the
quotient segments on one shard's window of rows against their plain
version, and the north-star prove through `standard_config(mesh=...)`
held to the same frozen bytes, every shard's launches counted
(`chip_study.py mesh` runs it across four cards).
(`chip_study.py` holds the longer measurements: full-size kernel times,
the two LDE routes at 2^22 and 2^23 rows, the NTT kernels' own device
time, the card's busy share, the FRI host-tail switch.)

The last line is `{"ok": true, "device": {...}}`; the line before it lists
the kernels with their launches (counted on the path named in each row),
errors, times and bounds, at the first prove shape and at every shape
timed against its bound (`shapes`), `dit_cols`'s and `dif_cols`'s two
forms (`forms`), and the launches of the two DIF kernels that
`lde_inverse` runs on and of the two DIT kernels that `lde_forward` runs
on (`kernels`). Any failed phase raises: no result line, non-zero exit.
Without a CUDA device it exits at once. Neither JAX nor the JAX package is
loaded.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import re
import statistics
import subprocess
import sys
import time

# The port needs neither JAX nor the JAX package, and this run shows it:
# neither can be imported in this process.
sys.modules["jax"] = None
sys.modules["tapstark"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

GOLDEN_PROOF_SHA256 = "73a2a6b32e057d641283f4eaaade5cf0c0616474bd5623f803dbf6d975bd2d36"
GOLDEN_PROOF_LEN = 871117
GOLDEN_POW_WITNESS = 198
# (sha256, bytes, PoW witness) of the 2^20 and 2^22 proofs, frozen from a
# run on an H100 of the tree before the SHA-256 kernels' redesign
PROOF_2_20 = ("dd928dd5817e0f7843a90cdbdce3be9990182c238d87dbf21d197809eafb00e6", 4831029, 547)
PROOF_2_22 = ("0ee2cad76352f0e86c973d5fcbf5c57f0220ee7be411b36766e0dd36aea66844", 5316053, 96)

# The script-verifier reports of the golden proof and of the wide row's,
# frozen from the JAX package's run of the same configurations on a CPU
# (`python tools/freeze_port_references.py golden wide`; the report digest
# is `report_digest` below): segment count and the SHA-256 of the sorted
# (name, bytes) pairs, total script bytes, distinct u32 values and the
# SHA-256 of their sorted list, challenger compressions.
GOLDEN_REPORT = {
    "segments": 22,
    "segments_sha256": "3e667bbb75ebe912204c516a49dfe610c7307e4c6a4fbfc9a6794673ddd47161",
    "total_script_bytes": 5451534,
    "distinct_u32_count": 325,
    "u32_sha256": "78ee6337b2808d2a6929bdd8e0330a70f3f31bfb6aaf3469e2c50888f8f7f478",
    "challenger_compressions": 9,
}
# the wide row (SCRIPT_SIZES.md, "Wide-table"): RecursionAir from
# generate_recursion_trace(2^18), proof (sha256, bytes, witness) and report
WIDE_ROW = dict(log_n=18, log_blowup=4, num_queries=16, pow_bits=8, log_final_poly_len=5)
WIDE_PROOF = ("56a64cd1c8a28e9ad6e32c94ab251d078beb0966dcb35404b1cbd40cb21a9848", 4194873, 81)
WIDE_REPORT = {
    "segments": 85,
    "segments_sha256": "7e9c7cd90f3dee384c26566f61de93d2460bf6fac620ac31b6c2e598ba3c66ec",
    "total_script_bytes": 56501576,
    "distinct_u32_count": 5025,
    "u32_sha256": "1576b0c51af478634bf6292b8f5f6699df6017b11c24122671e4eda942b6c7c3",
    "challenger_compressions": 26,
}

# the flagship (`bench_blake3.py 1024 16`, README "Flagship workload"):
# Blake3SpongeChainAir over 1024 compressions of the messages
# `sponge_blocks` makes, 65,536 x 1548, blowup 2, 16 queries, 4 PoW bits.
# The JAX package cannot prove it on the card's host (its flat quotient
# program alone peaks at ~82 GB on a CPU), so its proof is frozen from the
# port's card run, and `tools/freeze_port_references.py blake3_port` showed
# that the JAX package's verify accepts it; at 64 compressions (4096 rows,
# the same settings) the proof is the JAX package's own
# (`freeze_port_references.py blake3`).
BLAKE3 = dict(blocks=1024, log_blowup=1, num_queries=16, pow_bits=4)
BLAKE3_PROOF = ("0698633930bb10f7c58f142b6c1474d531a6289b5e6fc04290a973f2856cf099", 24450581, 17)
BLAKE3_64 = dict(blocks=64, log_blowup=1, num_queries=16, pow_bits=4)
BLAKE3_64_PROOF = ("f82b988b60cd624c16d0d792a5de5077808829a6e297f34dd7e32650459e4e9c", 23827141, 8)
NORTH_STAR = dict(log_n=20, log_blowup=2, num_queries=28, pow_bits=8)
# the next batch size up (bench_prover.py 22:2:28): above the fused LDE
# range, so both LDEs take the blocks route (K3/K4's counterparts)
BLOCKS_PROVE = dict(log_n=22, log_blowup=2, num_queries=28, pow_bits=8)
# (log_n, width, log_blowup): the north star's trace and quotient shapes,
# the golden size, an odd log_n, the wide row's trace and quotient shapes
LDE_SHAPES = [(20, 2, 2), (20, 4, 2), (3, 2, 2), (11, 3, 2), (18, 163, 4), (18, 4, 4)]
# the shapes timed against their bounds (the first heads the JSON row)
LDE_TIMED = [(20, 2, 2), (20, 4, 2), (18, 163, 4), (18, 4, 4)]
# SHA-256 check shapes: one-step lanes (a power of two and a count that is
# a multiple of no block size); the leaf form (repetitions, leaves) with
# 1 suffix block (trace and quotient commits) and 2 (the FRI layers),
# hashing the 4 levels the commit hashes in the leaf launch; TapBranch
# levels 4 -> 8 of a 2^20-leaf commit (28 x 2^16 nodes in); whole trees of
# (repetitions, depth, suffix blocks) through the commit's launch plan
SHA_LANES = [1 << 12, 4099]
SHA_LEAF = (28, 1 << 16)
SHA_LEAF_BLOCKS = [1, 2]
SHA_LEVELS_IN = (28, 1 << 16)
# the wide row's trace shards (163 columns in 5 shards of 32-33 values):
# 16 repetitions, 4 suffix blocks per leaf; the leaf form over 2^16 of the
# 2^22 leaves, and TapBranch levels 4 -> 8 over the 2^18 nodes a shard's
# leaf launch writes
SHA_WIDE_LEAF = (16, 1 << 16, 4)
SHA_WIDE_LEVELS_IN = (16, 1 << 18)
SHA_TREES = [(28, 5, 1), (3, 13, 2)]
# column-NTT check shapes (log R, B): the 2^22 prove's (the inverse and
# forward members of the trace's LDE, width 2, and of the quotient
# chunk's, width 4), a lane count that is no multiple of the lane tile,
# the golden padded route's, `lde_inverse`'s column form at 2^20 (narrowed
# tiles); and each kernel's (log R, B, inverse) at the prove's shapes,
# trace first (timed against their bounds for the JSON row; the column
# forms head the rows of `dit_cols` and `dif_cols`)
COLS_SHAPES = [(11, 4096), (11, 16384), (11, 8192), (11, 32768), (12, 3000), (2, 4), (3, 4), (9, 4096)]
COLS_REPORTED = {"dit_cols": [(11, 16384, False), (11, 32768, False)],
                 "dif_cols": [(11, 4096, True), (11, 8192, True)]}
# `dit_cols`'s first-member form (log_n, w, log_blowup, with 1/n): the 2^22
# prove's trace and quotient LDEs (reported, trace first), an odd log_n of
# width 3
FIRST_SHAPES = [(22, 2, 2, True), (22, 4, 2, True), (7, 3, 1, False)]
# `dif_cols`'s last-member form (log_n, w, with 1/n), over the column
# form's output: the 2^22 prove's trace and quotient LDEs (reported, trace
# first), an odd log_n of width 3 with 1/n, and 2^23 (odd, R = 2C)
LAST_SHAPES = [(22, 2, False), (22, 4, False), (7, 3, True), (23, 2, False)]
# limb-matmul check shapes (log R, B, with twiddle, width of the next-level
# form): the 2^20 matmul LDE's first inverse member (128 x 2^13 * 2,
# twiddle in the epilogue) and without it, a member of 2^6 rows, the
# padded small member, and the LDE's first forward member (128 x 2^13 * 8);
# each checked in both output forms. The inverse and forward members with
# twiddle are timed against their bounds in the next-level form, the one
# `ntt_matmul` launches (the first heads the JSON row).
MATMUL_SHAPES = [(7, 1 << 14, True, 2), (7, 1 << 14, False, 2), (6, 1000, True, 8), (3, 4, False, 4),
                 (7, 1 << 16, True, 8)]
MATMUL_TIMED = [(7, 1 << 14, True), (7, 1 << 16, True)]
# extreme canonical inputs (every word p - 2 = 0x77FFFFFF, or p - 1), at
# (R, B, width): the largest byte limbs the kernel's buckets must hold
MATMUL_EXTREMES = ((0x77FFFFFF, 0x78000000), (7, 4096, 2))
# the LDE routes held against the fused one (log_n, route), width 2, blowup 4
LDE_ROUTES = [(22, "blocks"), (20, "limb matmul")]
KERNELS = [  # name, replaced TPU kernel, source, path whose launches the JSON line reports
    ("lde_inverse", "tapstark/poly/pallas_ntt.py:480", "tapstark_torch/csrc/dif_cols.cuh", "prove 2^20"),  # K1
    ("lde_forward", "tapstark/poly/pallas_ntt.py:492", "tapstark_torch/csrc/dit_cols.cuh", "prove 2^20"),  # K2
    ("dit_cols", "tapstark/poly/pallas_ntt.py:88", "tapstark_torch/csrc/dit_cols.cuh", "prove 2^22"),  # K3
    ("dif_cols", "tapstark/poly/pallas_ntt.py:219", "tapstark_torch/csrc/dif_cols.cuh", "prove 2^22"),  # K4
    ("tapleaf_subtrees", "tapstark/hashes/sha256_device.py:76", "tapstark_torch/csrc/sha256.cu", "prove 2^20"),  # K5
    ("tapbranch_levels", "tapstark/hashes/sha256_device.py:354", "tapstark_torch/csrc/sha256.cu", "prove 2^20"),  # K6
    ("mod_matmul", "tapstark/poly/matmul_ntt.py:165", "tapstark_torch/csrc/matmul_ntt.cu", "matmul lde 2^20"),  # K7
    # no Pallas kernel: the JAX package's one-jit constraint folder; the
    # kernels are generated per AIR (air/codegen.py) around csrc/quotient.cuh
    ("quotient_program", "tapstark/stark/prover.py:127", "tapstark_torch/csrc/quotient.cuh", "blake3 sponge"),
    # no Pallas kernel: the JAX package's row gather of the coset; the card's writes it by columns
    ("bit_reverse_cols", "tapstark/fri/pcs.py:191", "tapstark_torch/csrc/bitrev_cols.cu", "blake3 sponge"),
    # no Pallas kernel: the JAX package jits the FRI transcript step (`_step`) as jnp
    ("transcript_step", "tapstark/challenger/device_tail.py:106", "tapstark_torch/csrc/transcript.cu", "prove 2^20"),
]
# the FRI transcript step against its plain version: chains of 3 steps at
# each (compression, pending input words, R roots); the 2^20 / 2^22
# proves' 28 repetitions (the JSON row's, timed first) and the wide row's
# and flagship's 16, timed against the bound, and the most one blake3
# chunk holds, 32
TRANSCRIPT_CHAINS = [(kind, pending, reps) for kind in ("blake3", "test") for pending in (0, 3, 8, 11)
                     for reps in (28, 16, 32)]
TRANSCRIPT_TIMED = [("blake3", 0, 28), ("blake3", 0, 16)]
# device transcript chain steps a prove takes: one per FRI layer folded on
# the card, i.e. of more than fri/prover.py HOST_TAIL_MAX_HALF = 2^13 rows
# after the fold: 2^20 rows x blowup 4 folds 2^22 -> 2^14 (8 layers), 2^22
# x 4: 2^24 -> 2^14 (10), the wide row 2^18 x 16: 2^22 -> 2^14 (8), the
# flagship 2^16 x 2: 2^17 -> 2^14 (3); the golden 2^3 x 4 and the
# 64-compression sponge (2^12 x 2) fold on the host only
CHAIN_STEPS = {"golden": 0, "north star": 8, "blocks route": 10, "wide row": 8, "blake3 sponge": 3,
               "blake3 sponge 64": 0}
# the coset gather against its plain version: (LDE rows, width, coset rows)
# at the flagship's, the wide row's, Fibonacci 2^22's and 2^20's (timed
# against the bound, the flagship's first, the JSON row's), and the
# golden proof's
BITREV_SHAPES = [(1 << 17, 1548, 1 << 17), (1 << 22, 163, 1 << 18), (1 << 24, 2, 1 << 22), (1 << 22, 2, 1 << 20),
                 (32, 2, 8)]
# the quotient kernel against the eager folder: (what, AIR, log_n of the
# trace) at each prove's quotient coset (trace rows times the AIR's
# quotient degree), the flagship's first (the JSON row's)
QUOTIENT_SHAPES = [("blake3 sponge", "sponge", 16), ("fibonacci 2^20", "fibonacci", 20),
                   ("fibonacci 2^22", "fibonacci", 22), ("wide row", "recursion", 18)]
# the mesh phase: MESH_SHARDS shards, all on the card (every shard's kernels
# and exchanges run, nothing crosses a link; chip_study.py mesh runs the
# same checks across four cards). The distributed NTT and coset LDE at the
# north star's trace (log_n, width, log_blowup); the sharded prover step at
# 2^MESH_STEP_LOG_N trace rows (Fibonacci, blowup 2); `dit_cols` at its
# per-shard shapes in the north star's LDE over 4 shards, (log R, B): the
# forward transform's 2^22 points split 2^11 x 2^11, each shard 2^9
# columns of width 2, the inverse's 2^20 split 2^10 x 2^10
MESH_SHARDS = 4
MESH_LDE = (20, 2, 2)
MESH_STEP_LOG_N = 20
MESH_COLS = [(11, 1024), (10, 512)]
# the paths whose launches the JSON line's `dit_cols` and `quotient_program`
# rows also report (`mesh`)
MESH_PATHS = ("mesh step", "mesh prove 2^20")

# the phase "surface": the gather-free coset LDE at the north star's trace
# and the wide row's, (log_n, width, log_blowup); its halves at the first;
# the SHA-256 batch API over SURFACE_LANES lanes, SURFACE_SAMPLE of them
# held to hashlib; `interpolate_coset` on the wide row's LDE, no single
# allocation above SURFACE_MAX_ALLOC bytes
SURFACE_LDE = [(20, 2, 2), (18, 163, 4)]
SURFACE_LANES = 1 << 20
SURFACE_SAMPLE = 64
SURFACE_MAX_ALLOC = 512 << 20

# Bounds. The card's peaks (NVIDIA H100 SXM, 700 W): 3.35 TB/s of device
# memory and, for the 32-bit integer instructions the kernels run, one
# instruction per lane per clock on all 128 lanes of an SM (its four
# schedulers each issue one 32-lane warp instruction per clock):
# 132 SMs x 128 x 1.98 GHz = 33.5 T op/s, half the 67 TFLOP/s
# float32 figure, which counts two flops per FMA. Of those lanes the int32
# ALU pipe (funnel shifts, LOP3) has 64: 16.7 T op/s; IMAD-form adds,
# shifts and multiplies take the FMA pipe, the other 64.
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
ALU_OPS_PER_S = 132 * 64 * 1.98e9
# dense int8 tensor-core rate (H100 SXM data sheet), two ops per MAC
INT8_TENSOR_OPS_PER_S = 1979e12
# 32-bit integer instructions per unit of work, the fewest each needs:
OPS_MONT_MUL = 8  # a Montgomery product (mul.wide, mul.lo, mul.hi, adds, select)
OPS_SHOUP_MUL = 3  # w * x - umulhi(ws, x) * p: umulhi and two IMADs, in [0, 2p)
OPS_REDUCE = 2  # [0, 2p) -> [0, p): a subtract and an unsigned min
# a lazy Shoup DIT/DIF butterfly (K1-K4): the product, both inputs
# reduced to [0, p), an add and a subtract (IADD3 with p)
OPS_SHOUP_BUTTERFLY = OPS_SHOUP_MUL + 2 * OPS_REDUCE + 2
# SHA-256, by the pipes that can issue each instruction: (ALU only: LOP3
# logic and the sort's compares and selects; rotates: one funnel shift on
# the ALU pipe, or two IMADs on the FMA pipe, x * 2^(32-n) + mulhi(x,
# 2^(32-n)); shifts: one funnel shift, or one IMAD.HI; adds: IADD3 or
# IMAD, either pipe). A round is four LOP3, six rotates and four adds; a
# schedule word two LOP3, four rotates, two shifts and two adds; a
# compression adds eight for its feed-forward; a TapBranch node sorts its
# two digests (24), then compresses them and the constant block.
SHA_ROUND, SHA_SCHEDULE = np.array([4, 6, 0, 4]), np.array([2, 4, 2, 2])
SHA_FEED_FORWARD, SHA_SORT = np.array([0, 0, 0, 8]), np.array([24, 0, 0, 0])
SHA_COMPRESS = 64 * SHA_ROUND + 48 * SHA_SCHEDULE + SHA_FEED_FORWARD
SHA_TAPBRANCH = SHA_SORT + SHA_COMPRESS + 64 * SHA_ROUND + SHA_FEED_FORWARD
# the limb matmul (K7): four byte limbs of a word of x are a 4 x 4 byte
# transpose, 8 byte permutes for 4 words; an output folds its 7 buckets by
# 7 wide multiply-adds into a 64-bit sum, then one Montgomery reduction
# (mul.lo, mul.hi, a compare and an add for the carry, a subtract and a
# select)
OPS_BYTE_LIMBS = 2
OPS_ONE_REDUCTION = 7 + 6
# the constraint program (quotient kernels) a row: a Montgomery product each
# mul, an add or subtract with its select each add/sub (IADD3, compare,
# select), a negation two. A fold adds x * alpha^k to the quartic
# accumulator, k from a table: two folds share each coordinate's
# reduction, so a coordinate of a pair is two wide multiply-adds, one
# reduction (a product less its wide multiply) and one add: 24 a fold.
# The last four products by 1/zeroifier. The selectors, where the program
# reads them: the coset point (one product of two table words),
# is_transition a subtract; is_first_row and is_last_row a subtract each,
# then inverted in one batch over the coset (Montgomery's trick: three
# products a row each, and one inverse, 30 squares and 11 products by
# Fermat, for the whole coset; 24 instructions a row cost less time than
# reading a precomputed word, 4 bytes), and each times zh (a table word).
OPS_ADD = 3
OPS_NEG = 2
OPS_FOLD = 4 * (2 + (OPS_MONT_MUL - 1) + OPS_ADD) // 2
OPS_BATCH_INVERSE = 3 * OPS_MONT_MUL
OPS_INVERSE = 41 * OPS_MONT_MUL
# a blake3 compression (the transcript step): 7 rounds of 8 G functions,
# each four adds (IADD3), four XORs (LOP3) and four rotates, then 8 XORs
# for the output; a root word's byte swap (one PRMT); a TestPermutation
# step 4 instructions a word; to_mont of a popped word, a reduction mod p
# (2) and a Montgomery product
OPS_BLAKE3_COMPRESS = 7 * 8 * 12 + 8
OPS_TEST_PERMUTATION = 4 * 8

def bound(ops: float, nbytes: float) -> tuple[float, str, dict]:
    """(ms, what bounds it, both times in ms): the larger of the two
    roofline times."""
    times = {"bytes": 1e3 * nbytes / MEM_BYTES_PER_S, "operations": 1e3 * ops / INT32_OPS_PER_S}
    by = max(times, key=times.get)
    return times[by], by, times


def alu_pipe_least(alu: float, rotates: float, shifts: float, adds: float) -> float:
    """The fewest instructions the ALU pipe must issue, over every split of
    the rotates, shifts and adds between the two 64-lane pipes: the ALU
    pipe's share once neither pipe holds more than the other. Shifts and
    adds move one for one; a rotate moved costs the FMA pipe two."""
    fixed, free = alu + rotates, shifts + adds
    if fixed <= free:
        return (fixed + free) / 2
    return fixed - min(rotates, (fixed - free) / 3)


def sha_bound(compressions: float, nodes: float, nbytes: float) -> tuple[float, str, dict]:
    """(ms, what bounds it, the three times in ms) for SHA-256 work: the
    larger of the bytes at 3.35 TB/s, all instructions at 33.5 T op/s and
    the ALU-pipe instructions at 16.7 T op/s, these at the split of the
    work between the pipes that needs the least time (`alu_pipe_least`;
    the FMA pipe then issues as many, so the all-instructions time, taken
    at the fewest instructions, never binds). `bound_by` says "operations"
    for either of the last two; the dict names which."""
    work = [float(x) for x in compressions * SHA_COMPRESS + nodes * SHA_TAPBRANCH]
    times = {"bytes": 1e3 * nbytes / MEM_BYTES_PER_S, "operations": 1e3 * sum(work) / INT32_OPS_PER_S,
             "alu pipe": 1e3 * alu_pipe_least(*work) / ALU_OPS_PER_S}
    by = max(times, key=times.get)
    return times[by], "bytes" if by == "bytes" else "operations", times


def subtree_nodes(m: int, levels: int, write_first: int) -> tuple[int, int]:
    """(TapBranch nodes, nodes written) of `levels` levels over m nodes."""
    return (sum(m >> l for l in range(1, levels + 1)),
            sum(m >> l for l in range(write_first, levels + 1)))


def leaf_bound(r: int, n: int, nb: int, levels: int) -> tuple[float, str, dict]:
    """`tapleaf_subtrees`: R x N lanes of nb compressions and the TapBranch
    nodes of `levels` levels; suffix, remainder and midstates read once,
    level `levels` written once."""
    nodes, written = subtree_nodes(r * n, levels, levels)
    return sha_bound(r * n * nb, nodes, 4 * (16 * nb * n + 16 * nb * r + 8 * r) + 32 * written)


def levels_bound(r: int, n: int, levels: int, write_first: int) -> tuple[float, str, dict]:
    """`tapbranch_levels` over (R, n) nodes: the level read once, the
    levels from write_first written once."""
    nodes, written = subtree_nodes(r * n, levels, write_first)
    return sha_bound(0, nodes, 32 * (r * n + written))


def lde_bounds(log_n: int, w: int, log_blowup: int) -> dict:
    """K1: an n-point Shoup DIF transform, each element times 1/n once (a
    Shoup product) and made canonical once; K2: blow n-point Shoup DIT
    transforms, each element scaled once and made canonical once; each
    input read once, each output and the twiddle and scale tables read or
    written once."""
    n, blow = 1 << log_n, 1 << log_blowup
    inverse_ops = n // 2 * log_n * OPS_SHOUP_BUTTERFLY + n * (OPS_SHOUP_MUL + OPS_REDUCE)
    forward_ops = n // 2 * log_n * OPS_SHOUP_BUTTERFLY + n * (OPS_SHOUP_MUL + OPS_REDUCE)
    return {
        "lde_inverse": bound(w * inverse_ops, 4 * (2 * n * w + n // 2)),
        "lde_forward": bound(blow * w * forward_ops, 4 * (n * w + blow * n + n // 2 + blow * n * w)),
    }


def first_bound(log_n: int, w: int, log_blowup: int) -> tuple[float, str, dict]:
    """`dit_cols`'s first member on (n, w), blowup 2^log_blowup: the
    R-point Shoup DIT over C·blow·w lanes, two Shoup products per element
    (block scale, outer twiddle) and a canonical store; the coefficients
    read once, the (C, R·blow·w) output written once, and its tables
    (stage pairs, scales, outer twiddle halves) read once."""
    log_c = log_n // 2
    log_r, h = log_n - log_c, (log_n + 1) // 2
    r, c, blow = 1 << log_r, 1 << log_c, 1 << log_blowup
    lanes = c * blow * w
    ops = r // 2 * log_r * lanes * OPS_SHOUP_BUTTERFLY + r * lanes * (2 * OPS_SHOUP_MUL + OPS_REDUCE)
    nbytes = 4 * (r * c * w + r * lanes) + 8 * (r - 1 + blow * (r + c)) + 4 * ((1 << h) + (1 << (log_n - h)))
    return bound(ops, nbytes)


def last_bound(log_n: int, w: int) -> tuple[float, str, dict]:
    """`dif_cols`'s last member on (R, C·w): the C-point Shoup DIF over w
    lanes of each of the R rows, one Shoup product per element (the outer
    twiddle, with 1/n folded in) and a canonical store; the input read
    once, the (n, w) output written once, and its tables (stage pairs,
    outer twiddle halves) read once."""
    log_c = log_n // 2
    h = (log_n + 1) // 2
    n, c = 1 << log_n, 1 << log_c
    ops = n // 2 * log_c * w * OPS_SHOUP_BUTTERFLY + n * w * (OPS_SHOUP_MUL + OPS_REDUCE)
    nbytes = 4 * 2 * n * w + 8 * (c - 1) + 4 * ((1 << h) + (1 << (log_n - h)))
    return bound(ops, nbytes)


def cols_bound(log_r: int, b: int) -> tuple[float, str, dict]:
    """`dit_cols`/`dif_cols` on (R, B): (R/2)·log R·B lazy Shoup
    butterflies and a canonical store per element, the matrix read once
    and written once."""
    r = 1 << log_r
    return bound(r // 2 * log_r * b * OPS_SHOUP_BUTTERFLY + r * b * OPS_REDUCE, 8 * r * b)


def matmul_bound(log_r: int, b: int, with_tw: bool) -> tuple[float, str, dict]:
    """`mod_matmul` on (R, B): the larger of 16·R²·B u8 MACs (four byte
    limbs of W and of x) at the dense int8 tensor rate, the int32 byte
    split and one-reduction epilogue (and the twiddle's Montgomery product)
    at the issue rate, and the bytes (x, the twiddles, the output, W's 4
    byte planes)."""
    r = 1 << log_r
    ops = OPS_BYTE_LIMBS + OPS_ONE_REDUCTION + (OPS_MONT_MUL if with_tw else 0)
    times = {
        "bytes": 1e3 * (4 * r * b * (3 if with_tw else 2) + 4 * r * r) / MEM_BYTES_PER_S,
        "int8 tensor": 1e3 * 2 * 16 * r * r * b / INT8_TENSOR_OPS_PER_S,
        "int32": 1e3 * r * b * ops / INT32_OPS_PER_S,
    }
    by = max(times, key=times.get)
    return times[by], "bytes" if by == "bytes" else "operations", times


def quotient_bound(counts: dict, selectors: set, m: int, width: int) -> tuple[float, str, dict]:
    """The quotient kernels over an (m, width) coset for a program of
    `counts` instructions that reads `selectors` (SEL_* indices): its field
    operations and the selectors' at the issue rate (OPS_* above), and the
    bytes: the coset read once, the (m, 4) quotient written once. The
    values carried across cuts are not the function's work: they stay out."""
    from tapstark_torch.air.program import SEL_FIRST, SEL_LAST, SEL_TRANSITION

    per_row = (counts["mul"] * OPS_MONT_MUL + (counts["add"] + counts["sub"]) * OPS_ADD + counts["neg"] * OPS_NEG
               + counts["fold"] * OPS_FOLD + 4 * OPS_MONT_MUL)
    if selectors:  # the coset point
        per_row += OPS_MONT_MUL
    if SEL_TRANSITION in selectors:
        per_row += OPS_ADD
    inverted = len(selectors & {SEL_FIRST, SEL_LAST})  # each a denominator, its batched inverse, a product by zh
    per_row += inverted * (OPS_ADD + OPS_BATCH_INVERSE + OPS_MONT_MUL)
    return bound(m * per_row + (OPS_INVERSE if inverted else 0), 4 * m * (width + 4))
    return bound(m * per_row, 4 * m * (width + 4))

def transcript_bound(kind: str, pending: int, reps: int) -> tuple[float, str, dict]:
    """`transcript_step`: ceil(R / 2) blake3 compressions for the digest,
    R * 8 byte swaps, one duplex step (two with 8 or more pending words),
    four popped words to Montgomery form; the roots, cv and pending words
    read once, the 16 output words written once. The compressions are a
    dependent chain, which the bound does not charge: it is the card's
    least time for the same work, not for one thread."""
    duplex = 2 if pending > 8 else 1  # pending || digest: a full block, then the rest
    ops = (-(-reps // 2) * OPS_BLAKE3_COMPRESS + 8 * reps
           + duplex * (OPS_BLAKE3_COMPRESS if kind == "blake3" else OPS_TEST_PERMUTATION)
           + 4 * (2 + OPS_MONT_MUL))
    return bound(ops, 4 * (8 * reps + 8 + pending + 16))


# Kernels that must build without spilling (ptxas's report): the SHA-256
# kernels and the two DIT and two DIF kernels, each at its 64-register cap,
# and the limb-matmul kernel at each padded R.
NO_SPILL = ("tapleaf_subtrees", "tapbranch_levels", "dit_cols_kernel", "dit_first_kernel", "dif_cols_kernel",
            "dif_last_kernel", "mod_matmul_kernel")


def check_ptxas(report: str) -> None:
    """Print ptxas's register and spill lines for each kernel; fail if a
    kernel of NO_SPILL spills, or if the report gives no spill line for
    one of them."""
    entry, seen, spills = "", set(), []
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            print(f"ptxas {entry}: {line.split(':', 1)[-1].strip()}")
            for kernel in NO_SPILL:
                if kernel in entry and "spill" in line:
                    seen.add(kernel)
                    if any(int(b) for b in re.findall(r"(\d+) bytes spill", line)):
                        spills.append((entry, line.strip()))
    missing = set(NO_SPILL) - seen
    if missing:
        raise AssertionError(f"ptxas's report gives no spill line for {sorted(missing)}")
    if spills:
        raise AssertionError(f"kernels spill: {spills}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def make_config(num_queries: int, log_blowup: int, pow_bits: int, device):
    from tapstark_torch.commit import BcManager, TapTreeMmcs
    from tapstark_torch.fri import FriConfig, TwoAdicFriPcs

    fri = FriConfig(
        log_blowup=log_blowup,
        num_queries=num_queries,
        proof_of_work_bits=pow_bits,
        mmcs=TapTreeMmcs(BcManager(), num_queries, ext=True),
    )
    return TwoAdicFriPcs(TapTreeMmcs(BcManager(), num_queries, ext=False), fri, device)


def prove_fibonacci(log_n: int, log_blowup: int, num_queries: int, pow_bits: int, device, emit: bool = False,
                    pcs=None):
    """Prove and verify Fibonacci through the port (trace generation is not
    timed), and with `emit` emit and execute its script verifier; returns
    {"data": proof bytes, "witness", "prove_s", "verify_s", "report"
    (None without `emit`), "emit_s"}. The PCS is `make_config`'s on
    `device`, or `pcs` where given."""
    from tapstark_torch.airs import FibonacciAir, generate_fibonacci_trace
    from tapstark_torch.challenger import BfChallenger
    from tapstark_torch.field import F
    from tapstark_torch.stark import prove, verify
    from tapstark_torch.stark.script_verifier import generate_script_verifier
    from tapstark_torch.stark.serde import proof_from_bytes, proof_to_bytes

    if pcs is None:
        pcs = make_config(num_queries, log_blowup, pow_bits, device)
    trace = generate_fibonacci_trace(0, 1, 1 << log_n)
    pis = [F(0), F(1), F(int(trace[-1, 1]))]
    t0 = time.perf_counter()
    proof = prove(pcs, FibonacciAir(), BfChallenger(), trace, pis)  # ends on the host
    t1 = time.perf_counter()
    data = proof_to_bytes(proof)
    verify(pcs, FibonacciAir(), BfChallenger(), proof_from_bytes(data), pis)
    t2 = time.perf_counter()
    report = generate_script_verifier(pcs, FibonacciAir(), BfChallenger(), proof, pis) if emit else None
    t3 = time.perf_counter()
    return {"data": data, "witness": proof.opening_proof.pow_witness, "prove_s": t1 - t0,
            "verify_s": t2 - t1, "report": report, "emit_s": t3 - t2}


def report_digest(report) -> dict:
    """The numbers of a ScriptVerifierReport that GOLDEN_REPORT and
    WIDE_REPORT freeze."""
    seg = report.segment_script_bytes
    return {
        "segments": len(seg),
        "segments_sha256": hashlib.sha256(json.dumps(sorted(seg.items())).encode()).hexdigest(),
        "total_script_bytes": report.total_script_bytes,
        "distinct_u32_count": report.distinct_u32_count,
        "u32_sha256": hashlib.sha256(json.dumps(sorted(report.u32_values)).encode()).hexdigest(),
        "challenger_compressions": report.challenger_compressions,
    }


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, where) -> int:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name} shape {tuple(got.shape)} != plain {tuple(want.shape)} at {where}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
    if err != 0:
        raise AssertionError(f"{name} differs from plain at {where}: {err}")
    return err


def record(stats: dict, name: str, err: int, run_kernel, run_plain, where, bnd=None, form=None) -> None:
    """Time kernel and plain version and print them; with a bound `bnd`
    (ms, what bounds it, the times it is the larger of), print it and keep
    the numbers among the kernel's `shapes`, with `form` for a kernel of
    two forms. `kernel_rows` heads each JSON row with its first `shapes`
    entry, and each form with the form's first."""
    ms = median_ms(run_kernel, 20)
    plain_ms = median_ms(run_plain, 5)
    s = stats.setdefault(name, {"max_abs_err": 0, "shapes": []})
    s["max_abs_err"] = max(s["max_abs_err"], err)
    extra = ""
    if bnd is not None:
        extra = f", bound {bnd[0]:.4f} ms ({bnd[1]}) = max(" + ", ".join(f"{k} {v:.4f}" for k, v in bnd[2].items()) + ")"
        s["shapes"].append({"at": where, **({"form": form} if form else {}),
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1]})
    label = f"{name} ({form})" if form else name
    print(f"kernel {label} {where}: equal, {ms:.4f} ms, plain {plain_ms:.4f} ms{extra}", flush=True)


def check_lde_kernels(dev, stats: dict) -> None:
    """K1/K2's counterparts against their plain versions at every listed shape."""
    from tapstark_torch.field.constants import MULT_GENERATOR as shift
    from tapstark_torch.field.constants import P
    from tapstark_torch.field.device import np_to_mont
    from tapstark_torch.poly import cuda_ntt

    rng = np.random.default_rng(0)
    for log_n, w, log_blowup in LDE_SHAPES:
        canon = rng.integers(0, P, (1 << log_n, w)).astype(np.uint32)
        evals = torch.from_numpy(np_to_mont(canon).view(np.int32)).to(dev)
        coeffs = cuda_ntt.lde_inverse(evals)
        where = f"log_n={log_n} w={w} log_blowup={log_blowup}"
        bounds = lde_bounds(log_n, w, log_blowup) if (log_n, w, log_blowup) in LDE_TIMED else {}
        err = compare("lde_inverse", coeffs, cuda_ntt.lde_inverse_plain(evals), where)
        record(stats, "lde_inverse", err, lambda: cuda_ntt.lde_inverse(evals),
               lambda: cuda_ntt.lde_inverse_plain(evals), where, bounds.get("lde_inverse"))
        got = cuda_ntt.lde_forward(coeffs, log_blowup, shift)
        err = compare("lde_forward", got, cuda_ntt.lde_forward_plain(coeffs, log_blowup, shift), where)
        record(stats, "lde_forward", err, lambda: cuda_ntt.lde_forward(coeffs, log_blowup, shift),
               lambda: cuda_ntt.lde_forward_plain(coeffs, log_blowup, shift), where,
               bounds.get("lde_forward"))
        del evals, coeffs, got


def _mont_on(dev, rng, *shape) -> torch.Tensor:
    from tapstark_torch.field.constants import P
    from tapstark_torch.field.device import np_to_mont

    return torch.from_numpy(np_to_mont(rng.integers(0, P, shape).astype(np.uint32)).view(np.int32)).to(dev)


def check_cols_kernels(dev, stats: dict) -> None:
    """K3/K4's counterparts against their plain versions at every
    COLS_SHAPES entry, in both directions, then `dit_cols`'s first-member
    form at every FIRST_SHAPES entry and `dif_cols`'s last-member form at
    every LAST_SHAPES entry."""
    from tapstark_torch.field.constants import MULT_GENERATOR as shift
    from tapstark_torch.poly import cols_ntt

    rng = np.random.default_rng(5)
    for log_r, b in COLS_SHAPES:
        x = _mont_on(dev, rng, 1 << log_r, b)
        for inverse in (False, True):
            where = f"R=2^{log_r} B={b} inverse={inverse}"
            for name, kernel, plain, form in (
                ("dit_cols", cols_ntt.dit_cols, cols_ntt.dit_cols_plain, "cols"),
                ("dif_cols", cols_ntt.dif_cols, cols_ntt.dif_cols_plain, "cols"),
            ):
                err = compare(name, kernel(x, log_r, inverse), plain(x, log_r, inverse), where)
                bnd = cols_bound(log_r, b) if (log_r, b, inverse) in COLS_REPORTED[name] else None
                record(stats, name, err, lambda: kernel(x, log_r, inverse), lambda: plain(x, log_r, inverse),
                       where, bnd, form)
    for log_n, w, log_blowup, n_inv in FIRST_SHAPES:
        x = _mont_on(dev, rng, 1 << log_n, w)
        where = f"first member n=2^{log_n} w={w} log_blowup={log_blowup} 1/n={n_inv}"
        run = lambda: cols_ntt.dit_cols_first(x, log_blowup, shift, n_inv)  # noqa: E731
        plain = lambda: cols_ntt.dit_cols_first_plain(x, log_blowup, shift, n_inv)  # noqa: E731
        err = compare("dit_cols", run(), plain(), where)
        bnd = first_bound(log_n, w, log_blowup) if (log_n, w, log_blowup, n_inv) in FIRST_SHAPES[:2] else None
        record(stats, "dit_cols", err, run, plain, where, bnd, "first")
        del x
    for log_n, w, n_inv in LAST_SHAPES:
        log_r, log_c = cols_ntt.split(log_n)
        a = cols_ntt.dif_cols(_mont_on(dev, rng, 1 << log_r, w << log_c), log_r, True)
        where = f"last member n=2^{log_n} w={w} 1/n={n_inv}"
        run = lambda: cols_ntt.dif_cols_last(a, log_c, n_inv)  # noqa: E731
        plain = lambda: cols_ntt.dif_cols_last_plain(a, log_c, n_inv)  # noqa: E731
        err = compare("dif_cols", run(), plain(), where)
        bnd = last_bound(log_n, w) if (log_n, w, n_inv) in LAST_SHAPES[:2] else None
        record(stats, "dif_cols", err, run, plain, where, bnd, "last")
        del a


def int_mm_dots_ms(x: torch.Tensor, log_r: int, inverse: bool) -> float:
    """The library yardstick for K7: its 25 int8 limb dots alone (no limb
    split, no recombination) through `torch._int_mm`, median of 20."""
    from tapstark_torch.poly import matmul_ntt as mm

    limbs_w = torch.from_numpy(mm.w_matrix_limbs(log_r, inverse)).to(x.device)
    limbs_x = [((x >> (7 * b)) & 0x7F).to(torch.int8) for b in range(5)]
    return median_ms(lambda: [torch._int_mm(limbs_w[a], limbs_x[b]) for a in range(5) for b in range(5)], 20)


def check_matmul_kernel(dev, stats: dict) -> None:
    """K7's counterpart against its plain version at every MATMUL_SHAPES
    entry and on the extreme inputs, in both directions and both output
    forms (natural, and written for the next level); the MATMUL_TIMED
    shapes' next-level form is timed against its bound (inverse first: the
    JSON row's), with the 25 limb dots through `torch._int_mm` as the
    library time at the first."""
    from tapstark_torch.field.constants import P
    from tapstark_torch.poly import matmul_ntt as mm

    rng = np.random.default_rng(6)
    for log_r, b, with_tw, width in MATMUL_SHAPES:
        x = torch.from_numpy(rng.integers(0, P, (1 << log_r, b)).astype(np.int32)).to(dev)  # canonical
        tw = _mont_on(dev, rng, 1 << log_r, b) if with_tw else None
        timed = (log_r, b, with_tw) in MATMUL_TIMED
        for inverse in (True, False):
            for form, wd in (("natural", None), ("next level", width)):
                where = f"R=2^{log_r} B={b} twiddle={with_tw} inverse={inverse} form={form} w={wd}"
                run = lambda: mm.mod_matmul(x, log_r, inverse, tw, wd)  # noqa: E731
                plain = lambda: mm.mod_matmul_plain(x, log_r, inverse, tw, wd)  # noqa: E731
                err = compare("mod_matmul", run(), plain(), where)
                record(stats, "mod_matmul", err, run, plain, where,
                       matmul_bound(log_r, b, with_tw) if timed and wd else None)
            if (log_r, b, with_tw) == MATMUL_TIMED[0] and inverse:
                lib_ms = int_mm_dots_ms(x, log_r, inverse)
                stats["mod_matmul"]["library_ms"] = lib_ms
                print(f"library: the 25 limb dots alone through torch._int_mm at R=2^{log_r} B={b}: {lib_ms:.4f} ms")
    values, (log_r, b, width) = MATMUL_EXTREMES
    tw = _mont_on(dev, rng, 1 << log_r, b)
    for value in values:
        x = torch.full((1 << log_r, b), value, dtype=torch.int32, device=dev)
        for inverse in (True, False):
            for t in (None, tw):
                for wd in (None, width):
                    where = f"extreme x={value:#x} R=2^{log_r} B={b} twiddle={t is not None} inverse={inverse} w={wd}"
                    compare("mod_matmul", mm.mod_matmul(x, log_r, inverse, t, wd),
                            mm.mod_matmul_plain(x, log_r, inverse, t, wd), where)
        print(f"mod_matmul extreme x={value:#x}: equal in both directions and forms, with and without twiddle",
              flush=True)


def check_sha_kernels(dev, stats: dict) -> None:
    """K5/K6's counterparts against their plain versions: the one-step forms
    (`compress_wm`, `tapbranch_wm`, which run on the two kernels), the leaf
    form with the leaf launch's levels, TapBranch levels 4 -> 8, and whole
    trees through the commit's launch plan (`shard_trees_rep_group` on the
    card against the same on CPU tensors, where it runs the plain
    versions)."""
    from tapstark_torch.commit import device_commit as dc
    from tapstark_torch.commit.tcs import LEVEL_CUTOFF
    from tapstark_torch.hashes import sha256_device as sd

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def words(*shape):  # uniform 32-bit words, made on the card
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device=dev, generator=gen)

    for m in SHA_LANES:
        state, block = words(8, m), words(32, m)  # two chained blocks per lane
        where = f"one-step M={m} nb=2"
        err = compare("tapleaf_subtrees", sd.compress_wm(state, block), sd.compress_wm_plain(state, block), where)
        record(stats, "tapleaf_subtrees", err, lambda: sd.compress_wm(state, block),
               lambda: sd.compress_wm_plain(state, block), where)
        h1, h2 = words(8, m), words(8, m)
        h2[:, ::3] = h1[:, ::3]  # equal pairs exercise the lexicographic tie
        h2[0, 1::3] = h1[0, 1::3]  # so do pairs that first differ past word 0
        where = f"one-step M={m}"
        err = compare("tapbranch_levels", sd.tapbranch_wm(h1, h2), sd.tapbranch_wm_plain(h1, h2), where)
        record(stats, "tapbranch_levels", err, lambda: sd.tapbranch_wm(h1, h2),
               lambda: sd.tapbranch_wm_plain(h1, h2), where)

    r, n = SHA_LEAF
    levels = sd.LEAF_LEVELS
    for nb in SHA_LEAF_BLOCKS:
        mids, suffix, rem = words(8, r), words(16 * nb, n), words(16 * nb, r)
        where = f"leaf form R={r} N={n} nb={nb} levels={levels}"
        err = compare("tapleaf_subtrees", sd.tapleaf_subtrees(mids, suffix, rem, levels),
                      sd.tapleaf_subtrees_plain(mids, suffix, rem, levels), where)
        # the JSON line reports the one-block form (the trace and quotient commits')
        record(stats, "tapleaf_subtrees", err, lambda: sd.tapleaf_subtrees(mids, suffix, rem, levels),
               lambda: sd.tapleaf_subtrees_plain(mids, suffix, rem, levels), where,
               leaf_bound(r, n, nb, levels))

    r, n = SHA_LEVELS_IN
    level = words(8, r, n)
    level[:, :, 1::4] = level[:, :, 0::4]  # equal siblings: the lexicographic tie
    k = LEVEL_CUTOFF - sd.LEAF_LEVELS
    for write_first in (k, 1):  # the cutoff level only (reported), every level
        where = f"levels R={r} n={n} levels={k} write_first={write_first}"
        err = compare("tapbranch_levels", sd.tapbranch_levels(level, k, write_first),
                      sd.tapbranch_levels_plain(level, k, write_first), where)
        record(stats, "tapbranch_levels", err, lambda: sd.tapbranch_levels(level, k, write_first),
               lambda: sd.tapbranch_levels_plain(level, k, write_first), where,
               levels_bound(r, n, k, write_first))

    r, n, nb = SHA_WIDE_LEAF
    mids, suffix, rem = words(8, r), words(16 * nb, n), words(16 * nb, r)
    where = f"wide shard leaf form R={r} N={n} nb={nb} levels={levels}"
    err = compare("tapleaf_subtrees", sd.tapleaf_subtrees(mids, suffix, rem, levels),
                  sd.tapleaf_subtrees_plain(mids, suffix, rem, levels), where)
    record(stats, "tapleaf_subtrees", err, lambda: sd.tapleaf_subtrees(mids, suffix, rem, levels),
           lambda: sd.tapleaf_subtrees_plain(mids, suffix, rem, levels), where, leaf_bound(r, n, nb, levels))
    r, n = SHA_WIDE_LEVELS_IN
    level = words(8, r, n)
    where = f"wide shard levels R={r} n={n} levels={k} write_first={k}"
    err = compare("tapbranch_levels", sd.tapbranch_levels(level, k, k),
                  sd.tapbranch_levels_plain(level, k, k), where)
    record(stats, "tapbranch_levels", err, lambda: sd.tapbranch_levels(level, k, k),
           lambda: sd.tapbranch_levels_plain(level, k, k), where, levels_bound(r, n, k, k))
    del mids, suffix, rem, level

    rng = np.random.default_rng(9)
    for r, depth, nb in SHA_TREES:
        suffix = words(16 * nb, 1 << depth)
        mids = rng.integers(0, 1 << 32, (r, 8), dtype=np.uint64).astype(np.uint32)
        rems = rng.integers(0, 1 << 32, (r, 16 * nb), dtype=np.uint64).astype(np.uint32)
        cutoff = min(LEVEL_CUTOFF, depth)
        got = dc.shard_trees_rep_group(suffix, mids, rems, cutoff)
        want = dc.shard_trees_rep_group(suffix.cpu(), mids, rems, cutoff)
        where = f"tree R={r} depth={depth} nb={nb}"
        for what, g, w in zip(("roots", "kept levels"), got, want):
            compare(f"{where} {what}", g, w.to(dev), where)
        print(f"{where}: roots and kept levels equal to the plain versions'", flush=True)


# Commits held against the host engine: (what, matrix shape, repetitions,
# suffix blocks per leaf). The trace commit's shard (2^22 leaves of 2
# base-field values) and the first FRI layer committed on the card (2^21
# leaves of 2 extension values): the two forms of the leaf phase.
# Two small trees: one level past the cutoff's launch, and depth below it.
CARD_COMMITS = [
    ("trace shard", (1 << 22, 2), 2, 1),
    ("fri layer", (1 << 21, 2, 4), 2, 2),
    ("2^13 leaves", (1 << 13, 2), 3, 1),
    ("2^5 leaves", (1 << 5, 2, 4), 3, 2),
]


def check_commits_on_card(dev) -> None:
    """Each of CARD_COMMITS committed on the card and by the host SHA-NI
    engine from the same secrets: roots and opened paths byte-equal."""
    from tapstark_torch.commit import BcManager
    from tapstark_torch.commit.device_commit import ShardSuffixPlan
    from tapstark_torch.commit.tcs import TCS, FMatrix
    from tapstark_torch.field.constants import P
    from tapstark_torch.field.device import np_to_mont

    rng = np.random.default_rng(2)
    for what, shape, reps, blocks in CARD_COMMITS:
        n = shape[0]
        canon = rng.integers(0, P, shape).astype(np.uint32)
        mont = torch.from_numpy(np_to_mont(canon).view(np.int32)).to(dev)
        t0 = time.perf_counter()
        on_card = TCS(BcManager()).commit_poly_with_query_times([FMatrix(canon, dev=mont)], reps)
        t1 = time.perf_counter()
        on_host = TCS(BcManager()).commit_poly_with_query_times([FMatrix(canon)], reps)
        t2 = time.perf_counter()
        queries = [q for q in (0, 1, 255, 256, 123457) if q < n] + [n - 1]
        for d, h in zip(on_card, on_host):
            if d.root_words() != h.root_words():
                raise AssertionError(f"{what}: card and host roots differ")
            for q in queries:
                a, b = d.query_proof(q).leaf, h.query_proof(q).leaf
                if (a.script, a.leaf_hash, a.merkle_branch) != (b.script, b.leaf_hash, b.merkle_branch):
                    raise AssertionError(f"{what}: opening of leaf {q} differs")
        tree = on_card[0].trees[0]
        nb = ShardSuffixPlan(len(tree._head), tree._fixed_len).suf_words // 16
        if nb != blocks:
            raise AssertionError(f"{what}: {nb} suffix blocks per leaf, expected {blocks}")
        print(f"{what} {shape} x {reps} reps ({nb} suffix block(s) per leaf): roots and "
              f"{len(queries)} openings equal; card commit {t1 - t0:.3f} s, host commit {t2 - t1:.3f} s")


def check_lde_routes(dev) -> dict:
    """The two routes beside the fused one, word for word against it at
    their shapes: the blocks route (K3/K4's counterparts) at 2^22 x 2,
    blowup 4, and the limb-matmul LDE (K7's) at 2^20 x 2, blowup 4, each
    with the launch counts read around it. The limb-matmul route is also
    timed against the fused one (chip_study.py times the blocks route).
    Returns the limb-matmul route's counts (K7's path)."""
    from tapstark_torch.field.constants import MULT_GENERATOR as shift
    from tapstark_torch.poly import cols_ntt, cuda_ntt
    from tapstark_torch.poly import matmul_ntt as mm

    rng = np.random.default_rng(7)
    routes = {"blocks": cols_ntt.coset_lde_blocks, "limb matmul": mm.coset_lde_batch_matmul}
    counts = {}
    for log_n, route in LDE_ROUTES:
        fn = routes[route]
        evals = _mont_on(dev, rng, 1 << log_n, 2)
        want = cuda_ntt.coset_lde_batch_cuda(evals, 2, shift)
        for module in (cuda_ntt, cols_ntt, mm):
            module.reset_launch_counts()
        got = fn(evals, 2, shift)
        torch.cuda.synchronize()
        counts[route] = {**cuda_ntt.launches, **cols_ntt.launches, **mm.launches}
        compare(f"{route} LDE", got, want, f"2^{log_n} x 2, blowup 4")
        line = f"{route} LDE 2^{log_n} x 2 blowup 4: equal to the fused route"
        if route == "limb matmul":
            ms = median_ms(lambda: fn(evals, 2, shift), 5)
            fused_ms = median_ms(lambda: cuda_ntt.coset_lde_batch_cuda(evals, 2, shift), 5)
            line += f"; {ms:.3f} ms, fused route {fused_ms:.3f} ms"
        print(f"{line}; launches {counts[route]}", flush=True)
        del evals, want, got
    # three members each way at 2^20 (2^7 * 2^7 * 2^6), one launch a member
    if counts["limb matmul"]["mod_matmul"] != 6:
        raise AssertionError(f"the limb-matmul LDE made {counts['limb matmul']['mod_matmul']} K7 launches, not 6")
    return counts["limb matmul"]


def _random_words_on(dev, rng, *shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)


def _padded_blocks(msgs: np.ndarray) -> np.ndarray:
    """(N, L) message bytes → (N, nb, 16) big-endian words of the SHA-256
    padded messages."""
    n, size = msgs.shape
    pad = np.zeros((n, (55 - size) % 64 + 9), dtype=np.uint8)
    pad[:, 0] = 0x80
    pad[:, -8:] = np.frombuffer((8 * size).to_bytes(8, "big"), dtype=np.uint8)
    padded = np.concatenate([msgs, pad], axis=1)
    return padded.view(">u4").astype(np.uint32).reshape(n, -1, 16)


def _digest(words: torch.Tensor) -> bytes:
    return words.cpu().numpy().view(np.uint32).astype(">u4").tobytes()


def check_surface(dev) -> None:
    """The rest of the JAX package's public surface on the card, through
    K3/K4's and K5/K6's kernels: `coset_lde_nogather` at SURFACE_LDE
    against `coset_lde_batch_auto` (the fused route) and its plain version,
    its launches counted and its time beside the fused route's; its halves
    `intt_to_bitrev` and `ntt_from_bitrev` against their plain versions (and
    each other's inverse); `sha256_blocks`, `tagged_hash_fixed_batch` and
    `tapbranch_hash_batch` over SURFACE_LANES lanes against their plain
    versions and, at SURFACE_SAMPLE seeded lanes, the host hashes;
    `interpolate_coset` on the wide row's LDE against the trace's
    coefficients dotted with the point's powers, its time, its peak and
    its largest allocation."""
    from tapstark_torch.field.constants import MULT_GENERATOR as shift
    from tapstark_torch.field.constants import P
    from tapstark_torch.field.device import ef_const, ef_mul, ef_mul_base
    from tapstark_torch.field.scalar import EF4
    from tapstark_torch.hashes.sha256 import tagged_hash, tapbranch_hash
    from tapstark_torch.hashes import sha256_device as sd
    from tapstark_torch.poly import cols_ntt, cuda_ntt
    from tapstark_torch.poly.interpolate import interpolate_coset
    from tapstark_torch.poly.reduce import fp_sum_axis0

    ntt = importlib.import_module("tapstark_torch.poly.ntt")  # the package binds `ntt` to the function
    rng = np.random.default_rng(14)
    for log_n, w, log_blowup in SURFACE_LDE:
        where = f"2^{log_n} x {w}, blowup 2^{log_blowup}"
        evals = _mont_on(dev, rng, 1 << log_n, w)
        want = ntt.coset_lde_batch_auto(evals, log_blowup, shift)
        cols_ntt.reset_launch_counts()
        cuda_ntt.reset_launch_counts()
        got = cols_ntt.coset_lde_nogather(evals, log_blowup, shift)
        torch.cuda.synchronize()
        counts = {**cols_ntt.launches, **cuda_ntt.launches}
        compare("coset_lde_nogather", got, want, where)
        compare("coset_lde_nogather", got, cols_ntt.coset_lde_nogather_plain(evals, log_blowup, shift), where)
        expect_launches(f"coset_lde_nogather {where}", counts, {
            "dif_cols": 2, "dif_cols.cols": 1, "dif_cols.last": 1, "dit_cols": 2, "dit_cols.first": 1,
            "dit_cols.cols": 1, "lde_inverse": 0, "lde_forward": 0})
        ms = median_ms(lambda: cols_ntt.coset_lde_nogather(evals, log_blowup, shift), 5)
        fused_ms = median_ms(lambda: ntt.coset_lde_batch_auto(evals, log_blowup, shift), 5)
        print(f"coset_lde_nogather {where}: equal to coset_lde_batch_auto and its plain version; {ms:.4f} ms, "
              f"fused route {fused_ms:.4f} ms; launches {counts}", flush=True)
        del evals, want, got
        torch.cuda.empty_cache()

    log_n, w, _ = SURFACE_LDE[0]
    evals = _mont_on(dev, rng, 1 << log_n, w)
    coeffs = cols_ntt.intt_to_bitrev(evals)
    compare("intt_to_bitrev", coeffs, cols_ntt.intt_to_bitrev_plain(evals), f"2^{log_n} x {w}")
    back = cols_ntt.ntt_from_bitrev(coeffs)
    compare("ntt_from_bitrev", back, cols_ntt.ntt_from_bitrev_plain(coeffs), f"2^{log_n} x {w}")
    compare("ntt_from_bitrev(intt_to_bitrev)", back, evals, f"2^{log_n} x {w}")
    print(f"intt_to_bitrev, ntt_from_bitrev 2^{log_n} x {w}: equal to their plain versions and each other's "
          f"inverse; {median_ms(lambda: cols_ntt.intt_to_bitrev(evals), 5):.4f} ms, "
          f"{median_ms(lambda: cols_ntt.ntt_from_bitrev(coeffs), 5):.4f} ms", flush=True)
    del evals, coeffs, back

    lanes = SURFACE_LANES
    sample = rng.choice(lanes, SURFACE_SAMPLE, replace=False)
    msgs = rng.integers(0, 256, (lanes, 100), dtype=np.uint8)  # two blocks a lane
    blocks = torch.from_numpy(_padded_blocks(msgs).view(np.int32)).to(dev)
    leaves = _random_words_on(dev, rng, lanes, 20)  # 80 bytes: two blocks after the tag's midstate
    h1, h2 = _random_words_on(dev, rng, lanes, 8), _random_words_on(dev, rng, lanes, 8)
    h2[::7] = h1[::7]
    h2[1::7, :4] = h1[1::7, :4]
    runs = {
        "sha256_blocks": (lambda: sd.sha256_blocks(blocks), lambda: sd.sha256_blocks_plain(blocks),
                          lambda i: hashlib.sha256(msgs[i].tobytes()).digest()),
        "tagged_hash_fixed_batch": (
            lambda: sd.tagged_hash_fixed_batch(b"TapLeaf", leaves, 80),
            lambda: sd.tagged_hash_fixed_batch_plain(b"TapLeaf", leaves, 80),
            lambda i: tagged_hash(b"TapLeaf", _digest(leaves[i]))),
        "tapbranch_hash_batch": (lambda: sd.tapbranch_hash_batch(h1, h2), lambda: sd.tapbranch_hash_batch_plain(h1, h2),
                                 lambda i: tapbranch_hash(_digest(h1[i]), _digest(h2[i]))),
    }
    for name, (run, plain, on_host) in runs.items():
        sd.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        counts = dict(sd.launches)
        compare(name, got, plain(), f"{lanes} lanes")
        expect_launches(name, counts, {"tapleaf_subtrees": 1, "tapbranch_levels": 0})
        bad = [int(i) for i in sample if _digest(got[i]) != on_host(int(i))]
        if bad:
            raise AssertionError(f"{name}: lanes {bad} differ from the host hash")
        print(f"{name} {lanes} lanes: equal to its plain version, {SURFACE_SAMPLE} lanes to the host hash; "
              f"{median_ms(run, 5):.4f} ms, plain {median_ms(plain, 1):.1f} ms; launches {counts}", flush=True)
    got = sd.tapbranch_fused_wm(h1.T, h2.T)
    compare("tapbranch_fused_wm", got.T, sd.tapbranch_hash_batch(h1, h2), f"{lanes} lanes")
    del blocks, leaves, h1, h2, got

    log_n, w, log_blowup = SURFACE_LDE[1]
    trace = _mont_on(dev, rng, 1 << log_n, w)
    lde = ntt.coset_lde_batch_auto(trace, log_blowup, shift)
    z = EF4([int(v) for v in rng.integers(0, P, 4)])
    coeffs = ntt.intt(trace)  # natural order: p(X) = sum c_j X^j on H_n, and on shift·H_N
    powers = ef_const(EF4.one(), dev)[None, :]
    step = z
    for _ in range(log_n):  # z^0 .. z^(n-1)
        powers = torch.cat([powers, ef_mul(powers, ef_const(step, dev))])
        step = step * step
    want = torch.cat([fp_sum_axis0(ef_mul_base(powers[:, None, :], coeffs[:, c0 : c0 + 16]))
                      for c0 in range(0, w, 16)])
    del trace, coeffs, powers
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.memory._record_memory_history(enabled="all", context=None, stacks="python", max_entries=1 << 20)
    got = interpolate_coset(lde, shift, z)
    torch.cuda.synchronize()
    snapshot = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated(dev)
    allocs = [e["size"] for trace_ in snapshot["device_traces"] for e in trace_ if e["action"] == "alloc"]
    largest = max(allocs, default=0)
    compare("interpolate_coset", got, want, f"2^{log_n + log_blowup} x {w}")
    if largest > SURFACE_MAX_ALLOC:
        raise AssertionError(f"interpolate_coset allocated {largest} bytes at once, more than {SURFACE_MAX_ALLOC}")
    ms = median_ms(lambda: interpolate_coset(lde, shift, z), 3)
    print(f"interpolate_coset 2^{log_n + log_blowup} x {w}: equal to the trace's coefficients dotted with the "
          f"point's powers; {ms:.3f} ms; max_memory_allocated {before} bytes before, {peak} during "
          f"(+{peak - before}); {len(allocs)} allocations, the largest {largest} bytes", flush=True)
    del lde, got, want
    torch.cuda.empty_cache()


def run_counted(dev, fn):
    """fn() with spans on, and the peak device memory and every launch
    count reset just before it; prints the spans, the launches and the
    peak, and returns (fn's result, the counts read just after)."""
    from tapstark_torch.air import program
    from tapstark_torch.challenger import device_tail
    from tapstark_torch.commit.device_commit import DeviceValues
    from tapstark_torch.hashes import sha256_device
    from tapstark_torch.poly import cols_ntt, cuda_ntt
    ntt = importlib.import_module("tapstark_torch.poly.ntt")  # the package binds `ntt` to the function
    from tapstark_torch.poly import matmul_ntt as mm
    from tapstark_torch.utils import profiling

    modules = (cuda_ntt, cols_ntt, sha256_device, mm, program, ntt, device_tail)
    profiling.reset()
    profiling.enable()
    torch.cuda.reset_peak_memory_stats(dev)
    for module in modules:
        module.reset_launch_counts()
    steps, full = device_tail.TOTAL_STEPS, DeviceValues.full_calls
    result = fn()
    launches = {k: v for module in modules for k, v in module.launches.items()}
    # the device transcript chain's steps, and whole padding matrices copied
    # to the host (DeviceValues.full, a fallback no prove should take)
    launches["chain steps"] = device_tail.TOTAL_STEPS - steps
    launches["values full"] = DeviceValues.full_calls - full
    profiling.enable(False)
    for span, r in profiling.report().items():
        print(f"phase {span}: {r['total_s']:.3f} s over {r['calls']} call(s)")
    print(f"launches {launches}")
    print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    return result, launches


# each `run_prove`'s prove seconds, by name
PROVE_S: dict = {}


def run_prove(name: str, dev, cfg: dict, frozen, pcs=None) -> dict:
    """One prove and verify through `run_counted` (on `pcs` where given);
    prints the run, holds the proof to `frozen` (sha256, bytes, witness)
    and returns the counts."""
    run, launches = run_counted(dev, lambda: prove_fibonacci(device=dev, pcs=pcs, **cfg))
    PROVE_S[name] = run["prove_s"]
    data, witness = run["data"], run["witness"]
    print(
        f"{name}: fibonacci 2^{cfg['log_n']} rows: prove {run['prove_s']:.3f} s, verify {run['verify_s']:.3f} s "
        f"(accepted), proof {len(data)} bytes sha256 {hashlib.sha256(data).hexdigest()} witness {witness}",
        flush=True,
    )
    got = (hashlib.sha256(data).hexdigest(), len(data), witness)
    if got != frozen:
        raise AssertionError(f"{name}: proof {got} differs from the frozen {frozen}")
    return launches


def run_wide_row(dev) -> dict:
    """The wide row (WIDE_ROW) through `standard_config` on the card and
    `run_counted`: prove, verify, emit and execute the script verifier;
    prints the times and the report, holds the proof to WIDE_PROOF and the
    report to WIDE_REPORT, and returns the counts."""
    from tapstark_torch.airs import RecursionAir, generate_recursion_trace
    from tapstark_torch.field import F
    from tapstark_torch.stark import prove, verify
    from tapstark_torch.stark.config import standard_config
    from tapstark_torch.stark.script_verifier import generate_script_verifier
    from tapstark_torch.stark.serde import proof_from_bytes, proof_to_bytes

    cfg = WIDE_ROW
    config = standard_config(cfg["log_blowup"], cfg["num_queries"], cfg["pow_bits"],
                             log_final_poly_len=cfg["log_final_poly_len"])
    trace, pis = generate_recursion_trace(1 << cfg["log_n"])
    pis = [F(x) for x in pis]
    air = RecursionAir()

    def drive():
        t0 = time.perf_counter()
        proof = prove(config.pcs, air, config.challenger(), trace, pis)
        t1 = time.perf_counter()
        data = proof_to_bytes(proof)
        verify(config.pcs, air, config.challenger(), proof_from_bytes(data), pis)
        t2 = time.perf_counter()
        report = generate_script_verifier(config.pcs, air, config.challenger(), proof, pis)
        return proof, data, report, (t1 - t0, t2 - t1, time.perf_counter() - t2)

    (proof, data, report, (t_prove, t_verify, t_emit)), launches = run_counted(dev, drive)
    witness = proof.opening_proof.pow_witness
    print(
        f"wide row: RecursionAir 2^{cfg['log_n']} x {air.width()}, blowup 2^{cfg['log_blowup']}, "
        f"{cfg['num_queries']} queries, final poly 2^{cfg['log_final_poly_len']}: prove {t_prove:.3f} s, "
        f"verify {t_verify:.3f} s (accepted), emit and execute {t_emit:.3f} s; proof {len(data)} bytes "
        f"sha256 {hashlib.sha256(data).hexdigest()} witness {witness}"
    )
    digest = report_digest(report)
    print(f"report {json.dumps(digest)}")
    seg = report.segment_script_bytes
    print(f"segments {len(seg)}: " + ", ".join(f"{k} {v}" for k, v in seg.items() if "query_index" not in k)
          + f"; fri-pcs-verify {sum(v for k, v in seg.items() if 'query_index' in k)} bytes in "
          f"{sum('query_index' in k for k in seg)} segments", flush=True)
    got = (hashlib.sha256(data).hexdigest(), len(data), witness)
    if got != WIDE_PROOF:
        raise AssertionError(f"wide row: proof {got} differs from the frozen {WIDE_PROOF}")
    if digest != WIDE_REPORT:
        raise AssertionError(f"wide row: report {digest} differs from the frozen {WIDE_REPORT}")
    return launches


def sponge_blocks(n: int) -> list:
    """The messages of `bench_blake3.py`: block b absorbs words b*16 .. b*16 + 15."""
    return [[(b * 16 + w) & 0xFFFFFFFF for w in range(16)] for b in range(n)]


def prove_blake3(dev, blocks: int, log_blowup: int, num_queries: int, pow_bits: int, check: bool = True) -> dict:
    """The Blake3 sponge chain over `blocks` compressions through the port:
    the host trace generator (timed), the AIR's digest against a host
    BfChallenger's chaining value after it observes the blocks, prove and
    (with `check`) verify; returns {"data": proof bytes, "witness",
    "gen_s", "prove_s", "verify_s" (None without `check`), "shape"}."""
    from tapstark_torch.airs import Blake3SpongeChainAir, generate_blake3_sponge_trace
    from tapstark_torch.challenger import BfChallenger
    from tapstark_torch.field import F
    from tapstark_torch.stark import prove, verify
    from tapstark_torch.stark.serde import proof_from_bytes, proof_to_bytes

    msgs = sponge_blocks(blocks)
    t0 = time.perf_counter()
    trace, pis, digest = generate_blake3_sponge_trace(msgs)
    t1 = time.perf_counter()
    ch = BfChallenger()
    for blk in msgs:
        ch.observe_u32s(blk)
    if digest != ch.cv:
        raise AssertionError(f"blake3 sponge: the AIR's digest {digest} differs from the challenger's {ch.cv}")
    pcs = make_config(num_queries, log_blowup, pow_bits, dev)
    pis = [F(x) for x in pis]
    air = Blake3SpongeChainAir()
    t2 = time.perf_counter()
    proof = prove(pcs, air, BfChallenger(), trace, pis)  # ends on the host
    t3 = time.perf_counter()
    data = proof_to_bytes(proof)
    if check:
        verify(pcs, air, BfChallenger(), proof_from_bytes(data), pis)
    t4 = time.perf_counter()
    return {"data": data, "witness": proof.opening_proof.pow_witness, "gen_s": t1 - t0, "prove_s": t3 - t2,
            "verify_s": t4 - t3 if check else None, "shape": trace.shape}


def run_blake3(dev, cfg: dict, frozen, name: str, check: bool = True) -> dict:
    """`prove_blake3` through `run_counted`; prints the run, holds the proof
    to `frozen` (sha256, bytes, witness) and returns the counts."""
    run, launches = run_counted(dev, lambda: prove_blake3(dev, **cfg, check=check))
    data, witness = run["data"], run["witness"]
    rows, cols = run["shape"]
    print(f"{name}: host trace generator {run['gen_s']:.3f} s for {cfg['blocks']} compressions "
          f"({rows} x {cols}); AIR digest equal to the challenger's", flush=True)
    print(
        f"{name}: Blake3SpongeChainAir {rows} x {cols}, blowup 2^{cfg['log_blowup']}, {cfg['num_queries']} queries, "
        f"{cfg['pow_bits']} PoW bits: prove {run['prove_s']:.3f} s, "
        + (f"verify {run['verify_s']:.3f} s (accepted), " if check else "")
        + f"proof {len(data)} bytes sha256 {hashlib.sha256(data).hexdigest()} witness {witness}", flush=True)
    got = (hashlib.sha256(data).hexdigest(), len(data), witness)
    if got != frozen:
        raise AssertionError(f"{name}: proof {got} differs from the frozen {frozen}")
    return launches


def check_bitrev_cols(dev, stats: dict) -> None:
    """The coset gather by columns against its plain version (the row
    gather, then a transpose) at every BITREV_SHAPES entry, word for word;
    timed against its bound (the words read once and written once) at the
    provers' shapes, with one index_select of the LDE's transpose as the
    library time at the first."""
    ntt = importlib.import_module("tapstark_torch.poly.ntt")  # the package binds `ntt` to the function
    from tapstark_torch.poly.powers import bitrev_indices_dev

    rng = np.random.default_rng(9)
    for rows, width, m in BITREV_SHAPES:
        mat = _mont_on(dev, rng, rows, width)
        where = f"{m} of {rows} rows x {width}"
        run = lambda: ntt.bit_reverse_cols(mat, m)  # noqa: E731
        plain = lambda: ntt.bit_reverse_cols_plain(mat, m)  # noqa: E731
        got = run()
        if got.stride() != (1, m):
            raise AssertionError(f"bit_reverse_cols at {where}: strides {got.stride()}, not (1, {m})")
        err = compare("bit_reverse_cols", got, plain(), where)
        timed = m > 1 << 10
        record(stats, "bit_reverse_cols", err, run, plain, where, bound(0, 8 * m * width) if timed else None)
        if (rows, width, m) == BITREV_SHAPES[0]:
            rev = bitrev_indices_dev(m.bit_length() - 1, dev)
            lib_ms = median_ms(lambda: torch.index_select(mat[:m].t(), 1, rev), 20)
            stats["bit_reverse_cols"]["library_ms"] = lib_ms
            print(f"library: torch.index_select of the LDE's transpose at {where}: {lib_ms:.4f} ms", flush=True)
        del mat, got


def check_transcript_kernel(dev, stats: dict) -> None:
    """The FRI transcript step against its plain version (the eager step)
    on the card: a chain of 3 steps at every TRANSCRIPT_CHAINS entry, from
    random chaining words and pending input, the roots read through K6's
    strided view (columns of a (8, R, T + 1) level buffer) as in a prove,
    word for word (cv', beta, the popped words); timed at
    TRANSCRIPT_TIMED against the bound."""
    from tapstark_torch.challenger import device_tail as dt

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def words(*shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device=dev, generator=gen)

    kinds = {"blake3": dt.KIND_BLAKE3, "test": dt.KIND_TEST}
    for name, pending, reps in TRANSCRIPT_CHAINS:
        kind = kinds[name]
        cv_k = cv_p = words(8)
        pend = words(pending)
        for step in range(3):
            roots = words(8, reps, 5)[:, :, -1].T
            got = dt.transcript_step(cv_k, pend, roots, kind)
            want = dt.transcript_step_plain(cv_p, pend, roots, kind)
            where = f"{name} pending={pending} R={reps} step={step}"
            err = max(compare("transcript_step", g, w, where) for g, w in zip(got, want))
            if step == 0 and (name, pending, reps) in TRANSCRIPT_TIMED:
                bnd = transcript_bound(name, pending, reps)
                record(stats, "transcript_step", err, lambda: dt.transcript_step(cv_k, pend, roots, kind),
                       lambda: dt.transcript_step_plain(cv_p, pend, roots, kind), where, bnd)
                print(f"transcript_step bound at {where}: {1e6 * bnd[0]:.3f} ns ({bnd[1]})", flush=True)
            stats.setdefault("transcript_step", {"max_abs_err": 0, "shapes": []})
            stats["transcript_step"]["max_abs_err"] = max(stats["transcript_step"]["max_abs_err"], err)
            cv_k, cv_p, pend = got[0], want[0], pend[:0]
    print(f"transcript_step: {len(TRANSCRIPT_CHAINS)} chains of 3 steps equal to the plain version", flush=True)


def quotient_case(dev, air_name: str, log_n: int, seed: int):
    """The inputs of the quotient at a prove's coset: (AIR, public values,
    trace domain, quotient coset, random Montgomery (m, width) trace on the
    coset laid out by columns, as the prover gives it to the kernels,
    alpha), made from `seed`."""
    from tapstark_torch.air.symbolic import get_log_quotient_degree
    from tapstark_torch.airs import Blake3SpongeChainAir, FibonacciAir, RecursionAir
    from tapstark_torch.field import F
    from tapstark_torch.field.constants import P
    from tapstark_torch.field.scalar import EF4
    from tapstark_torch.poly.domain import TwoAdicMultiplicativeCoset

    air, num_public = {"sponge": (Blake3SpongeChainAir(), 16), "fibonacci": (FibonacciAir(), 3),
                       "recursion": (RecursionAir(), 12)}[air_name]
    rng = np.random.default_rng(seed)
    log_q = get_log_quotient_degree(air, num_public)
    trace_domain = TwoAdicMultiplicativeCoset(log_n, 1)
    coset = trace_domain.create_disjoint_domain(1 << (log_n + log_q))
    tq = _mont_on(dev, rng, air.width(), coset.size()).t()
    pis = [F(int(v)) for v in rng.integers(0, P, num_public)]
    alpha = EF4(tuple(int(v) for v in rng.integers(0, P, 4)))
    return air, pis, trace_domain, coset, tq, alpha


def quotient_plain(air, pis, trace_domain, coset, tq, alpha):
    """The quotient kernels' plain version: the selectors over the coset,
    then the eager folder."""
    from tapstark_torch.air import program

    sels = trace_domain.selectors_on_coset(coset, tq.device)
    return program.quotient_eager(air, pis, sels, coset.size() // trace_domain.size(), tq, alpha)


_printed: set = set()


def build_quotient(air, num_public: int):
    """Generate and build the AIR's quotient kernels (once a process) and
    print, per program: segments, instructions, the values live at each
    cut, each segment's registers and spills, the build's seconds."""
    from tapstark_torch.air import program

    kernels = program.build(air, num_public)
    prog, segs = program.program_for(air, num_public), kernels.plan.segments
    if kernels.path not in _printed:
        _printed.add(kernels.path)
        print(f"quotient program {prog.name} ({air.width()} columns): {len(prog.code)} instructions {prog.counts}, "
              f"S {program.SEGMENT_INSTRUCTIONS}, {len(segs)} segments, live-buffer rows {kernels.plan.live_rows}, built "
              f"{kernels.built} in {kernels.seconds:.2f} s", flush=True)
        for k, (sg, px) in enumerate(zip(segs, kernels.ptxas)):
            print(f"  segment {k}: instructions [{sg.start}, {sg.stop}), {len(sg.loads)} loaded, {len(sg.stores)} "
                  f"stored, {sg.live_out} live at the cut after it, {sg.folds} folds; {px['registers']} "
                  f"registers, spill {px['spill_stores']} / {px['spill_loads']} bytes (stores / loads)"
                  + (f"; nvcc {px['nvcc_seconds']:.1f} s" if "nvcc_seconds" in px else ""), flush=True)
    return kernels


def check_quotient_kernel(dev, stats: dict) -> None:
    """The quotient kernels against their plain version (the selectors and
    the eager folder) at every QUOTIENT_SHAPES entry, word for word, on
    random cosets: the kernels' median CUDA-event time of 10 (all the
    segments of a call), the plain version's of 3 (of 1 on the 1548-column
    AIR: about 1.3 million launches), the bound."""
    from tapstark_torch.air import program

    for i, (what, air_name, log_n) in enumerate(QUOTIENT_SHAPES):
        air, pis, trace_domain, coset, tq, alpha = quotient_case(dev, air_name, log_n, 20 + i)
        kernels = build_quotient(air, len(pis))
        run = lambda: program.quotient_program(air, pis, trace_domain, coset, tq, alpha)  # noqa: E731
        plain_times = []
        for _ in range(1 if air.width() > 1000 else 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = quotient_plain(air, pis, trace_domain, coset, tq, alpha)
            torch.cuda.synchronize()
            plain_times.append(1e3 * (time.perf_counter() - t0))
        m, width = tq.shape
        where = f"{what}: coset {m} x {width}"
        err = compare("quotient_program", run(), want, where)
        ms = median_ms(run, 10)
        prog = program.program_for(air, len(pis))
        bnd = quotient_bound(prog.counts, set(kernels.plan.selectors), m, width)
        s = stats.setdefault("quotient_program", {"max_abs_err": 0, "shapes": []})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["shapes"].append({"at": where, "ms": ms, "plain_ms": statistics.median(plain_times),
                            "bound_ms": bnd[0], "bound_by": bnd[1], "segments": len(kernels.plan.segments)})
        print(f"kernel quotient_program {where} ({len(prog.code)} instructions {prog.counts}, "
              f"{len(kernels.plan.segments)} segments, selectors {sorted(kernels.plan.selectors)}): equal, "
              f"{ms:.4f} ms, plain {statistics.median(plain_times):.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) = max("
              + ", ".join(f"{k} {v:.4f}" for k, v in bnd[2].items()) + ")", flush=True)
        del tq, want


def wall_ms(fn, reps: int, devices) -> float:
    """fn's host-clock time with every device of `devices` synchronized
    before and after it (a mesh's work spans its cards: one card's CUDA
    events would miss the others'), median of `reps` after one warm-up."""
    def sync():
        for d in set(devices):
            torch.cuda.synchronize(d)

    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def make_mesh(dev, mesh=None):
    """`mesh`, or MESH_SHARDS shards on the card `dev`."""
    from tapstark_torch.mesh import Mesh

    return mesh if mesh is not None else Mesh([dev] * MESH_SHARDS)


def check_mesh_lde(dev, stats: dict, mesh=None) -> None:
    """The distributed NTT, its inverse and the distributed coset LDE at
    MESH_LDE over the mesh (MESH_SHARDS shards of the card by default),
    word for word against the plain NTT, the input and
    `coset_lde_batch_auto` on the card; every shard's `dit_cols` launches
    (two a transform) counted; the exchanges' bytes; the distributed LDE's
    time against the one-device LDE's; `dit_cols` at its per-shard shapes
    against its plain version and bound (the JSON row's `shapes`)."""
    from tapstark_torch.field.constants import MULT_GENERATOR as shift
    from tapstark_torch.mesh import collectives, distributed_coset_lde, distributed_ntt
    from tapstark_torch.poly import cols_ntt, cuda_ntt
    ntt = importlib.import_module("tapstark_torch.poly.ntt")  # the package binds `ntt` to the function

    mesh = make_mesh(dev, mesh)
    log_n, w, log_blowup = MESH_LDE
    where = f"{mesh.size} shards on {sorted({str(d) for d in mesh.devices})}, 2^{log_n} x {w}"
    x = _mont_on(mesh.primary, np.random.default_rng(41), 1 << log_n, w)
    for module in (cols_ntt, cuda_ntt):
        module.reset_launch_counts()
    collectives.reset_counts()
    y = distributed_ntt(mesh, x)
    back = distributed_ntt(mesh, y, inverse=True)
    lde = distributed_coset_lde(mesh, x, log_blowup, shift)
    launches, moved = {**cols_ntt.launches, **cuda_ntt.launches}, dict(collectives.counts)
    compare("distributed_ntt", y, ntt.ntt(x), where)
    compare("distributed_ntt inverse", back, x, where)
    compare("distributed_coset_lde", lde, ntt.coset_lde_batch_auto(x, log_blowup, shift), f"{where}, blowup "
            f"{1 << log_blowup}")
    want = 2 * 4 * mesh.size  # four transforms (the NTT, its inverse, the LDE's two), two launches each a shard
    expect_launches("mesh lde", launches, {"dit_cols": want, "dit_cols.cols": want, "dit_cols.first": 0,
                                           "dif_cols": 0, "lde_inverse": 0, "lde_forward": 0})
    print(f"mesh lde {where}: distributed NTT, inverse and coset LDE (blowup {1 << log_blowup}) equal to one "
          f"device's; dit_cols launches {want} ({want // mesh.size} a shard); exchanges {moved}", flush=True)
    collectives.reset_counts()
    distributed_coset_lde(mesh, x, log_blowup, shift)
    print(f"mesh lde exchanges of one coset LDE: {collectives.counts}", flush=True)
    mesh_ms = wall_ms(lambda: distributed_coset_lde(mesh, x, log_blowup, shift), 10, mesh.devices)
    one_ms = wall_ms(lambda: ntt.coset_lde_batch_auto(x, log_blowup, shift), 10, mesh.devices)
    print(f"mesh lde time (host clock, every card synchronized, median of 10): distributed {mesh_ms:.4f} ms, "
          f"one device (coset_lde_batch_auto) {one_ms:.4f} ms", flush=True)
    rng = np.random.default_rng(43)
    for log_r, b in MESH_COLS:
        m = _mont_on(mesh.primary, rng, 1 << log_r, b)
        where = f"mesh shard R=2^{log_r} B={b} inverse=False"
        run = lambda: cols_ntt.dit_cols(m, log_r, False)  # noqa: E731
        plain = lambda: cols_ntt.dit_cols_plain(m, log_r, False)  # noqa: E731
        record(stats, "dit_cols", compare("dit_cols", run(), plain(), where), run, plain, where,
               cols_bound(log_r, b), "cols")
    del x, y, back, lde


def check_mesh_step(dev, stats: dict, segments: int, mesh=None) -> dict:
    """`make_sharded_prover_step` at MESH_STEP_LOG_N (Fibonacci, blowup 2)
    over the mesh, its four outputs word for word against the one-shard
    composition on the card (`coset_lde_batch_auto`, `quotient_program`
    over the whole coset, `fold_matrix`, the plain grind), each shard's
    `dit_cols` and quotient-segment launches counted; then the windowed
    segments against their plain version (the eager folder over the
    window) at shard 1's window, timed against the bound (the JSON row's
    `shapes`). Returns the step's counts."""
    from tapstark_torch.air import program
    from tapstark_torch.airs import FibonacciAir
    from tapstark_torch.field.device import fetch_canonical
    from tapstark_torch.field.scalar import EF4, F
    from tapstark_torch.hashes.blake3 import compress_batch
    from tapstark_torch.mesh import collectives, make_sharded_prover_step
    from tapstark_torch.poly import cols_ntt, cuda_ntt
    ntt = importlib.import_module("tapstark_torch.poly.ntt")  # the package binds `ntt` to the function
    from tapstark_torch.poly.domain import TwoAdicMultiplicativeCoset
    from tapstark_torch.poly.fold import fold_matrix

    mesh = make_mesh(dev, mesh)
    air, log_n = FibonacciAir(), MESH_STEP_LOG_N
    step, args = make_sharded_prover_step(mesh, air, log_n=log_n, log_blowup=1)
    for module in (cols_ntt, cuda_ntt, program):
        module.reset_launch_counts()
    collectives.reset_counts()
    t0 = time.perf_counter()
    lde, quotient, folded, winner = step(*args)
    for d in set(mesh.devices):
        torch.cuda.synchronize(d)
    seconds = time.perf_counter() - t0
    launches = {**cols_ntt.launches, **cuda_ntt.launches, **program.launches, **collectives.counts}
    expect_launches("mesh step", launches, {"dit_cols.cols": 2 * 2 * mesh.size, "dit_cols.first": 0,
                                            "lde_inverse": 0, "lde_forward": 0,
                                            "quotient_program": segments * mesh.size})

    trace, alpha4, beta4, grind_ws, capacity = args
    shift = F.generator().v
    td, coset = TwoAdicMultiplicativeCoset(log_n, 1), TwoAdicMultiplicativeCoset(log_n + 1, shift)
    alpha, pis = EF4(tuple(int(v) for v in fetch_canonical(alpha4))), [F(0), F(1), F(0)]
    lde1 = ntt.coset_lde_batch_auto(trace, 1, shift)
    quotient1 = program.quotient_program(air, pis, td, coset, lde1.t().contiguous().t(), alpha)
    ws = grind_ws.to(torch.int64)
    out = compress_batch([ws] + [ws * 0] * 15, block_len=4, cv=[int(v) for v in capacity.tolist()])
    hits = torch.nonzero((out[7] >> (32 - 8)) == 0)
    where = f"{mesh.size} shards, 2^{log_n} x {air.width()}, blowup 2"
    compare("mesh step lde", lde, lde1, where)
    compare("mesh step quotient", quotient, quotient1, where)
    compare("mesh step fold", folded, fold_matrix(beta4, quotient1.reshape(-1, 2, 4)), where)
    if int(winner) != (int(hits[0, 0]) if hits.numel() else 0):
        raise AssertionError(f"mesh step: grind winner {int(winner)}, one device's {hits[:1].tolist()}")
    print(f"mesh step {where}: lde, quotient, fold and grind winner ({int(winner)}) equal to the one-shard "
          f"composition; {seconds:.3f} s (first call); launches {launches}", flush=True)

    big = 2 << log_n
    rows = big // mesh.size
    at = torch.arange(rows, rows + rows + 2, device=lde1.device) % big  # shard 1's rows, then its halo
    tq = lde1.index_select(0, at).t().contiguous().t()
    where = f"window of shard 1: rows {rows} .. {2 * rows - 1} of the coset {big} x {air.width()}"
    run = lambda: program.quotient_window(air, pis, td, coset, tq, alpha, rows, rows)  # noqa: E731
    plain = lambda: program.quotient_window_plain(air, pis, td, coset, tq, alpha, rows, rows)  # noqa: E731
    prog, kernels = program.program_for(air, len(pis)), program.build(air, len(pis))
    record(stats, "quotient_program", compare("quotient_program", run(), plain(), where), run, plain, where,
           quotient_bound(prog.counts, set(kernels.plan.selectors), rows, air.width()))
    return launches


def run_mesh_prove(dev, name: str, cfg: dict, frozen, mesh=None) -> dict:
    """A Fibonacci prove through `standard_config(mesh=...)` (the LDEs over
    the mesh, MESH_SHARDS shards of the card by default) by `run_prove`:
    its proof held to `frozen`; every LDE's `dit_cols` launches on every
    shard and none of the one-device LDE kernels; its prove time beside
    the one-device prove's of the same name, where this run had one."""
    from tapstark_torch.mesh import collectives
    from tapstark_torch.stark.config import standard_config

    mesh = make_mesh(dev, mesh)
    config = standard_config(cfg["log_blowup"], cfg["num_queries"], cfg["pow_bits"], mesh=mesh)
    collectives.reset_counts()
    launches = run_prove(f"mesh {name}", dev, cfg, frozen, config.pcs)
    launches.update(collectives.counts)
    # the trace's and the quotient's LDE: two transforms each, two launches a transform on every shard
    expect_launches(f"mesh {name}", launches, {"dit_cols.cols": 2 * 2 * 2 * mesh.size, "dit_cols.first": 0,
                                               "dif_cols.cols": 0, "dif_cols.last": 0, "lde_inverse": 0,
                                               "lde_forward": 0, "bit_reverse_cols": 1})
    expect_chain(name, launches)
    one = PROVE_S.get(name)
    print(f"mesh {name}: {mesh.size} shards on {sorted({str(d) for d in mesh.devices})}: prove "
          f"{PROVE_S[f'mesh {name}']:.3f} s" + (f" against one device's {one:.3f} s" if one is not None else "")
          + f"; exchanges {collectives.counts}", flush=True)
    return launches


def expect_launches(name: str, launches: dict, want: dict) -> None:
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")


def expect_chain(name: str, launches: dict) -> None:
    """The prove's FRI layers on the card took their betas from the device
    transcript chain, one kernel launch a step (CHAIN_STEPS), and no
    opening copied a whole padding matrix. A chain whose words differ from
    the host challenger's replay raises in the prove itself."""
    steps = CHAIN_STEPS[name]
    expect_launches(name, launches, {"chain steps": steps, "transcript_step": steps, "values full": 0})
    print(f"{name}: device transcript chain {steps} steps, each word equal to the host replay's; "
          f"no whole padding matrix copied", flush=True)


def kernel_rows(stats: dict, path_launches: dict) -> list:
    """The JSON line's rows, one per KERNELS entry: each headed by its
    first `shapes` entry (`record`), with each form's first entry under
    `forms`, and launches read on the row's path."""

    def numbers(entry: dict) -> dict:
        return {k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    rows = []
    for name, replaces, source, path in KERNELS:
        s, counts = stats[name], path_launches[path]
        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": counts[name],
            "path": path,
            "max_abs_err": s["max_abs_err"],
            **numbers(s["shapes"][0]),
            # no PyTorch call computes a modular NTT or SHA-256; K7's is its
            # limb dots alone through torch._int_mm
            "library_ms": s.get("library_ms"),
            "shapes": s["shapes"],
        }
        forms = {}
        for entry in s["shapes"]:
            if "form" in entry and entry["form"] not in forms:
                forms[entry["form"]] = {"launches": counts[f"{name}.{entry['form']}"], "at": entry["at"],
                                        **numbers(entry)}
        if forms:
            row["forms"] = forms
        if name == "lde_forward":  # K2 runs on K3's two DIT kernels: their launches on its path
            row["kernels"] = {k: counts[k] for k in ("dit_cols.first", "dit_cols.cols")}
        if name == "quotient_program":  # the kernels' source is generated per AIR around `source`
            row["generator"] = "tapstark_torch/air/codegen.py"
        if name == "lde_inverse":  # K1 runs on K4's two DIF kernels: their launches on its path
            row["kernels"] = {k: counts[k] for k in ("dif_cols.cols", "dif_cols.last")}
        if name in ("dit_cols", "quotient_program"):  # their launches on the mesh phase's paths too
            row["mesh"] = {p: path_launches[p][name] for p in MESH_PATHS}
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    started = time.perf_counter()

    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    from tapstark_torch import _build, native

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc {nvcc.stdout.strip().splitlines()[-1]} device {torch.cuda.get_device_name(0)}"
    )
    native.get_lib()  # the host SHA-NI engine: raises if it does not build

    phase("kernel build")
    _build.load_library()
    info = _build.build_info
    print(
        f"built={info['built']} in {info['seconds']:.2f} s from "
        f"{[s.split('tapstark_torch/')[-1] for s in info['sources']]} -> {info['path']}"
    )
    check_ptxas(info["ptxas"])

    phase("kernels vs plain")
    stats: dict = {}
    check_lde_kernels(dev, stats)
    check_cols_kernels(dev, stats)
    check_matmul_kernel(dev, stats)
    check_sha_kernels(dev, stats)
    check_bitrev_cols(dev, stats)
    check_transcript_kernel(dev, stats)

    phase("commits: card vs host engine")
    check_commits_on_card(dev)

    phase("lde routes: blocks 2^22 and limb matmul 2^20 vs fused")
    path_launches = {"matmul lde 2^20": check_lde_routes(dev)}

    phase("surface: the gather-free LDE, the SHA-256 batch API and interpolate_coset on the card")
    check_surface(dev)

    phase("quotient kernels: generate and build each AIR's program before its timed prove")
    from tapstark_torch.airs import Blake3SpongeChainAir, FibonacciAir, RecursionAir

    segments = {name: len(build_quotient(air, num_public).plan.segments)
                for name, air, num_public in (("fibonacci", FibonacciAir(), 3), ("wide row", RecursionAir(), 12),
                                              ("blake3 sponge", Blake3SpongeChainAir(), 16))}

    phase("golden proof on cuda, and its script verifier")
    run, launches = run_counted(dev, lambda: prove_fibonacci(3, 2, 28, 8, dev, emit=True))
    expect_chain("golden", launches)
    data, witness = run["data"], run["witness"]
    sha = hashlib.sha256(data).hexdigest()
    print(f"sha256 {sha} bytes {len(data)} witness {witness} prove {run['prove_s']:.3f} s "
          f"verify {run['verify_s']:.3f} s emit and execute {run['emit_s']:.3f} s")
    if (sha, len(data), witness) != (GOLDEN_PROOF_SHA256, GOLDEN_PROOF_LEN, GOLDEN_POW_WITNESS):
        raise AssertionError("golden proof bytes differ from the frozen ones")
    digest = report_digest(run["report"])
    print(f"report {json.dumps(digest)}")
    if digest != GOLDEN_REPORT:
        raise AssertionError(f"golden script-verifier report {digest} differs from the frozen {GOLDEN_REPORT}")

    phase("north-star prove on cuda (fused LDE route)")
    launches = path_launches["prove 2^20"] = run_prove("north star", dev, NORTH_STAR, PROOF_2_20)
    for name in ("lde_inverse", "lde_forward", "dit_cols.first", "dit_cols.cols", "dif_cols.cols", "dif_cols.last",
                 "tapleaf_subtrees", "tapbranch_levels"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the north-star path: {launches}")
    # each of the two LDEs: lde_inverse on the two DIF kernels, lde_forward on the two DIT kernels
    # and every segment of the AIR's quotient program once
    expect_launches("north star", launches, {"lde_inverse": 2, "dif_cols.cols": 2, "dif_cols.last": 2,
                                             "lde_forward": 2, "dit_cols.first": 2, "dit_cols.cols": 2,
                                             "quotient_program": segments["fibonacci"], "bit_reverse_cols": 1})
    expect_chain("north star", launches)

    phase("2^22 prove on cuda (blocks LDE route)")
    launches = path_launches["prove 2^22"] = run_prove("blocks route", dev, BLOCKS_PROVE, PROOF_2_22)
    for name in ("dit_cols", "dit_cols.first", "dit_cols.cols", "dif_cols", "dif_cols.cols", "dif_cols.last",
                 "tapleaf_subtrees", "tapbranch_levels"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the 2^22 path: {launches}")
    if launches["lde_inverse"] or launches["lde_forward"]:
        raise AssertionError(f"the fused LDE kernels ran on the 2^22 path: {launches}")
    # each of the two LDEs: the blocks route's four launches
    expect_launches("2^22", launches, {"dif_cols.cols": 2, "dif_cols.last": 2, "dit_cols.first": 2,
                                       "dit_cols.cols": 2, "quotient_program": segments["fibonacci"],
                                       "bit_reverse_cols": 1})
    expect_chain("blocks route", launches)

    phase("wide row on cuda: prove, verify, emit the script verifier")
    launches = path_launches["wide row"] = run_wide_row(dev)
    for name in ("lde_inverse", "lde_forward", "dit_cols.first", "dit_cols.cols", "dif_cols.cols", "dif_cols.last",
                 "tapleaf_subtrees", "tapbranch_levels"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the wide row's path: {launches}")
    # the trace's and the one quotient chunk's LDE, each on the fused route
    expect_launches("wide row", launches, {"lde_inverse": 2, "dif_cols.cols": 2, "dif_cols.last": 2,
                                           "lde_forward": 2, "dit_cols.first": 2, "dit_cols.cols": 2,
                                           "quotient_program": segments["wide row"], "bit_reverse_cols": 1})
    expect_chain("wide row", launches)

    phase("blake3 sponge chain on cuda: 1024 compressions (the flagship), 64 (the JAX package's proof)")
    launches = path_launches["blake3 sponge"] = run_blake3(dev, BLAKE3, BLAKE3_PROOF, "blake3 sponge")
    for name in ("lde_inverse", "lde_forward", "dit_cols.first", "dit_cols.cols", "dif_cols.cols", "dif_cols.last",
                 "tapleaf_subtrees", "tapbranch_levels", "quotient_program", "bit_reverse_cols"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the flagship's path: {launches}")
    # the trace's and the two quotient chunks' LDEs (2^16 rows, the fused route), each quotient segment once
    expect_launches("blake3 sponge", launches, {"lde_inverse": 3, "dif_cols.cols": 3, "dif_cols.last": 3,
                                                "lde_forward": 3, "dit_cols.first": 3, "dit_cols.cols": 3,
                                                "quotient_program": segments["blake3 sponge"],
                                                "bit_reverse_cols": 1})
    expect_chain("blake3 sponge", launches)
    launches = run_blake3(dev, BLAKE3_64, BLAKE3_64_PROOF, "blake3 sponge 64", check=False)  # the JAX package's bytes
    expect_chain("blake3 sponge 64", launches)
    check_quotient_kernel(dev, stats)

    phase(f"mesh: the distributed LDE, the sharded prover step and the north-star prove over {MESH_SHARDS} "
          "shards of the card")
    check_mesh_lde(dev, stats)
    path_launches["mesh step"] = check_mesh_step(dev, stats, segments["fibonacci"])
    launches = path_launches["mesh prove 2^20"] = run_mesh_prove(dev, "north star", NORTH_STAR, PROOF_2_20)
    expect_launches("mesh north star", launches, {"quotient_program": segments["fibonacci"]})

    loaded = [
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "tapstark") and sys.modules[m] is not None
    ]
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")

    kernels = kernel_rows(stats, path_launches)
    print(f"chip_smoke: every phase passed in {time.perf_counter() - started:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
