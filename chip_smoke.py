"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `tapstark_torch/csrc/`, holds each one
against its plain PyTorch version on the card (exact equality: the words
are integers), holds a north-star trace-commit shard and an FRI layer
hashed on the card against the host SHA-NI engine, proves the frozen golden Fibonacci
configuration on the card and checks its proof bytes, then proves and
verifies Fibonacci at 2^20 rows, blowup 4, 28 queries and 8 PoW bits
through `tapstark_torch`'s entry points, with the kernels' launch counts
read around that run. (`chip_study.py` holds the longer measurements:
full-size kernel times, the card's busy share, the FRI host-tail switch.)

The last line is `{"ok": true, "device": {...}}`; the line before it lists
the kernels with their launches, errors, times and bounds. Any failed
phase raises: no result line, non-zero exit. Without a CUDA device it
exits at once. Neither JAX nor the JAX package is loaded.
"""

from __future__ import annotations

import hashlib
import json
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

NORTH_STAR = dict(log_n=20, log_blowup=2, num_queries=28, pow_bits=8)
# (log_n, width, log_blowup): the path's shapes, the golden size, an odd log_n
LDE_SHAPES = [(20, 2, 2), (20, 4, 2), (3, 2, 2), (11, 3, 2)]
# SHA-256 check shapes: plain-form lanes (a power of two and a count that is
# a multiple of no block size), and the leaf form (repetitions, leaves) with
# 1 suffix block (trace and quotient commits) and 2 (the FRI layers)
SHA_LANES = [1 << 12, 4099]
SHA_LEAF = (28, 1 << 16)
SHA_LEAF_BLOCKS = [1, 2]
KERNELS = [  # name, replaced TPU kernel, source
    ("lde_inverse", "tapstark/poly/pallas_ntt.py:480", "tapstark_torch/csrc/coset_lde.cu"),  # K1
    ("lde_forward", "tapstark/poly/pallas_ntt.py:492", "tapstark_torch/csrc/coset_lde.cu"),  # K2
    ("sha256_compress", "tapstark/hashes/sha256_device.py:76", "tapstark_torch/csrc/sha256.cu"),  # K5
    ("tapbranch", "tapstark/hashes/sha256_device.py:354", "tapstark_torch/csrc/sha256.cu"),  # K6
]

# Bounds. The card's peaks (NVIDIA H100 SXM, 700 W): 3.35 TB/s of device
# memory and, for the 32-bit integer instructions the kernels run, one
# instruction per lane per clock on all 128 lanes of an SM (its four
# schedulers each issue one 32-lane warp instruction per clock; the int32
# ALU pipe takes 64 lanes, IMAD-form adds and moves the FMA pipe):
# 132 SMs x 128 x 1.98 GHz = 33.5 T op/s, half the 67 TFLOP/s
# float32 figure, which counts two flops per FMA.
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# 32-bit integer instructions per unit of work, counted from the kernels:
OPS_BUTTERFLY = 15  # Montgomery product (mul.wide, mul.lo, mul.hi, adds, select) + add + sub
OPS_MONT_MUL = 8  # a lone Montgomery product (scales, 1/n)
# a SHA-256 round is 14 (six funnel-shift rotates, four LOP3, four IADD3),
# a schedule word 10 (six rotates and shifts, two LOP3, two IADD3)
OPS_COMPRESS = 64 * 14 + 48 * 10 + 8  # rounds, schedule words, feed-forward
OPS_TAPBRANCH = 8 * 3 + OPS_COMPRESS + 64 * 14 + 8  # sort, compress, constant block


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the two roofline times."""
    t_ops, t_mem = ops / INT32_OPS_PER_S, nbytes / MEM_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"


def leaf_bound(r: int, n: int, nb: int) -> tuple[float, str]:
    """`sha256_compress` in the leaf form: R x N lanes of nb compressions;
    suffix, remainder and midstates read once, digests written once."""
    return bound(r * n * nb * OPS_COMPRESS, 4 * (16 * nb * n + 16 * nb * r + 8 * r + 8 * r * n))


def tree_level_bound(m: int) -> tuple[float, str]:
    """`tapbranch` on m nodes: two child digests read, one written."""
    return bound(m * OPS_TAPBRANCH, 96 * m)


def lde_bounds(log_n: int, w: int, log_blowup: int) -> dict:
    n, blow = 1 << log_n, 1 << log_blowup
    ntt_ops = n // 2 * log_n * OPS_BUTTERFLY + n * OPS_MONT_MUL
    return {
        "lde_inverse": bound(w * ntt_ops, 4 * (2 * n * w + n // 2)),
        "lde_forward": bound(blow * w * ntt_ops, 4 * (n * w + blow * n + n // 2 + blow * n * w)),
    }


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


def prove_fibonacci(log_n: int, log_blowup: int, num_queries: int, pow_bits: int, device):
    """Prove and verify Fibonacci through the port; returns (proof bytes,
    witness, prove seconds, verify seconds)."""
    from tapstark_torch.airs import FibonacciAir, generate_fibonacci_trace
    from tapstark_torch.challenger import BfChallenger
    from tapstark_torch.field import F
    from tapstark_torch.stark import prove, verify
    from tapstark_torch.stark.serde import proof_from_bytes, proof_to_bytes

    pcs = make_config(num_queries, log_blowup, pow_bits, device)
    trace = generate_fibonacci_trace(0, 1, 1 << log_n)
    pis = [F(0), F(1), F(int(trace[-1, 1]))]
    t0 = time.perf_counter()
    proof = prove(pcs, FibonacciAir(), BfChallenger(), trace, pis)  # ends on the host
    t1 = time.perf_counter()
    data = proof_to_bytes(proof)
    verify(pcs, FibonacciAir(), BfChallenger(), proof_from_bytes(data), pis)
    t2 = time.perf_counter()
    return data, proof.opening_proof.pow_witness, t1 - t0, t2 - t1


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


def record(stats: dict, name: str, err: int, run_kernel, run_plain, where, bnd=None) -> None:
    """Time kernel and plain version; keep the numbers when `bnd` is given
    (the shape the JSON line reports)."""
    ms = median_ms(run_kernel, 20)
    plain_ms = median_ms(run_plain, 5)
    s = stats.setdefault(name, {"max_abs_err": 0})
    s["max_abs_err"] = max(s["max_abs_err"], err)
    extra = ""
    if bnd is not None:
        s.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1])
        extra = f", bound {bnd[0]:.4f} ms ({bnd[1]})"
    print(f"kernel {name} {where}: equal, {ms:.4f} ms, plain {plain_ms:.4f} ms{extra}", flush=True)


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
        bounds = lde_bounds(log_n, w, log_blowup) if (log_n, w, log_blowup) == LDE_SHAPES[0] else {}
        err = compare("lde_inverse", coeffs, cuda_ntt.lde_inverse_plain(evals), where)
        record(stats, "lde_inverse", err, lambda: cuda_ntt.lde_inverse(evals),
               lambda: cuda_ntt.lde_inverse_plain(evals), where, bounds.get("lde_inverse"))
        got = cuda_ntt.lde_forward(coeffs, log_blowup, shift)
        err = compare("lde_forward", got, cuda_ntt.lde_forward_plain(coeffs, log_blowup, shift), where)
        record(stats, "lde_forward", err, lambda: cuda_ntt.lde_forward(coeffs, log_blowup, shift),
               lambda: cuda_ntt.lde_forward_plain(coeffs, log_blowup, shift), where,
               bounds.get("lde_forward"))


def check_sha_kernels(dev, stats: dict) -> None:
    """K5/K6's counterparts against their plain versions: plain-form lanes,
    the leaf form (R = 28 repetitions of 2^16 leaves, 1 and 2 suffix
    blocks), and a TapBranch tree level read through strided children."""
    from tapstark_torch.hashes import sha256_device as sd

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def words(*shape):  # uniform 32-bit words, made on the card
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device=dev, generator=gen)

    for m in SHA_LANES:
        state, block = words(8, m), words(32, m)  # two chained blocks per lane
        where = f"M={m} nb=2"
        err = compare("sha256_compress", sd.compress_wm(state, block), sd.compress_wm_plain(state, block), where)
        record(stats, "sha256_compress", err, lambda: sd.compress_wm(state, block),
               lambda: sd.compress_wm_plain(state, block), where)
        h1, h2 = words(8, m), words(8, m)
        h2[:, ::3] = h1[:, ::3]  # equal pairs exercise the lexicographic tie
        h2[0, 1::3] = h1[0, 1::3]  # so do pairs that first differ past word 0
        where = f"M={m}"
        err = compare("tapbranch", sd.tapbranch_wm(h1, h2), sd.tapbranch_wm_plain(h1, h2), where)
        record(stats, "tapbranch", err, lambda: sd.tapbranch_wm(h1, h2),
               lambda: sd.tapbranch_wm_plain(h1, h2), where)

    r, n = SHA_LEAF
    for nb in SHA_LEAF_BLOCKS:
        mids, suffix, rem = words(8, r), words(16 * nb, n), words(16 * nb, r)
        where = f"leaf form R={r} N={n} nb={nb}"
        err = compare("sha256_compress", sd.compress_wm(mids, suffix, rem),
                      sd.compress_wm_plain(mids, suffix, rem), where)
        # the JSON line reports the one-block form (its shape since the port's first SHA run)
        bnd = leaf_bound(r, n, nb) if nb == 1 else None
        record(stats, "sha256_compress", err, lambda: sd.compress_wm(mids, suffix, rem),
               lambda: sd.compress_wm_plain(mids, suffix, rem), where, bnd)

    level = words(8, r * n)
    children = level.view(8, -1, 2)
    h1, h2 = children[:, :, 0], children[:, :, 1]
    m = r * n // 2
    where = f"tree level M={m} (strided children)"
    err = compare("tapbranch", sd.tapbranch_wm(h1, h2), sd.tapbranch_wm_plain(h1, h2), where)
    record(stats, "tapbranch", err, lambda: sd.tapbranch_wm(h1, h2),
           lambda: sd.tapbranch_wm_plain(h1, h2), where, tree_level_bound(m))


# Commits held against the host engine: (what, matrix shape, repetitions,
# suffix blocks per leaf). The trace commit's shard (2^22 leaves of 2
# base-field values) and the first FRI layer committed on the card (2^21
# leaves of 2 extension values): the two forms of the leaf phase.
CARD_COMMITS = [("trace shard", (1 << 22, 2), 2, 1), ("fri layer", (1 << 21, 2, 4), 2, 2)]


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
        queries = [0, 1, 255, 256, 123457, n - 1]
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

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

    phase("kernels vs plain")
    stats: dict = {}
    check_lde_kernels(dev, stats)
    check_sha_kernels(dev, stats)

    phase("commits: card vs host engine")
    check_commits_on_card(dev)

    phase("golden proof on cuda")
    data, witness, t_prove, t_verify = prove_fibonacci(3, 2, 28, 8, dev)
    sha = hashlib.sha256(data).hexdigest()
    print(f"sha256 {sha} bytes {len(data)} witness {witness} prove {t_prove:.3f} s verify {t_verify:.3f} s")
    if (sha, len(data), witness) != (GOLDEN_PROOF_SHA256, GOLDEN_PROOF_LEN, GOLDEN_POW_WITNESS):
        raise AssertionError("golden proof bytes differ from the frozen ones")

    phase("north-star prove on cuda")
    from tapstark_torch.hashes import sha256_device
    from tapstark_torch.poly import cuda_ntt
    from tapstark_torch.utils import profiling

    profiling.reset()
    profiling.enable()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_ntt.reset_launch_counts()
    sha256_device.reset_launch_counts()
    data, witness, t_prove, t_verify = prove_fibonacci(device=dev, **NORTH_STAR)
    launches = {**cuda_ntt.launches, **sha256_device.launches}
    profiling.enable(False)
    print(
        f"fibonacci 2^{NORTH_STAR['log_n']} rows: prove {t_prove:.3f} s, verify {t_verify:.3f} s "
        f"(accepted), proof {len(data)} bytes sha256 {hashlib.sha256(data).hexdigest()} witness {witness}"
    )
    for name, r in profiling.report().items():
        print(f"phase {name}: {r['total_s']:.3f} s over {r['calls']} call(s)")
    print(f"launches {launches}")
    if min(launches[name] for name, _, _ in KERNELS) == 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    loaded = [
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "tapstark") and sys.modules[m] is not None
    ]
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": stats[name]["ms"],
            "plain_ms": stats[name]["plain_ms"],
            "bound_ms": stats[name]["bound_ms"],
            "bound_by": stats[name]["bound_by"],
            "library_ms": None,  # no PyTorch call computes a modular NTT or SHA-256
        }
        for name, replaces, source in KERNELS
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
