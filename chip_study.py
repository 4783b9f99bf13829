"""Longer measurements of the PyTorch/CUDA port on one GPU.

    python3 chip_study.py [kernels | sass | routes | device | suffix | busy | peak | wide | fri_tail | quotient
                           | segments | spans | transcript | gather | blake3 | mesh ...]

`chip_smoke.py` checks the port; this script measures what it leaves
out, for PERF.md (every phase, or the phases named):

- the SHA-256 kernels alone at the north star's largest shapes, and the
  SASS instruction classes of each in the built library (`cuobjdump -sass`);
- the two coset-LDE routes at 2^22 and 2^23 rows: the fused halves (K1/K2's
  counterparts) against the four-step blocks route (K3/K4's);
- the NTT kernels' own device time at the prove shapes, and the limb-matmul
  kernel's (K7) at the 2^20 matmul LDE's member shapes with the LDE itself,
  under `torch.profiler` (the CUDA-event times of `chip_smoke.py` take in
  the host's enqueue of each wrapper call);
- the leaf-suffix builder (plain torch, no kernel of its own) on one
  north-star trace-commit shard;
- one prove at 2^20 and one at 2^22 rows under `torch.profiler`: the
  card's busy share and its largest items;
- the span of a 2^22-row prove inside which its peak device memory is set;
- the wide row's prove (chip_smoke.py's WIDE_ROW): busy share, largest
  items and the span that sets its peak;
- one FRI layer (fold and commit) on the card and on the host at the sizes
  around the host-tail switch (`fri/prover.py HOST_TAIL_MAX_HALF`);
- the quotient kernels (the AIR's constraint program, generated per AIR
  as straight-line segments) and their plain version (the selectors and
  the eager folder) at each prove's quotient coset (chip_smoke.py
  QUOTIENT_SHAPES): each one's CUDA-event time and own device time under
  `torch.profiler`, the kernels' summed over the segments;
- the segment length S (air/program.py SEGMENT_INSTRUCTIONS): the
  flagship's and the wide row's programs' build seconds and their
  kernels' device time at the provers' cosets, for each S of
  SEGMENT_STUDY;
- each prove's spans warm (2^20, 2^22, the wide row, the flagship), a
  second prove under chip_smoke.py's counters and a third with spans off;
- the FRI transcript step (`transcript_step`) at the provers' root
  counts: its event time and its own device time;
- the gather that gives the quotient its coset (`get_evaluations_on_domain`):
  by columns (the card's kernel) against by rows and against one
  index_select, at the provers' cosets;
- the flagship (chip_smoke.py BLAKE3): busy share, largest items and the
  span that sets its peak; its proof's bytes go to
  `chiprun_out/blake3_proof.bin`, for `tools/freeze_port_references.py
  blake3_port`;
- the mesh across cards (`mesh`, on a host of 2 or more cards, four
  where there are four): the cards' peer-access
  matrix, chip_smoke.py's mesh checks (the distributed LDE, the sharded
  prover step, the north-star prove) with the mesh's shards on the cards,
  the 2^22-row prove over the mesh held to its frozen bytes, the
  proves' times against one card's in turns, `dryrun_multichip`, the
  distributed LDE's time against one card's at 2^20 and 2^22 rows, and
  each all_to_all of those LDEs against its bound (the bytes a card sends
  over NVLink's 450 GB/s each way).

It builds the kernels from the checkout as `chip_smoke.py` does, and
like it loads neither JAX nor the JAX package. Without a CUDA device it
exits at once.
"""

from __future__ import annotations

import importlib
import os
import statistics
import subprocess
import sys
import time

import chip_smoke as smoke  # blocks jax and tapstark before torch loads
import numpy as np  # noqa: E402
import torch  # noqa: E402
from tapstark_torch.commit.tcs import LEVEL_CUTOFF  # noqa: E402

FRI_TAIL_LOG_HALVES = [8, 10, 12, 13, 14, 16]
ROUTE_LOG_NS = [22, 23]  # width 2, blowup 4


def lde_routes(dev) -> None:
    """`coset_lde_batch_cuda` (fused halves) against `coset_lde_blocks`
    (column NTTs) on the same input: median of 10 CUDA-event times each,
    measured in turns (fused, blocks, blocks, fused), words equal."""
    from tapstark_torch.field.constants import MULT_GENERATOR as shift
    from tapstark_torch.poly import cols_ntt, cuda_ntt

    rng = np.random.default_rng(8)
    for log_n in ROUTE_LOG_NS:
        evals = smoke._mont_on(dev, rng, 1 << log_n, 2)
        fused = lambda: cuda_ntt.coset_lde_batch_cuda(evals, 2, shift)  # noqa: E731
        blocks = lambda: cols_ntt.coset_lde_blocks(evals, 2, shift)  # noqa: E731
        smoke.compare("blocks route", blocks(), fused(), f"2^{log_n} x 2")
        times = {"fused": [], "blocks": []}
        for name in ("fused", "blocks", "blocks", "fused"):
            times[name].append(smoke.median_ms(fused if name == "fused" else blocks, 10))
        print(f"lde routes 2^{log_n} x 2 blowup 4: fused {times['fused']} ms, blocks {times['blocks']} ms "
              f"(medians of 10, in turns); equal")
        del evals


def _device_line(name: str, fn, calls: int = 20, only: str = "", once: bool = False) -> None:
    """fn's CUDA-event time (median of `calls`) and, over `calls` calls under
    torch.profiler after a warm-up, the device time of each kernel it
    launches (mean a launch, launches a call), those whose name holds
    `only`, and all kernels' total a call; with `once` (each of those
    kernels launches once a call), also the sum of their means, which
    holds where the profiler drops some of a long run's events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    event_ms = smoke.median_ms(fn, calls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / calls / 1e3
    mine = [e for e in kernels if only in e.key]
    summed = f"; {only} kernels {sum(e.self_device_time_total / e.count for e in mine) / 1e3:.4f} ms a call" if once \
        else ""
    print(f"{name}: event {event_ms:.4f} ms; device total {total:.4f} ms a call{summed}; " + ", ".join(
        f"{_kernel_name(e.key)} {e.self_device_time_total / e.count / 1e3:.4f} ms x{e.count / calls:g}"
        for e in mine), flush=True)


def device_times(dev) -> None:
    """Each NTT wrapper at the prove shapes, and `mod_matmul` (natural form,
    with twiddle) at the 2^20 matmul LDE's inverse and forward member
    shapes (R 128, B 2^14 and 2^16) and the LDE itself (2^20 x 2, blowup
    4; its K7 launches listed): 20 calls each under torch.profiler after a
    warm-up (the LDE 5), the device time of each kernel, a launch (mean),
    and the wrapper's CUDA-event time beside it."""
    from tapstark_torch.field.constants import MULT_GENERATOR as shift
    from tapstark_torch.field.constants import P
    from tapstark_torch.poly import cols_ntt, cuda_ntt
    from tapstark_torch.poly import matmul_ntt as mm

    rng = np.random.default_rng(10)
    for w in (2, 4):
        evals = smoke._mont_on(dev, rng, 1 << 20, w)
        coeffs = cuda_ntt.lde_inverse(evals)
        x = smoke._mont_on(dev, rng, 1 << 11, w << 11)
        a = cols_ntt.dif_cols(x, 11, True)
        xb = smoke._mont_on(dev, rng, 1 << 22, w)
        b = cols_ntt.dit_cols_first(xb, 2, shift, True)
        cases = {
            f"lde_inverse 2^20 x {w}": lambda: cuda_ntt.lde_inverse(evals),
            f"lde_forward 2^20 x {w} blowup 4": lambda: cuda_ntt.lde_forward(coeffs, 2, shift),
            f"dif_cols (R 2^11, B {w << 11})": lambda: cols_ntt.dif_cols(x, 11, True),
            f"dif_cols last member 2^22 x {w}": lambda: cols_ntt.dif_cols_last(a, 11),
            f"dit_cols first member 2^22 x {w} blowup 4": lambda: cols_ntt.dit_cols_first(xb, 2, shift, True),
            f"dit_cols (R 2^11, B {b.shape[1]})": lambda: cols_ntt.dit_cols(b, 11, False),
        }
        for name, fn in cases.items():
            _device_line(name, fn)
        del evals, coeffs, x, a, xb, b
    for log_b in (14, 16):
        x = torch.from_numpy(rng.integers(0, P, (128, 1 << log_b)).astype(np.int32)).to(dev)  # canonical
        tw = smoke._mont_on(dev, rng, 128, 1 << log_b)
        _device_line(f"mod_matmul (R 128, B 2^{log_b}) twiddle, inverse", lambda: mm.mod_matmul(x, 7, True, tw))
    evals = smoke._mont_on(dev, rng, 1 << 20, 2)
    _device_line("limb-matmul LDE 2^20 x 2 blowup 4", lambda: mm.coset_lde_batch_matmul(evals, 2, shift), 5,
                 "matmul")


def transcript_times(dev) -> None:
    """`transcript_step` (csrc/transcript.cu) at the provers' root counts
    (R 28 and 16, Blake3Compression, no pending words; roots read through
    K6's strided view): its CUDA-event time and its own device time under
    torch.profiler, 200 calls."""
    from tapstark_torch.challenger import device_tail as dt

    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    for reps in (28, 16):
        cv, pending = torch.randint(0, 1 << 30, (8,), dtype=torch.int32, device=dev, generator=gen), \
            torch.empty(0, dtype=torch.int32, device=dev)
        roots = torch.randint(0, 1 << 30, (8, reps, 5), dtype=torch.int32, device=dev, generator=gen)[:, :, -1].T
        _device_line(f"transcript_step R {reps}", lambda: dt.transcript_step(cv, pending, roots, dt.KIND_BLAKE3),
                     200, "transcript")


def _kernel_name(key: str) -> str:
    """A profiler key's kernel name: `ns::name(args)` -> `name`."""
    return key.split("(anonymous namespace)::")[-1].split("(")[0]


def _words(dev, seed: int):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def words(*shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device=dev, generator=gen)

    return words


def _commit_to_cutoff(sd, mids, suffix, rem):
    """What a commit launches up to the cutoff, level 8: the leaf launch
    (levels 1..4) and TapBranch levels 4 -> 8, writing level 8 only."""
    k = LEVEL_CUTOFF - sd.LEAF_LEVELS
    return sd.tapbranch_levels(sd.tapleaf_subtrees(mids, suffix, rem, sd.LEAF_LEVELS), k, k)


def _to_root(sd, level, depth):
    """Levels 8 -> root of a depth-`depth` tree, BRANCH_LEVELS a launch,
    every level written."""
    for lo in range(LEVEL_CUTOFF, depth, sd.BRANCH_LEVELS):
        k = min(sd.BRANCH_LEVELS, depth - lo)
        level = sd.tapbranch_levels(level, k)[:, :, -(level.shape[2] >> k):]
    return level


def kernels_full_size(dev) -> None:
    """The kernels alone, median of 10: a commit's launches up to level 8
    (the leaf launch, then levels 4 -> 8) for the 2^22-row trace commit (28
    repetitions x 2^22 leaves, 1 suffix block) and the first FRI layer on
    the card (28 x 2^21, 2 blocks), each launch also alone; then levels
    8 -> root of the 2^22-leaf tree."""
    from tapstark_torch.hashes import sha256_device as sd

    words = _words(dev, 4)
    r = 28
    for n, nb in ((1 << 22, 1), (1 << 21, 2)):
        mids, suffix, rem = words(8, r), words(16 * nb, n), words(16 * nb, r)
        level4 = sd.tapleaf_subtrees(mids, suffix, rem, sd.LEAF_LEVELS)
        k = LEVEL_CUTOFF - sd.LEAF_LEVELS
        t_leaf = smoke.median_ms(lambda: sd.tapleaf_subtrees(mids, suffix, rem, sd.LEAF_LEVELS), 10)
        t_leaves = smoke.median_ms(lambda: sd.tapleaf_subtrees(mids, suffix, rem, 0), 10)
        t_up = smoke.median_ms(lambda: sd.tapbranch_levels(level4, k, k), 10)
        t_all = smoke.median_ms(lambda: _commit_to_cutoff(sd, mids, suffix, rem), 10)
        b_leaf = smoke.leaf_bound(r, n, nb, sd.LEAF_LEVELS)
        b_up = smoke.levels_bound(r, n >> sd.LEAF_LEVELS, k, k)
        print(f"commit to level 8, R={r} N={n} nb={nb}: {t_all:.3f} ms (bound {b_leaf[0] + b_up[0]:.3f} ms); "
              f"tapleaf_subtrees {t_leaf:.3f} ms, bound {b_leaf[0]:.3f} ms ({b_leaf[2]}); "
              f"tapbranch_levels 4->8 {t_up:.3f} ms, bound {b_up[0]:.3f} ms ({b_up[2]}); "
              f"the leaves alone (no level) {t_leaves:.3f} ms")
        del mids, suffix, rem, level4
    depth = 22
    level8 = words(8, r, 1 << (depth - LEVEL_CUTOFF))
    ms = smoke.median_ms(lambda: _to_root(sd, level8, depth), 10)
    bounds = [smoke.levels_bound(r, 1 << (depth - lo), min(sd.BRANCH_LEVELS, depth - lo), 1)[0]
              for lo in range(LEVEL_CUTOFF, depth, sd.BRANCH_LEVELS)]
    print(f"tapbranch_levels 8 -> root of R={r} trees of 2^{depth} leaves: {ms:.3f} ms in {len(bounds)} launches, "
          f"bound {sum(bounds):.4f} ms")


SASS_CLASSES = ["SHF", "LOP3", "IADD3", "IMAD", "LEA", "ISETP", "SEL", "MOV", "LDS", "STS", "LDG", "STG", "BAR"]


def sass_counts(path: str) -> dict:
    """{kernel: {instruction class: count}} of a built library, static
    counts from `cuobjdump -sass`."""
    cuobjdump = _tool("cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True, check=True).stdout
    counts, kernel = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernel = next((k for k in ("tapleaf_subtrees", "tapbranch_levels") if k in name), None)
            if kernel:
                counts[kernel] = {c: 0 for c in SASS_CLASSES + ["other", "all"]}
        elif kernel and line.strip().startswith("/*") and "*/" in line:
            body = line.split("*/", 1)[1].strip()
            if not body or body.startswith("/*"):
                continue
            tokens = body.split()
            op = tokens[1] if tokens[0].startswith("@") else tokens[0]
            cls = next((c for c in SASS_CLASSES if op.split(".")[0] == c), "other")
            counts[kernel][cls] += 1
            counts[kernel]["all"] += 1
    return counts


def _tool(name: str) -> str:
    import os
    import shutil

    from tapstark_torch import _build

    found = shutil.which(name) or os.path.join(os.path.dirname(_build._nvcc()), name)
    if not os.path.exists(found):
        raise RuntimeError(f"{name} not found")
    return found


def sha_sass(dev) -> None:
    """The SASS instruction classes of the two SHA-256 kernels, static
    counts in the built library."""
    from tapstark_torch import _build

    for kernel, c in sass_counts(_build.build_info["path"]).items():
        print(f"{kernel} SASS: {c}")


def suffix_builder(dev) -> None:
    """`build_tail_suffix_words` on one trace-commit shard (2^22 leaves of 2
    base-field values), median of 5."""
    from tapstark_torch.commit import BcManager
    from tapstark_torch.commit import device_commit as dc
    from tapstark_torch.commit.tcs import TCS, FMatrix
    from tapstark_torch.field.constants import P
    from tapstark_torch.field.device import np_to_mont

    canon = np.random.default_rng(2).integers(0, P, (1 << 22, 2)).astype(np.uint32)
    mont = torch.from_numpy(np_to_mont(canon).view(np.int32)).to(dev)
    _, head, fixed_len = TCS(BcManager())._assign_locks(2, False)
    plan = dc.ShardSuffixPlan(len(head), fixed_len)
    vals = dc.padding_matrix_dev([FMatrix(dev=mont)])
    ms = smoke.median_ms(lambda: dc.build_tail_suffix_words(vals, plan), 5)
    print(f"suffix words of 2^22 leaves ({plan.suf_words} words each): {ms:.3f} ms")


def prove_wide(dev) -> float:
    """One prove of chip_smoke.py's wide row (RecursionAir 2^18 x 163,
    blowup 16, 16 queries, L = 5) through `standard_config`; returns its
    seconds."""
    from tapstark_torch.airs import RecursionAir, generate_recursion_trace
    from tapstark_torch.field import F
    from tapstark_torch.stark import prove
    from tapstark_torch.stark.config import standard_config

    cfg = smoke.WIDE_ROW
    config = standard_config(cfg["log_blowup"], cfg["num_queries"], cfg["pow_bits"], device=dev,
                             log_final_poly_len=cfg["log_final_poly_len"])
    trace, pis = generate_recursion_trace(1 << cfg["log_n"])
    t0 = time.perf_counter()
    prove(config.pcs, RecursionAir(), config.challenger(), trace, [F(x) for x in pis])
    return time.perf_counter() - t0


def busy_share(dev, name: str, run_prove) -> None:
    """One prove (`run_prove(dev)` returns its seconds) under
    torch.profiler, after an unprofiled one: the card's summed device self
    time over the prove's wall time, and the largest items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_prove = run_prove(dev)
    print(f"{name}: unprofiled prove {t_prove:.3f} s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_prove = run_prove(dev)
    # the card's own events (kernels, copies); an aten op's entry repeats
    # the device time of the kernels it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"profiled prove {t_prove:.3f} s: card busy {busy:.3f} s ({100 * busy / t_prove:.1f} %)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6} {e.key[:90]}")


def fib_prove(cfg: dict):
    """`run_prove` for `busy_share` / `peak_memory`: a Fibonacci prove."""
    return lambda dev: smoke.prove_fibonacci(device=dev, **cfg)["prove_s"]


def peak_memory(dev, name: str, run_prove) -> None:
    """Which span sets the peak device memory of a prove (`run_prove(dev)`):
    the running peak (`max_memory_allocated`) read as each span ends (the
    provers' and the commit's `span` replaced for the run); the span that
    first ends at the final peak holds the allocation that set it."""
    import contextlib
    from unittest import mock

    from tapstark_torch.commit import tcs
    from tapstark_torch.fri import prover as fri_prover
    from tapstark_torch.stark import prover as stark_prover

    seen = []

    @contextlib.contextmanager
    def span(name, device=None):
        try:
            yield
        finally:
            seen.append((name, torch.cuda.max_memory_allocated(dev)))

    torch.empty(1, device=dev)  # the allocator has no stats before its first allocation
    torch.cuda.reset_peak_memory_stats(dev)
    with contextlib.ExitStack() as patches:
        for module in (tcs, fri_prover, stark_prover):
            patches.enter_context(mock.patch.object(module, "span", span))
        run_prove(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    first = next(i for i, (_, m) in enumerate(seen) if m == peak)
    steps = [(name, m) for i, (name, m) in enumerate(seen) if i == 0 or m > seen[i - 1][1]]
    print(f"{name}: peak {peak / 2**30:.2f} GiB, first reached by the end of span {seen[first][0]} "
          f"(span end {first + 1} of {len(seen)}); the running peak rose at: "
          + ", ".join(f"{name} {m / 2**30:.2f}" for name, m in steps))


def fri_tail(dev) -> None:
    """One FRI layer of `half` folded rows, 28 repetitions: commit + fold
    on the card (device tensors) against commit + fold on the host (numpy),
    median of 5 each, alternating."""
    from tapstark_torch.commit import BcManager, TapTreeMmcs
    from tapstark_torch.commit.tcs import FMatrix
    from tapstark_torch.field.constants import P
    from tapstark_torch.field.device import ef_const, fetch_canonical, np_to_mont
    from tapstark_torch.field.scalar import EF4
    from tapstark_torch.poly.fold import fold_matrix, fold_matrix_host

    rng = np.random.default_rng(3)
    beta = EF4([int(v) for v in rng.integers(0, P, 4)])
    beta_dev = ef_const(beta, dev)
    mmcs = TapTreeMmcs(BcManager(), 28, ext=True)
    for log_half in FRI_TAIL_LOG_HALVES:
        canon = rng.integers(0, P, (1 << log_half, 2, 4)).astype(np.uint32)
        mont = torch.from_numpy(np_to_mont(canon).view(np.int32)).to(dev)

        def on_card():
            mmcs.commit_matrix(FMatrix(dev=mont))
            fetch_canonical(fold_matrix(beta_dev, mont)[:1])  # ends on the host, as a layer does

        def on_host():
            mmcs.commit_matrix(FMatrix(canon))
            fold_matrix_host(beta, canon)

        times = {"card": [], "host": []}
        for _ in range(5):
            for name, fn in (("card", on_card), ("host", on_host)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times[name].append(1e3 * (time.perf_counter() - t0))
        print(f"fri layer half=2^{log_half}: fold+commit on card {statistics.median(times['card']):.2f} ms, "
              f"on host {statistics.median(times['host']):.2f} ms")


def quotient(dev) -> None:
    """The quotient kernels and their plain version at each QUOTIENT_SHAPES
    entry (random cosets, as chip_smoke.py makes them), each under
    torch.profiler after a warm-up (`_device_line`): the kernels' own
    device time over 10 calls (each segment a launch, and their sum); the
    plain version's CUDA-event time and the device time of all its kernels,
    over 3 calls (1 on the 1548-column AIR: about 1.3 million launches);
    the bound."""
    from tapstark_torch.air import program

    # every kernel first: after the eager folder's trace of ~1.3 million
    # launches, later profiler sessions recorded no device time for the
    # kernel on that card
    for eager in (False, True):
        for i, (what, air_name, log_n) in enumerate(smoke.QUOTIENT_SHAPES):
            air, pis, td, qd, tq, alpha = smoke.quotient_case(dev, air_name, log_n, 20 + i)
            m, width = tq.shape
            if eager:
                _device_line(f"plain version {what} ({m} x {width})",
                             lambda: smoke.quotient_plain(air, pis, td, qd, tq, alpha), 1 if width > 1000 else 3)
            else:
                kernels = smoke.build_quotient(air, len(pis))
                _device_line(f"quotient_program {what} ({m} x {width}, {len(kernels.plan.segments)} segments)",
                             lambda: program.quotient_program(air, pis, td, qd, tq, alpha), 10, "quotient_segment",
                             once=True)
                prog = program.program_for(air, len(pis))
                bnd = smoke.quotient_bound(prog.counts, set(kernels.plan.selectors), m, width)
                print(f"bound {what}: {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
            del tq


SEGMENT_STUDY = [500, 1000, 2000]


def segments(dev) -> None:
    """For each S of SEGMENT_STUDY: the flagship's and the wide row's
    programs built anew (generation, nvcc of every segment at once, link,
    load: seconds), their registers and spills, and their device time at
    the provers' cosets (`_device_line`, 10 calls)."""
    from tapstark_torch.air import codegen, program

    print(f"CPUs: os.cpu_count() {os.cpu_count()}, affinity {len(os.sched_getaffinity(0))}", flush=True)
    cases = []
    for i in (0, 3):  # the flagship, the wide row
        what, air_name, log_n = smoke.QUOTIENT_SHAPES[i]
        case = smoke.quotient_case(dev, air_name, log_n, 20 + i)
        cases.append((what, case, smoke.quotient_plain(*case)))
    for S in SEGMENT_STUDY:
        for what, (air, pis, td, qd, tq, alpha), want in cases:
            kernels = codegen.kernels(program.program_for(air, len(pis)), S)
            pl = kernels.plan
            print(f"S {S} {what}: {len(pl.segments)} segments, built {kernels.built} in {kernels.seconds:.2f} s; live "
                  f"at the cuts {[sg.live_out for sg in pl.segments[:-1]]}; registers "
                  f"{[px['registers'] for px in kernels.ptxas]}; spill stores "
                  f"{[px['spill_stores'] for px in kernels.ptxas]} bytes; nvcc seconds a segment "
                  f"{[round(px.get('nvcc_seconds', 0), 1) for px in kernels.ptxas]}", flush=True)
            run = lambda: program.launch_segments(kernels, air, pis, td, qd, tq, alpha)  # noqa: E731
            smoke.compare(f"quotient_program S={S}", run(), want, what)
            _device_line(f"quotient_program S={S} {what}", run, 10, "quotient_segment", once=True)


GATHER_NARROW_SHAPES = [(1 << 22, 8, 1 << 20)]  # beside BITREV_SHAPES: the narrow form at its widest


def _tile_only_gather():
    """`csrc/bitrev_cols.cu` built with its narrow form off
    (TAPSTARK_BITREV_NARROW_MAX=0): its entry, the tile kernel at every
    width."""
    import ctypes

    from tapstark_torch import _build

    so_path = os.path.join(_build.BUILD_DIR, "libbitrev_tile_only.so")
    _build.compile_library([os.path.join(_build.CSRC, "bitrev_cols.cu")], so_path,
                           ["-DTAPSTARK_BITREV_NARROW_MAX=0"])
    fn = ctypes.CDLL(so_path).tapstark_bitrev_cols
    fn.argtypes, fn.restype = _build.SIGNATURES["tapstark_bitrev_cols"]
    return fn


def gather(dev) -> None:
    """`get_evaluations_on_domain`'s gather at each prove's coset
    (chip_smoke.py BITREV_SHAPES, the golden's left out, and
    GATHER_NARROW_SHAPES): the card's by columns (`bit_reverse_cols`'
    kernel) against the row gather (bit_reverse_rows, the JAX package's)
    and one index_select of the LDE's transpose, and at up to 8 columns
    its tile kernel against its narrow form; CUDA-event medians of 10, in
    turns; all equal."""
    ntt = importlib.import_module("tapstark_torch.poly.ntt")  # the package binds `ntt` to the function
    from tapstark_torch.poly.powers import bitrev_indices_dev

    tile_only = _tile_only_gather()
    rng = np.random.default_rng(9)
    for lde_rows, width, m in [*smoke.BITREV_SHAPES[:-1], *GATHER_NARROW_SHAPES]:
        lde = smoke._mont_on(dev, rng, lde_rows, width)
        rev = bitrev_indices_dev(m.bit_length() - 1, dev)
        fns = {"rows": lambda: ntt.bit_reverse_rows(lde[:m]), "kernel": lambda: ntt.bit_reverse_cols(lde, m),
               "index_select": lambda: torch.index_select(lde[:m].t(), 1, rev).t()}
        if width <= 8:
            def tile():
                out = torch.empty((width, m), dtype=torch.int32, device=dev)
                err = tile_only(lde.data_ptr(), width, m.bit_length() - 1, out.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
                if err != 0:
                    raise RuntimeError(f"tile-only gather: CUDA error {err}")
                return out.t()

            fns["tile kernel"] = tile
        for name in fns:
            if name != "rows":
                smoke.compare("gather", fns[name](), fns["rows"](), f"{name}, {m} x {width}")
        times = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            times[name].append(smoke.median_ms(fns[name], 10))
        print(f"gather {m} x {width} (LDE {lde_rows} rows): " + ", ".join(f"{k} {v} ms" for k, v in times.items()),
              flush=True)
        del lde


def _prove_fibonacci(cfg: dict):
    """A Fibonacci prove without its verify (chip_smoke.py's configs), for
    `spans`: returns its seconds."""
    from tapstark_torch.airs import FibonacciAir, generate_fibonacci_trace
    from tapstark_torch.challenger import BfChallenger
    from tapstark_torch.field import F
    from tapstark_torch.stark import prove

    def run(dev) -> float:
        pcs = smoke.make_config(cfg["num_queries"], cfg["log_blowup"], cfg["pow_bits"], dev)
        trace = generate_fibonacci_trace(0, 1, 1 << cfg["log_n"])
        t0 = time.perf_counter()
        prove(pcs, FibonacciAir(), BfChallenger(), trace, [F(0), F(1), F(int(trace[-1, 1]))])
        return time.perf_counter() - t0

    return run


def spans(dev) -> None:
    """Each prove's spans warm: 2^20, 2^22, the wide row and the flagship,
    each proved once to warm up (kernels built, the AIR's program recorded
    and, where it is generated, built), once under chip_smoke.py
    run_counted (spans, launches, peak device memory) and once with spans
    off (a span synchronizes the card at its end, which hides work that
    overlaps it), its peak device memory beside it."""
    cases = [("2^20", _prove_fibonacci(smoke.NORTH_STAR)), ("2^22", _prove_fibonacci(smoke.BLOCKS_PROVE)),
             ("wide row", prove_wide), ("flagship", prove_blake3)]
    for name, run in cases:
        run(dev)
        seconds, _ = smoke.run_counted(dev, lambda: run(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        off = run(dev)
        print(f"spans {name}: warm prove {seconds:.3f} s; spans off {off:.3f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)


_flagship: dict = {}


def prove_blake3(dev) -> float:
    """One prove of the flagship (chip_smoke.py BLAKE3; the trace made
    once); writes the proof's bytes to chiprun_out/blake3_proof.bin and
    returns the prove's seconds."""
    import hashlib
    import os

    from tapstark_torch.airs import Blake3SpongeChainAir, generate_blake3_sponge_trace
    from tapstark_torch.challenger import BfChallenger
    from tapstark_torch.field import F
    from tapstark_torch.stark import prove
    from tapstark_torch.stark.serde import proof_to_bytes

    cfg = smoke.BLAKE3
    if not _flagship:
        t0 = time.perf_counter()
        trace, pis, _ = generate_blake3_sponge_trace(smoke.sponge_blocks(cfg["blocks"]))
        print(f"flagship: host trace generator {time.perf_counter() - t0:.3f} s")
        _flagship.update(trace=trace, pis=[F(x) for x in pis])
    pcs = smoke.make_config(cfg["num_queries"], cfg["log_blowup"], cfg["pow_bits"], dev)
    t0 = time.perf_counter()
    proof = prove(pcs, Blake3SpongeChainAir(), BfChallenger(), _flagship["trace"], _flagship["pis"])
    t_prove = time.perf_counter() - t0
    data = proof_to_bytes(proof)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "blake3_proof.bin"), "wb") as f:
        f.write(data)
    print(f"flagship: prove {t_prove:.3f} s, proof {len(data)} bytes sha256 {hashlib.sha256(data).hexdigest()} "
          f"witness {proof.opening_proof.pow_witness}", flush=True)
    return t_prove


NVLINK_BYTES_PER_S = 450e9  # one way, card to card (NVIDIA's H100 SXM data sheet: 900 GB/s both ways)
MESH_LDE_LOG_NS = [20, 22]  # width 2, blowup 4


def _prove_once(cfg: dict, make_pcs) -> tuple:
    """A Fibonacci prove without its verify on a new PCS from `make_pcs()`
    (a PCS's bit-commitment secrets advance with every prove):
    (seconds, (sha256, bytes, PoW witness))."""
    import hashlib

    from tapstark_torch.airs import FibonacciAir, generate_fibonacci_trace
    from tapstark_torch.challenger import BfChallenger
    from tapstark_torch.field import F
    from tapstark_torch.stark import prove
    from tapstark_torch.stark.serde import proof_to_bytes

    pcs = make_pcs()
    trace = generate_fibonacci_trace(0, 1, 1 << cfg["log_n"])
    t0 = time.perf_counter()
    proof = prove(pcs, FibonacciAir(), BfChallenger(), trace, [F(0), F(1), F(int(trace[-1, 1]))])
    seconds = time.perf_counter() - t0
    data = proof_to_bytes(proof)
    return seconds, (hashlib.sha256(data).hexdigest(), len(data), proof.opening_proof.pow_witness)


def mesh(dev) -> None:
    """The mesh across the host's cards (four where there are four, else
    two; fewer than two raise): the peer-access matrix; chip_smoke.py's
    mesh checks with the shards on the cards; the north-star and 2^22
    proves over the mesh, verified and held to their frozen bytes under
    chip_smoke.py's counters, then timed without their verify against one
    card's in turns (one card, mesh, mesh, one card); `dryrun_multichip`;
    the distributed coset LDE (width 2, blowup 4) at MESH_LDE_LOG_NS rows
    against `coset_lde_batch_auto` on card 0, wall time in turns and the
    device time of all cards summed (torch.profiler); and each all_to_all
    of those LDEs alone against its bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tapstark_torch.airs import FibonacciAir
    from tapstark_torch.field.constants import MULT_GENERATOR as shift
    from tapstark_torch.mesh import Mesh, collectives, distributed_coset_lde, dryrun_multichip
    from tapstark_torch.mesh.ntt import split
    ntt = importlib.import_module("tapstark_torch.poly.ntt")  # the package binds `ntt` to the function
    from tapstark_torch.stark.config import standard_config

    cards = torch.cuda.device_count()
    if cards < 2:
        raise RuntimeError(f"chip_study mesh: needs 2 or more cards, found {cards}")
    mesh_ = Mesh.cards(4 if cards >= 4 else 2)
    num = mesh_.size
    print(subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for i in range(cards):
        print(f"peer access from card {i}: " + " ".join(
            "-" if i == j else ("yes" if torch.cuda.can_device_access_peer(i, j) else "no") for j in range(cards)))
    stats: dict = {}
    segments = len(smoke.build_quotient(FibonacciAir(), 3).plan.segments)
    smoke.check_mesh_lde(dev, stats, mesh_)
    smoke.check_mesh_step(dev, stats, segments, mesh_)
    for name, cfg, frozen in (("north star", smoke.NORTH_STAR, smoke.PROOF_2_20),
                              ("blocks route", smoke.BLOCKS_PROVE, smoke.PROOF_2_22)):
        smoke.run_mesh_prove(dev, name, cfg, frozen, mesh_)
        def one(cfg=cfg):
            return smoke.make_config(cfg["num_queries"], cfg["log_blowup"], cfg["pow_bits"], dev)

        def over(cfg=cfg):
            return standard_config(cfg["log_blowup"], cfg["num_queries"], cfg["pow_bits"], mesh=mesh_).pcs

        times: dict = {"one card": [], "mesh": []}
        _prove_once(cfg, one)
        for which, pcs in (("one card", one), ("mesh", over), ("mesh", over), ("one card", one)):
            seconds, got = _prove_once(cfg, pcs)
            if got != frozen:
                raise AssertionError(f"mesh study {name} ({which}): proof {got} differs from the frozen {frozen}")
            times[which].append(seconds)
        print(f"mesh study {name}: prove without verify, s, in turns: one card {times['one card']}, "
              f"{num} cards {times['mesh']}; proofs equal to the frozen", flush=True)
    t0 = time.perf_counter()
    out = dryrun_multichip(num)
    for d in mesh_.devices:
        torch.cuda.synchronize(d)
    print(f"dryrun_multichip({num}): lde {tuple(out[0].shape)}, quotient {tuple(out[1].shape)}, folded "
          f"{tuple(out[2].shape)}, winner {int(out[3])}; {time.perf_counter() - t0:.3f} s (first call)", flush=True)

    rng = np.random.default_rng(47)
    for log_n in MESH_LDE_LOG_NS:
        x = smoke._mont_on(dev, rng, 1 << log_n, 2)
        run_mesh = lambda: distributed_coset_lde(mesh_, x, 2, shift)  # noqa: E731
        run_one = lambda: ntt.coset_lde_batch_auto(x, 2, shift)  # noqa: E731
        smoke.compare("mesh study lde", run_mesh(), run_one(), f"2^{log_n}")
        ms = {"one card": [], "mesh": []}
        for which, fn in (("one card", run_one), ("mesh", run_mesh), ("mesh", run_mesh), ("one card", run_one)):
            ms[which].append(smoke.wall_ms(fn, 10, mesh_.devices))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run_mesh()
            for d in mesh_.devices:
                torch.cuda.synchronize(d)
        items = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                       key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in items)
        collectives.reset_counts()
        run_mesh()
        print(f"mesh study lde 2^{log_n} x 2, blowup 4: wall ms (medians of 10, every card synchronized, in turns): "
              f"one card {ms['one card']}, {num} cards {ms['mesh']}; device time (kernels and copies) of all cards "
              f"summed {busy / 10 / 1e3:.4f} ms a call, largest: " + ", ".join(
                  f"{_kernel_name(e.key)[:60]} {e.self_device_time_total / 10 / 1e3:.4f} ms x{e.count / 10:g}"
                  for e in items[:6]) + f"; exchanges {collectives.counts}", flush=True)
        # each all_to_all of the LDE alone: the inverse's (n points) and the forward's (4n)
        for what, log_size in (("inverse", log_n), ("forward", log_n + 2)):
            log_r, log_c = split(log_size, num)
            blocks = [smoke._mont_on(d, rng, 1 << log_r, (1 << log_c) // num, 2) for d in mesh_.devices]
            sent = blocks[0].numel() * 4 * (num - 1) // num  # bytes a card sends
            a2a = smoke.wall_ms(lambda: collectives.all_to_all(mesh_, blocks, 0), 10, mesh_.devices)
            print(f"mesh study all_to_all ({what} transform of the 2^{log_n} LDE, blocks {tuple(blocks[0].shape)}): "
                  f"{a2a:.4f} ms, a card sends {sent / 2**20:.2f} MiB, bound {1e3 * sent / NVLINK_BYTES_PER_S:.4f} ms "
                  f"(bytes over {NVLINK_BYTES_PER_S / 1e9:g} GB/s)", flush=True)
            del blocks
        del x


PHASES = {  # name: (title, what runs); `python3 chip_study.py [name ...]` runs those
    "kernels": ("kernels at the north star's largest shapes", kernels_full_size),
    "sass": ("SHA-256 kernels' SASS instruction classes", sha_sass),
    "routes": ("coset LDE routes: fused vs blocks", lde_routes),
    "device": ("NTT and limb-matmul kernels' device time at the path shapes (torch.profiler)", device_times),
    "suffix": ("leaf-suffix builder", suffix_builder),
    "busy": ("card busy share (torch.profiler), 2^20 and 2^22 rows",
             lambda dev: [busy_share(dev, f"2^{cfg['log_n']} rows", fib_prove(cfg))
                          for cfg in (smoke.NORTH_STAR, smoke.BLOCKS_PROVE)]),
    "peak": ("the 2^22 prove's peak device memory, by span",
             lambda dev: peak_memory(dev, "2^22 prove", fib_prove(smoke.BLOCKS_PROVE))),
    "wide": ("the wide row's prove: busy share and peak device memory, by span",
             lambda dev: [busy_share(dev, "wide row", prove_wide), peak_memory(dev, "wide row", prove_wide)]),
    "fri_tail": ("fri host tail: one layer on the card vs on the host", fri_tail),
    "quotient": ("the quotient kernels' device time and their plain version's, at each prove's coset", quotient),
    "segments": ("the segment length S: build seconds and device time of the flagship's and wide row's programs",
                 segments),
    "gather": ("the quotient's coset gather: by columns against by rows", gather),
    "spans": ("each prove's spans, warm: 2^20, 2^22, the wide row, the flagship", spans),
    "transcript": ("the FRI transcript step's device time (torch.profiler)", transcript_times),
    "blake3": ("the flagship's prove: busy share and peak device memory, by span; its proof's bytes",
               lambda dev: [busy_share(dev, "blake3 sponge", prove_blake3),
                            peak_memory(dev, "blake3 sponge", prove_blake3)]),
    "mesh": ("the mesh across cards: peer access, the distributed LDE, the sharded step, the proves", mesh),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_study: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    from tapstark_torch import _build

    _build.load_library()
    for name in sys.argv[1:] or [p for p in PHASES if p != "mesh"]:  # mesh needs two cards or more
        title, run = PHASES[name]
        smoke.phase(title)
        run(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
