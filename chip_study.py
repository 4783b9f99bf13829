"""Longer measurements of the PyTorch/CUDA port on one GPU.

    python3 chip_study.py

`chip_smoke.py` checks the port; this script measures what it leaves
out, for PERF.md:

- the SHA-256 kernels alone at the north star's largest shapes;
- the two coset-LDE routes at 2^22 and 2^23 rows: the fused halves (K1/K2's
  counterparts) against the four-step blocks route (K3/K4's);
- the leaf-suffix builder (plain torch, no kernel of its own) on one
  north-star trace-commit shard;
- one north-star prove under `torch.profiler`: the card's busy share and
  its largest items;
- one FRI layer (fold and commit) on the card and on the host at the sizes
  around the host-tail switch (`fri/prover.py HOST_TAIL_MAX_HALF`).

It builds the kernels from the checkout as `chip_smoke.py` does, and
like it loads neither JAX nor the JAX package. Without a CUDA device it
exits at once.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import chip_smoke as smoke  # blocks jax and tapstark before torch loads
import numpy as np  # noqa: E402
import torch  # noqa: E402

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


def kernels_full_size(dev) -> None:
    """The kernels alone, median of 10: `sha256_compress` in the leaf form
    for the trace commit (28 repetitions x 2^22 leaves, 1 suffix block) and
    the first FRI layer on the card (28 x 2^21, 2 blocks); `tapbranch` on the
    trace commit's first tree level (28 x 2^21 nodes, strided children)."""
    from tapstark_torch.hashes import sha256_device as sd

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def words(*shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device=dev, generator=gen)

    r = 28
    for n, nb in ((1 << 22, 1), (1 << 21, 2)):
        mids, suffix, rem = words(8, r), words(16 * nb, n), words(16 * nb, r)
        ms = smoke.median_ms(lambda: sd.compress_wm(mids, suffix, rem), 10)
        b = smoke.leaf_bound(r, n, nb)
        print(f"sha256_compress leaf form R={r} N={n} nb={nb}: {ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]})")
        del mids, suffix, rem
    level = words(8, r << 22).view(8, -1, 2)
    m = r << 21
    ms = smoke.median_ms(lambda: sd.tapbranch_wm(level[:, :, 0], level[:, :, 1]), 10)
    b = smoke.tree_level_bound(m)
    print(f"tapbranch tree level M={m}: {ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]})")


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


def busy_share(dev) -> None:
    """One north-star prove under torch.profiler (after an unprofiled one):
    the card's summed device self time over the prove's wall time, and the
    largest items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, _, t_prove, _ = smoke.prove_fibonacci(device=dev, **smoke.NORTH_STAR)
    print(f"unprofiled prove {t_prove:.3f} s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, t_prove, _ = smoke.prove_fibonacci(device=dev, **smoke.NORTH_STAR)
    # the card's own events (kernels, copies); an aten op's entry repeats
    # the device time of the kernels it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"profiled prove {t_prove:.3f} s: card busy {busy:.3f} s ({100 * busy / t_prove:.1f} %)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6} {e.key[:90]}")


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
    smoke.phase("kernels at the north star's largest shapes")
    kernels_full_size(dev)
    smoke.phase("coset LDE routes: fused vs blocks")
    lde_routes(dev)
    smoke.phase("leaf-suffix builder")
    suffix_builder(dev)
    smoke.phase("card busy share (torch.profiler)")
    busy_share(dev)
    smoke.phase("fri host tail: one layer on the card vs on the host")
    fri_tail(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
