"""One run of one cell: set-up, a measured window of back-to-back proves,
the reference's check of a proof drawn from the seed, and the result line.

Everything a cell needs is found by name under `benchmark/`:
- the cell (`BENCHMARK.json` "workloads") names a configuration and a
  traffic mix;
- the configuration's file (its "file" in "configs") holds the proving
  parameters and the AIR's name; `inputs/<air>.py` makes its statements
  and names the program's AIR, `reference/airs/<air>.py` holds its
  constraints for the reference;
- the traffic mix is `traffic/<name>.json`: a closed loop of `warmup`
  set-up proves, then a queue of `queue_per_second * seconds` distinct
  statements proved one after another;
- a per-layer metric is `metrics/<name>.py`, whose `read(ctx)` returns a
  number, or None where the run holds nothing to read.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BLOCKED = ("jax", "jaxlib", "flax", "tapstark")
RANGES = ("bench/lde", "bench/commit")


def loaded_blocked() -> list[str]:
    """Modules of JAX or the JAX package in this process, by whole
    top-level name (a None entry only blocks the import)."""
    return sorted(n for n, m in list(sys.modules.items()) if m is not None and n.split(".")[0] in BLOCKED)


def spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"benchmark: no {what} named {name!r} in BENCHMARK.json")


def load_cell(name: str, bench: dict | None = None) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of a workload, by name."""
    bench = bench or spec()
    cell = find(bench["workloads"], name, "workload")
    entry = find(bench["configs"], cell["config"], "configuration")
    with open(ROOT / entry["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise SystemExit(f"benchmark: traffic {cell['traffic']!r}: only a closed loop of one client is run")
    return cell, config, traffic


def load_metric(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


class Context:
    """What a per-layer metric's reader reads."""

    def __init__(self, proofs: int, spans: dict, trace, calls: dict):
        self.proofs = proofs
        self.spans = spans
        self.trace = trace
        self.calls = calls

    def span_s_per_proof(self, *names: str):
        if not self.proofs or not any(n in self.spans for n in names):
            return None
        return sum(self.spans.get(n, {}).get("total_s", 0.0) for n in names) / self.proofs

    def range_kernel_s(self, name: str):
        return None if self.trace is None else self.trace.range_kernel_s.get(name)


class Instruments:
    """The benchmark's own ranges around the layers it reads, and the calls
    it counts there, installed once, for a traced run, before the port's
    modules are imported (`span` is bound where each module imports it)."""

    _installed = None

    @classmethod
    def get(cls) -> "Instruments":
        if cls._installed is None:
            cls._installed = cls()
        return cls._installed

    def __init__(self):
        self.calls = {"lde": [], "commit": []}
        from tapstark_torch.utils import profiling

        original = profiling.span

        @contextlib.contextmanager
        def span(name, device=None):
            if not profiling.enabled():
                yield
                return
            with torch.profiler.record_function(name), original(name, device):
                yield

        profiling.span = span
        from tapstark_torch.commit.tcs import TCS
        from tapstark_torch.fri.pcs import TwoAdicFriPcs

        lde, commit = TwoAdicFriPcs._lde, TCS._commit_device
        calls = self.calls

        def _lde(pcs, evals, shift):
            calls["lde"].append((int(evals.shape[0]).bit_length() - 1, int(evals.shape[1]), pcs.fri.log_blowup))
            with torch.profiler.record_function("bench/lde"):
                return lde(pcs, evals, shift)

        def _commit_device(tcs, matrices, assignments, bounds, defer=False):
            limbs = 4 if matrices[0].ext else 1
            leaves = max(m.height for m in matrices)
            calls["commit"].append((leaves, len(assignments), [(hi - lo, limbs) for lo, hi in bounds]))
            with torch.profiler.record_function("bench/commit"):
                return commit(tcs, matrices, assignments, bounds, defer)

        TwoAdicFriPcs._lde = _lde
        TCS._commit_device = _commit_device

    def reset(self):
        for v in self.calls.values():
            v.clear()


def card_info(device) -> dict:
    """The card's name, SM clock and power limit, as nvidia-smi reads them."""
    if device.type != "cuda":
        return {}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    keys = ("name", "sm_clock", "sm_clock_max", "power_limit")
    return dict(zip(keys, (v.strip() for v in out.strip().split(","))))


def run(cell_name: str, cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, bench: dict | None = None, t_start: float | None = None, control: str | None = None) -> dict:
    """One run; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    inst = Instruments.get() if trace else None
    from tapstark_torch.field import F
    from tapstark_torch.stark import prove
    from tapstark_torch.stark.config import standard_config
    from tapstark_torch.stark.serde import proof_to_bytes
    from tapstark_torch.utils import profiling

    from .reference import stark as ref

    phases = {"imports": time.perf_counter() - t_start}
    inputs = importlib.import_module(f"benchmark.inputs.{config['air']}")
    num_queries = config["num_queries"] - (1 if control == "queries-1" else 0)
    cfg = standard_config(log_blowup=config["log_blowup"], num_queries=num_queries,
                          proof_of_work_bits=config["proof_of_work_bits"], device=device,
                          log_final_poly_len=config.get("log_final_poly_len", 0))
    air = inputs.port_air()
    warmup = int(traffic["warmup"])
    queue = warmup + math.ceil(traffic["queue_per_second"] * seconds)
    rng = np.random.default_rng(seed % (1 << 64))
    t = time.perf_counter()
    pool = inputs.statements(config["log_n"], queue, rng, device)
    phases["statements"] = time.perf_counter() - t

    def prove_one(trace_np, pis):
        return proof_to_bytes(prove(cfg.pcs, air, cfg.challenger(), trace_np, [F(v) for v in pis]))

    warmup_failed = 0
    for k, (trace_np, pis) in enumerate(pool[:warmup]):
        t = time.perf_counter()
        try:
            prove_one(trace_np, pis)
        except Exception:  # counted below: the run's proofs are then not correct
            traceback.print_exc()
            warmup_failed += 1
        phases[f"warmup_{k}"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()

    prof = None
    if trace:
        inst.reset()
        profiling.reset()
        profiling.enable(True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    done = []  # (pool index, proof bytes)
    failed_proves = 0
    each = []  # seconds of each completed prove
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with torch.profiler.record_function("bench/window") if trace else contextlib.nullcontext():
        for i in range(warmup, queue):
            if time.perf_counter() - t0 >= seconds:
                break
            with torch.profiler.record_function("bench/prove") if trace else contextlib.nullcontext():
                try:
                    t = time.perf_counter()
                    done.append((i, prove_one(*pool[i])))
                    each.append(time.perf_counter() - t)
                except Exception:  # an answer that never comes counts as failed, the run goes on
                    traceback.print_exc()
                    failed_proves += 1
    window_s = time.perf_counter() - t0
    if len(done) + failed_proves == queue - warmup:
        print(f"benchmark: the queue of {queue - warmup} statements ran out after {window_s:.3f} s",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    summary, spans = None, {}
    if trace:
        profiling.enable(False)
        spans = profiling.report()
        prof.__exit__(None, None, None)
        from .yardstick.trace import summarize

        out_dir = BENCH / ".out"
        out_dir.mkdir(exist_ok=True)
        path = out_dir / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        try:
            summary = summarize(str(path), RANGES)
        finally:
            path.unlink()

    blocked = loaded_blocked()
    if blocked:
        raise SystemExit(f"benchmark: loaded in this process: {', '.join(blocked)}")

    # the reference's check, once the program's state is gone
    del cfg
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    pick = random.Random(seed).randrange(len(done)) if done else None
    checks = {"proofs_checked": (0, 1), "proofs_failed": (warmup_failed + failed_proves, 0)}
    failed = failed_proves
    t_ref = time.perf_counter()
    if pick is not None:
        i, data = done[pick]
        trace_np, pis = pool[i]
        # the i proves before this one (warm-up included) advanced the bit-commitment counters
        result = ref.check(ref.Setting.from_config(config), trace_np, pis, data, prior_proves=i,
                           sample_seed=seed + i, device=device)
        failed += int(any(v for v in result.values()))
        checks |= {"proofs_checked": (1, 1)} | {k: (v, 0) for k, v in result.items()}
    ref_s = time.perf_counter() - t_ref
    correct = checks["proofs_checked"][0] == 1 and all(v <= lim for k, (v, lim) in checks.items()
                                                        if k != "proofs_checked")
    proofs = len(done)
    bench = bench or {"end_to_end": [], "per_layer": []}
    metrics = {}
    if not trace:
        values = {"prove_s": window_s / proofs if proofs else None, "peak_mem_gib": peak / 2**30,
                  "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if cell_name in m.get("workloads", [cell_name]) and values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = Context(proofs, spans, summary, inst.calls)
        for m in bench["per_layer"]:
            if cell_name not in m.get("workloads", [cell_name]):
                continue
            v = load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell.get("chips", 1)), "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": proofs + failed_proves, "failed": failed, "metrics": metrics,
            "device": dev}
    if trace:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        line["breakdown"] = summary.breakdown()
        line["card"] = card_info(device)
    line["run"] = {"window_s": window_s, "setup_s": setup_s, "setup_phases": phases, "prove_s_each": each,
                   "reference_s": ref_s, "checked_job": pick}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return line


def main(argv: list[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("queries-1",), default=None,
                    help="run the control in the program's place (not a benchmark run)")
    args = ap.parse_args(argv)
    bench = spec()
    cell, config, traffic = load_cell(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell.get("chips", 1)):
        print(f"benchmark: {args.workload} needs {cell.get('chips', 1)} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = run(args.workload, cell, config, traffic, args.seed, args.seconds, bool(args.trace),
               torch.device("cuda", 0), bench, t_start, args.control)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = BENCH / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
