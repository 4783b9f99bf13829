"""The benchmark of tapstark_torch, the PyTorch and CUDA port: one run of
one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for (it exits non-zero without them, and measures nothing on the
CPU). The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` `breakdown`, and last `checks`: each number the reference's
comparison counted, with its limit, as the last lines of standard error
also give them.

A run: set-up (imports, the port's kernels loaded from its build
directory `tapstark_torch/_build/`, built there on a checkout's first run;
the cell's PCS as `standard_config` builds it; the cell's distinct
statements made from the seed; the traffic's warm-up proves); then for
`--seconds` a closed loop of `tapstark_torch.stark.prove` calls, one
statement after another, each ending in `proof_to_bytes`; then the plain
reference (`benchmark/reference/`, which imports nothing of the port)
works out again one proof drawn from the seed and compares every part of
its bytes.

Layout of `benchmark/`, each file found by the name BENCHMARK.json gives:
    configs/<config>.json    proving parameters, the AIR's name, the source
    traffic/<traffic>.json   the closed loop: warm-up proves, queue size
    inputs/<air>.py          the statements of an AIR, the program's AIR object
    reference/airs/<air>.py  the AIR's constraints for the reference
    metrics/<metric>.py      a per-layer metric's reader
    yardstick/               the bound arithmetic and peaks, the trace reduction
    reference/               the plain reference and the proof format
    tests/                   CPU tests of all of the above
To add a cell: add its entry to BENCHMARK.json's "workloads", and, where
new, a configuration file (and entry), a traffic file, an AIR's inputs and
reference constraints, a metric's reader. No file already there changes.
"""

import os
import sys
import time

T_START = time.perf_counter()
# neither JAX nor the JAX package may load in a run
for _name in ("jax", "jaxlib", "flax", "tapstark"):
    sys.modules[_name] = None
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from benchmark import harness

    harness.set_cache_dirs()
    sys.exit(harness.main(sys.argv[1:], T_START))
