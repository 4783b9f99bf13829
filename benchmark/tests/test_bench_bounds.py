"""The frozen bound arithmetic gives chip_smoke.py's numbers at the shapes
PR 6-8 timed (chip_smoke.py runs in a process of its own: it blocks the
JAX package where it is imported)."""

import json
import subprocess
import sys
from pathlib import Path

from benchmark.yardstick import bounds as b
from benchmark.reference import script as sc

ROOT = Path(__file__).resolve().parents[2]
CASES = {
    "lde_bounds": [(20, 2, 2), (20, 4, 2), (18, 163, 4), (18, 4, 4)],
    "first_bound": [(22, 2, 2), (22, 4, 2)],
    "last_bound": [(22, 2), (22, 4)],
    "cols_bound": [(11, 16384), (11, 32768), (11, 4096), (11, 8192)],
    "leaf_bound": [(28, 1 << 16, 1, 4), (16, 1 << 16, 4, 4), (28, 1 << 16, 2, 4)],
    "levels_bound": [(28, 1 << 16, 4, 4), (16, 1 << 18, 4, 4), (28, 1 << 12, 8, 8)],
}


def test_bounds_equal_chip_smokes():
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs; "
            f"cases = {CASES!r}; "
            "print(json.dumps({k: [getattr(cs, k)(*a) for a in v] for k, v in cases.items()}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, check=True,
                         cwd=ROOT)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = json.loads(json.dumps({k: [getattr(b, k)(*a) for a in v] for k, v in CASES.items()}))
    assert got == want


def test_the_commit_bound_counts_the_leaf_suffix_blocks():
    # the north-star trace shard: 2 base values a leaf, 1 suffix block (tcs.py's example)
    assert sc.suffix_blocks(2, 1) == 1
    ms = b.commit_least_ms(1 << 22, 28, [(2, 1)])
    assert ms == b.sha_bound(28 * (1 << 22), 28 * ((1 << 22) - 1), 4 * (1 << 22) * 2 + 32 * 28)[0]
    assert b.lde_least_ms(20, 2, 2) == sum(t for t, _, _ in b.lde_bounds(20, 2, 2).values())
