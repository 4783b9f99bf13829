"""WideAir — parameterized wide-table AIR (the BASELINE "recursive
RISC0-style wide table" shape: many columns, degree-2 transition coupling).

Column j transition: next[j] = local[j]^2 + local[(j+1) % width]; the first
row is pinned to public values (one per column)."""

from __future__ import annotations

import numpy as np

from ..air import Air
from ..field.constants import P


class WideAir(Air):
    def __init__(self, width: int = 163):
        self._width = width

    def width(self) -> int:
        return self._width

    def eval(self, builder) -> None:
        main = builder.main()
        pis = builder.public_values()
        local = main.row(0)
        nxt = main.row(1)
        w = self._width

        first = builder.when_first_row()
        for j in range(w):
            first.assert_eq(local[j], pis[j])

        transition = builder.when_transition()
        for j in range(w):
            transition.assert_eq(
                nxt[j], local[j] * local[j] + local[(j + 1) % w]
            )


def generate_wide_trace(width: int, n: int, seed: int = 0):
    """(n, width) canonical trace + the width public first-row values."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, width), dtype=np.uint32)
    rows[0] = rng.integers(0, P, width)
    for r in range(1, n):
        prev = rows[r - 1].astype(np.uint64)
        rows[r] = (prev * prev % P + np.roll(prev, -1)) % P
    return rows, [int(x) for x in rows[0]]
