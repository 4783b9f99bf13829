"""Fibonacci AIR — the end-to-end golden example
(reference parity: uni-stark/tests/fib_air.rs:21-101)."""

from __future__ import annotations

import numpy as np

from ..air import Air
from ..field.constants import P

NUM_FIBONACCI_COLS = 2


class FibonacciAir(Air):
    def width(self) -> int:
        return NUM_FIBONACCI_COLS

    def eval(self, builder) -> None:
        main = builder.main()
        pis = builder.public_values()
        a, b, x = pis[0], pis[1], pis[2]

        local = main.row(0)
        nxt = main.row(1)

        when_first_row = builder.when_first_row()
        when_first_row.assert_eq(local[0], a)
        when_first_row.assert_eq(local[1], b)

        when_transition = builder.when_transition()
        # a' <- b
        when_transition.assert_eq(local[1], nxt[0])
        # b' <- a + b
        when_transition.assert_eq(local[0] + local[1], nxt[1])

        builder.when_last_row().assert_eq(local[1], x)


def generate_fibonacci_trace(a: int, b: int, n: int) -> np.ndarray:
    """(n, 2) canonical uint32 trace (fib_air.rs:59-78)."""
    assert n > 0 and (n & (n - 1)) == 0
    rows = np.zeros((n, NUM_FIBONACCI_COLS), dtype=np.uint32)
    rows[0] = (a % P, b % P)
    for i in range(1, n):
        rows[i, 0] = rows[i - 1, 1]
        rows[i, 1] = (int(rows[i - 1, 0]) + int(rows[i - 1, 1])) % P
    return rows
