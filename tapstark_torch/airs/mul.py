"""MulAir — a degree-3 AIR exercising multi-chunk quotient decomposition.

(The reference's uni-stark/tests/mul_air.rs is entirely commented out; this
provides working coverage for quotient_degree > 1.)

Columns: [a, b]. Constraints:
  first row:   a = pis[0], b = pis[1]
  transition:  next.b = b          (degree 2 with the selector)
               next.a = a * a * b  (degree 3 -> log_quotient_degree = 1)
  last row:    a = pis[2]
"""

from __future__ import annotations

import numpy as np

from ..air import Air
from ..field.constants import P


class MulAir(Air):
    def width(self) -> int:
        return 2

    def eval(self, builder) -> None:
        main = builder.main()
        pis = builder.public_values()
        local = main.row(0)
        nxt = main.row(1)

        first = builder.when_first_row()
        first.assert_eq(local[0], pis[0])
        first.assert_eq(local[1], pis[1])

        transition = builder.when_transition()
        transition.assert_eq(nxt[1], local[1])
        transition.assert_eq(nxt[0], local[0] * local[0] * local[1])

        builder.when_last_row().assert_eq(local[0], pis[2])


def generate_mul_trace(a0: int, b: int, n: int) -> np.ndarray:
    assert n > 0 and (n & (n - 1)) == 0
    rows = np.zeros((n, 2), dtype=np.uint32)
    a = a0 % P
    for i in range(n):
        rows[i] = (a, b % P)
        a = a * a % P * (b % P) % P
    return rows
