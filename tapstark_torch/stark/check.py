"""Row-by-row AIR constraint debugging (reference parity:
uni-stark/src/check_constraints.rs; debug tool, exact host scalars)."""

from __future__ import annotations

import numpy as np

from ..air import AirBuilder, TwoRowMatrixView
from ..field.scalar import F


class DebugConstraintBuilder(AirBuilder):
    def __init__(self, row_index, local, next_row, public_values, height):
        self._main = TwoRowMatrixView(local, next_row)
        self._public = public_values
        self._first = F(1 if row_index == 0 else 0)
        self._last = F(1 if row_index == height - 1 else 0)
        self._transition = F(1 if row_index != height - 1 else 0)
        self.row_index = row_index

    def main(self):
        return self._main

    def is_first_row(self):
        return self._first

    def is_last_row(self):
        return self._last

    def is_transition_window(self, size):
        assert size == 2
        return self._transition

    def public_values(self):
        return self._public

    def assert_zero(self, x):
        if isinstance(x, int):
            x = F(x)
        assert x == F(0), f"constraints had nonzero value on row {self.row_index}"

    def assert_eq(self, x, y):
        xv = x if isinstance(x, F) else F(x)
        yv = y if isinstance(y, F) else F(y)
        assert xv == yv, f"values didn't match on row {self.row_index}"


def check_constraints(air, trace: np.ndarray, public_values: list[F]) -> None:
    """trace: (n, width) canonical uint32."""
    height = trace.shape[0]
    for i in range(height):
        i_next = (i + 1) % height
        local = [F(int(v)) for v in trace[i]]
        nxt = [F(int(v)) for v in trace[i_next]]
        builder = DebugConstraintBuilder(i, local, nxt, public_values, height)
        air.eval(builder)
