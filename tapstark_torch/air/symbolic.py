"""Symbolic constraint recording for quotient-degree inference.

Reference parity: uni-stark/src/symbolic_builder.rs, symbolic_expression.rs,
symbolic_variable.rs. degree_multiple rules: main/preprocessed variables and
is_first/is_last selectors are degree 1; public values, constants and
is_transition are degree 0; add/sub take the max, mul the sum.
"""

from __future__ import annotations

from ..field.scalar import F
from ..utils import log2_ceil
from . import AirBuilder, TwoRowMatrixView


class SymbolicExpression:
    __slots__ = ("degree_multiple",)

    def __init__(self, degree_multiple: int):
        self.degree_multiple = degree_multiple

    def _deg(self, other) -> int:
        if isinstance(other, SymbolicExpression):
            return other.degree_multiple
        return 0  # int / F constants

    def __add__(self, other):
        return SymbolicExpression(max(self.degree_multiple, self._deg(other)))

    __radd__ = __add__
    __sub__ = __add__
    __rsub__ = __add__

    def __mul__(self, other):
        return SymbolicExpression(self.degree_multiple + self._deg(other))

    __rmul__ = __mul__

    def __neg__(self):
        return SymbolicExpression(self.degree_multiple)


class SymbolicVariable(SymbolicExpression):
    __slots__ = ("entry", "offset", "index")

    def __init__(self, entry: str, offset: int, index: int):
        deg = 0 if entry == "public" else 1
        super().__init__(deg)
        self.entry = entry
        self.offset = offset
        self.index = index


class SymbolicAirBuilder(AirBuilder):
    def __init__(self, width: int, num_public_values: int, preprocessed_width: int = 0):
        self._main = TwoRowMatrixView(
            [SymbolicVariable("main", 0, i) for i in range(width)],
            [SymbolicVariable("main", 1, i) for i in range(width)],
        )
        self._public = [
            SymbolicVariable("public", 0, i) for i in range(num_public_values)
        ]
        self.constraints: list[SymbolicExpression] = []

    def main(self):
        return self._main

    def is_first_row(self):
        return SymbolicExpression(1)

    def is_last_row(self):
        return SymbolicExpression(1)

    def is_transition_window(self, size: int):
        assert size == 2, "uni-stark only supports a window size of 2"
        return SymbolicExpression(0)

    def public_values(self):
        return self._public

    def assert_zero(self, x):
        if not isinstance(x, SymbolicExpression):
            x = SymbolicExpression(0)
        self.constraints.append(x)


def get_max_constraint_degree(air, num_public_values: int) -> int:
    builder = SymbolicAirBuilder(air.width(), num_public_values)
    air.eval(builder)
    return max((c.degree_multiple for c in builder.constraints), default=0)


def get_log_quotient_degree(air, num_public_values: int) -> int:
    """ceil(log2(max_constraint_degree - 1)), padded to degree >= 2
    (symbolic_builder.rs:15-32)."""
    constraint_degree = max(get_max_constraint_degree(air, num_public_values), 2)
    return log2_ceil(constraint_degree - 1)
