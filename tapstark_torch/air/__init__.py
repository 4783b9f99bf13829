"""AIR protocol and builder interfaces (reference parity: p3-air).

An AIR is a class with `width()` and `eval(builder)`. The same eval code runs
against four builders:
  - SymbolicAirBuilder (air.symbolic): records constraints for quotient-degree
    inference;
  - ProverConstraintFolder (air.folders): vectorized device evaluation over
    the quotient coset;
  - VerifierConstraintFolder (air.folders): exact host scalars at zeta;
  - DebugConstraintBuilder (stark.check): row-by-row debugging;
  - ProgramRecorder (air.program): records the constraints once as the
    program that the quotient kernel runs over the coset on the card.
"""

from __future__ import annotations


class AirBuilder:
    """Base interface; concrete builders define main()/selectors/assert_zero."""

    def main(self):
        raise NotImplementedError

    def is_first_row(self):
        raise NotImplementedError

    def is_last_row(self):
        raise NotImplementedError

    def is_transition(self):
        return self.is_transition_window(2)

    def is_transition_window(self, size: int):
        raise NotImplementedError

    def public_values(self):
        raise NotImplementedError

    def assert_zero(self, x):
        raise NotImplementedError

    def assert_eq(self, x, y):
        self.assert_zero(x - y)

    def assert_one(self, x):
        self.assert_zero(x - 1)

    def when(self, condition) -> "FilteredAirBuilder":
        return FilteredAirBuilder(self, condition)

    def when_first_row(self) -> "FilteredAirBuilder":
        return self.when(self.is_first_row())

    def when_last_row(self) -> "FilteredAirBuilder":
        return self.when(self.is_last_row())

    def when_transition(self) -> "FilteredAirBuilder":
        return self.when(self.is_transition())


class FilteredAirBuilder:
    """Constraints asserted under a multiplicative filter (p3-air semantics)."""

    def __init__(self, inner: AirBuilder, condition):
        self.inner = inner
        self.condition = condition

    def assert_zero(self, x):
        self.inner.assert_zero(self.condition * x)

    def assert_eq(self, x, y):
        self.assert_zero(x - y)

    def assert_one(self, x):
        self.assert_zero(x - 1)


class TwoRowMatrixView:
    """main() view exposing the local (offset 0) and next (offset 1) rows."""

    def __init__(self, local, next_row):
        self._rows = (local, next_row)

    def row(self, offset: int):
        return self._rows[offset]


class Air:
    def width(self) -> int:
        raise NotImplementedError

    def eval(self, builder) -> None:
        raise NotImplementedError
