"""Constraint folders (twin of `tapstark.air.folders`; reference
uni-stark/src/folder.rs). Both accumulate `acc = acc * alpha + constraint`
per assert_zero: the prover over the whole quotient coset at once
((m,) / (m, 4) Montgomery tensors), the verifier over EF4 scalars at zeta.
"""

from __future__ import annotations

import torch

from ..air import AirBuilder, TwoRowMatrixView
from ..field.scalar import EF4, F
from ..field.device import (
    ef_add,
    ef_const,
    ef_from_base,
    ef_mul,
    ef_mul_base,
    ef_neg,
    ef_sub,
    fp_add,
    fp_const,
    fp_mul,
    fp_neg,
    fp_sub,
)


class DExpr:
    """Tensor field expression: an (m,) base or (m, 4) extension Montgomery
    tensor, or a constant (0-d base or (4,) extension tensor on the same
    device). Overloads the field ops AIR eval code uses."""

    __slots__ = ("arr", "ext")

    def __init__(self, arr: torch.Tensor, ext: bool):
        self.arr = arr
        self.ext = ext

    @staticmethod
    def const(v, device) -> "DExpr":
        if isinstance(v, int):
            v = F(v)
        if isinstance(v, F):
            return DExpr(torch.tensor(fp_const(v.v), dtype=torch.int32, device=device), False)
        if isinstance(v, EF4):
            return DExpr(ef_const(v, device), True)
        raise TypeError(type(v))

    def _coerce(self, other) -> "DExpr":
        if isinstance(other, DExpr):
            return other
        return DExpr.const(other, self.arr.device)

    def _promote(self, other: "DExpr"):
        a, b = self, other
        if a.ext == b.ext:
            return a.arr, b.arr, a.ext
        if a.ext:
            return a.arr, ef_from_base(b.arr), True
        return ef_from_base(a.arr), b.arr, True

    def __add__(self, other):
        a, b, ext = self._promote(self._coerce(other))
        return DExpr(ef_add(a, b) if ext else fp_add(a, b), ext)

    __radd__ = __add__

    def __sub__(self, other):
        a, b, ext = self._promote(self._coerce(other))
        return DExpr(ef_sub(a, b) if ext else fp_sub(a, b), ext)

    def __rsub__(self, other):
        return self._coerce(other).__sub__(self)

    def __mul__(self, other):
        other = self._coerce(other)
        if self.ext and not other.ext:
            return DExpr(ef_mul_base(self.arr, other.arr), True)
        if other.ext and not self.ext:
            return DExpr(ef_mul_base(other.arr, self.arr), True)
        if self.ext:
            return DExpr(ef_mul(self.arr, other.arr), True)
        return DExpr(fp_mul(self.arr, other.arr), False)

    __rmul__ = __mul__

    def __neg__(self):
        return DExpr(ef_neg(self.arr) if self.ext else fp_neg(self.arr), self.ext)


class ProverConstraintFolder(AirBuilder):
    """Evaluates every row of the quotient coset at once. The next row is
    the trace rolled by -next_step (the coset point times the trace-domain
    generator), matching vertically_packed_row(i + next_step) (prover.rs)."""

    def __init__(
        self,
        trace_on_quotient_domain: torch.Tensor,  # (m, width) natural order
        next_step: int,
        public_values: list[F],
        sels,  # LagrangeSelectors of (m,) tensors
        alpha: EF4,
    ):
        m, width = trace_on_quotient_domain.shape
        dev = trace_on_quotient_domain.device
        nxt = torch.roll(trace_on_quotient_domain, -next_step, dims=0)
        self._main = TwoRowMatrixView(
            [DExpr(trace_on_quotient_domain[:, j], False) for j in range(width)],
            [DExpr(nxt[:, j], False) for j in range(width)],
        )
        self._public = public_values
        self._sels = sels
        self._alpha = DExpr.const(alpha, dev)
        self.accumulator = DExpr(torch.zeros((m, 4), dtype=torch.int32, device=dev), True)

    def main(self):
        return self._main

    def is_first_row(self):
        return DExpr(self._sels.is_first_row, False)

    def is_last_row(self):
        return DExpr(self._sels.is_last_row, False)

    def is_transition_window(self, size: int):
        if size != 2:
            raise ValueError("uni-stark only supports a window size of 2")
        return DExpr(self._sels.is_transition, False)

    def public_values(self):
        return self._public

    def assert_zero(self, x):
        self.accumulator = self.accumulator * self._alpha + x


class VerifierConstraintFolder(AirBuilder):
    """Exact host evaluation at zeta (EF4 scalars)."""

    def __init__(self, trace_local, trace_next, public_values, sels, alpha: EF4):
        self._main = TwoRowMatrixView(trace_local, trace_next)
        self._public = public_values
        self._sels = sels
        self._alpha = alpha
        self.accumulator = EF4.zero()

    def main(self):
        return self._main

    def is_first_row(self):
        return self._sels.is_first_row

    def is_last_row(self):
        return self._sels.is_last_row

    def is_transition_window(self, size: int):
        if size != 2:
            raise ValueError("uni-stark only supports a window size of 2")
        return self._sels.is_transition

    def public_values(self):
        return self._public

    def assert_zero(self, x):
        if isinstance(x, int):
            x = EF4((x, 0, 0, 0))
        if isinstance(x, F):
            x = EF4.from_base(x)
        self.accumulator = self.accumulator * self._alpha + x
