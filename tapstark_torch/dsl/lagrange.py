"""Lagrange selector expressions at a point
(reference parity: script_expr/src/lagrange.rs — is_first/is_last enter the
script as precomputed hint constants, is_transition as an expression)."""

from __future__ import annotations

from dataclasses import dataclass

from ..field.scalar import EF4, F
from .expr import Expr


@dataclass
class LagrangeSelectorsExpr:
    is_first_row: Expr
    is_last_row: Expr
    is_transition: Expr
    z_h: Expr


def selectors_at_point_expr(shift: F, point: EF4, log_n: int) -> LagrangeSelectorsExpr:
    unshifted = point * EF4.from_base(shift.inverse())
    unshifted_expr = (
        Expr.constant(unshifted)
        if shift == F.one()
        else Expr.constant(point) * Expr.constant(shift.inverse())
    )
    z_h = unshifted.exp_power_of_2(log_n) - EF4.one()
    sub_last = F.two_adic_generator(log_n).inverse()
    return LagrangeSelectorsExpr(
        is_first_row=Expr.constant(z_h * (unshifted - EF4.one()).inverse()),  # hint
        is_last_row=Expr.constant(
            z_h * (unshifted - EF4.from_base(sub_last)).inverse()
        ),  # hint
        is_transition=unshifted_expr - Expr.constant(sub_last),
        z_h=unshifted_expr.exp_const(1 << log_n) - Expr.constant(EF4.one()),
    )
