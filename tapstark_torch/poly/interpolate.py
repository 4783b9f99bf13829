"""Barycentric evaluation of polynomials given on a multiplicative coset
(twin of `tapstark.poly.interpolate`; p3-interpolation `interpolate_coset`,
used by the PCS open).

For evals y_i of p over the coset {s*g^i} and Z(X) = X^n - s^n:
    p(z) = Z(z) / (n * s^n) * sum_i y_i * x_i / (z - x_i)
"""

from __future__ import annotations

import torch

from ..field.device import ef_inv, ef_mul_base, fp_sub
from ..field.scalar import EF4, F
from ..utils import log2_strict


def _interp_weights(xs_mont: torch.Tensor, z_const: torch.Tensor) -> torch.Tensor:
    """w_i = x_i / (z - x_i) as an (n, 4) Montgomery tensor; z_const (4,)."""
    denom = z_const.expand(xs_mont.shape[0], 4).clone()
    denom[:, 0] = fp_sub(denom[:, 0], xs_mont)
    return ef_mul_base(ef_inv(denom), xs_mont)


def interpolate_coset_host(rows: list[list[F]], shift: int, z: EF4) -> list[EF4]:
    """Exact host reference (tests, tiny inputs)."""
    n = len(rows)
    w = len(rows[0]) if rows else 0
    s = F(shift)
    g = F.two_adic_generator(log2_strict(n))
    s_pow_n = s.exp(n)
    scale = (z.exp(n) - EF4.from_base(s_pow_n)) * EF4.from_base(F(n) * s_pow_n).inverse()
    out = [EF4.zero() for _ in range(w)]
    x = s
    for i in range(n):
        wi = EF4.from_base(x) * (z - EF4.from_base(x)).inverse()
        for j in range(w):
            out[j] = out[j] + wi * rows[i][j]
        x = x * g
    return [scale * o for o in out]
