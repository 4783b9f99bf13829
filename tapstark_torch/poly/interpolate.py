"""Barycentric evaluation of polynomials given on a multiplicative coset
(twin of `tapstark.poly.interpolate`; p3-interpolation `interpolate_coset`,
used by the PCS open).

For evals y_i of p over the coset {s*g^i} and Z(X) = X^n - s^n:
    p(z) = Z(z) / (n * s^n) * sum_i y_i * x_i / (z - x_i)

`interpolate_coset` is plain torch (the reference jits jnp and reaches no
Pallas kernel). XLA fuses the reference's product into its sum; here each
step takes a block of rows, with its own weights, and of columns whose
products fill at most STEP_PRODUCTS extension elements (int64: 128 MiB),
so no temporary grows with the matrix.
"""

from __future__ import annotations

import torch

from ..field.constants import P
from ..field.device import ef_const, ef_inv, ef_mul, ef_mul_base, fp_sub
from ..field.scalar import EF4, F
from ..utils import log2_strict
from .powers import geom_powers_mont_dev

# extension products (rows x columns) a step of `interpolate_coset` makes;
# a power of two
STEP_PRODUCTS = 1 << 22


def _interp_weights(xs_mont: torch.Tensor, z_const: torch.Tensor) -> torch.Tensor:
    """w_i = x_i / (z - x_i) as an (n, 4) Montgomery tensor; z_const (4,)."""
    denom = z_const.expand(xs_mont.shape[0], 4).clone()
    denom[:, 0] = fp_sub(denom[:, 0], xs_mont)
    return ef_mul_base(ef_inv(denom), xs_mont)


def interpolate_coset(mat: torch.Tensor, shift: int, z: EF4) -> torch.Tensor:
    """Evaluate each column of mat ((n, w) base Montgomery, natural order
    over the coset shift·H_n) at the extension point z; (w, 4) Montgomery
    on mat's device."""
    n, w = mat.shape
    log_n = log2_strict(n)
    s = shift % P
    s_pow_n = pow(s, n, P)
    scale = (z.exp(n) - EF4((s_pow_n, 0, 0, 0))) * EF4(((n % P) * s_pow_n % P, 0, 0, 0)).inverse()
    dev = mat.device
    g = F.two_adic_generator(log_n).v
    z_const = ef_const(z, dev)
    rows = min(n, STEP_PRODUCTS)
    cols = max(1, min(w, STEP_PRODUCTS // rows))
    acc = torch.zeros((w, 4), dtype=torch.int64, device=dev)
    for r0 in range(0, n, rows):
        xs = geom_powers_mont_dev(g, log2_strict(rows), s * pow(g, r0, P) % P, dev)
        weights = _interp_weights(xs, z_const)[:, None, :]  # (rows, 1, 4)
        for c0 in range(0, w, cols):
            prod = ef_mul_base(weights, mat[r0 : r0 + rows, c0 : c0 + cols])  # (rows, cols, 4)
            acc[c0 : c0 + cols] += prod.sum(dim=0, dtype=torch.int64)  # terms < 2^31: exact below 2^32 rows
    return ef_mul(torch.remainder(acc, P), ef_const(scale, dev))


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
