"""FRI fold: tensor version, exact host numpy version, and the verifier's
one-row fold (twin of `tapstark.poly.fold`; reference
fri/src/two_adic_pcs.rs:87-147).

Input is a (half, 2, 4) extension matrix in bit-reversed order; output the
folded (half, 4) vector:
    out[i] = (1/2 + beta/2 * g_inv^i) * row[0] + (1/2 - beta/2 * g_inv^i) * row[1]
with the g_inv powers in bit-reversed order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.constants import P
from ..field.device import MONT_HALF, ef_add, ef_mul, ef_mul_base, ef_sub, fp_mul
from ..field.scalar import EF4, F
from ..utils import bitrev_indices, log2_strict, reverse_bits_len
from .powers import bitrev_1d_dev, geom_powers_mont_dev, np_geom_powers


def _g_inv_powers_bitrev(log_half: int, device) -> torch.Tensor:
    """bitrev([g_inv^0 .. g_inv^(half-1)]) Montgomery, g of order 2*half."""
    g_inv = pow(F.two_adic_generator(log_half + 1).v, P - 2, P)
    return bitrev_1d_dev(geom_powers_mont_dev(g_inv, log_half, 1, device), log_half)


def fold_matrix(beta_mont: torch.Tensor, m: torch.Tensor, offset: int = 0, log_half: int | None = None) -> torch.Tensor:
    """Fold a (half, 2, 4) ext matrix with beta ((4,) Montgomery) → (half, 4).
    With `log_half`, m holds rows offset .. offset + half - 1 of a matrix of
    2^log_half rows (a shard's rows: the g_inv powers are those rows')."""
    half = m.shape[0]
    if log_half is None:
        log_half = log2_strict(half)
    if offset < 0 or offset + half > 1 << log_half:
        raise ValueError(f"fold_matrix: rows {offset} .. {offset + half - 1} of 2^{log_half}")
    ginv = _g_inv_powers_bitrev(log_half, m.device)[offset : offset + half]
    half_beta = fp_mul(beta_mont, MONT_HALF)  # (4,)
    power = ef_mul_base(half_beta.expand(half, 4), ginv)  # (half, 4)
    half_vec = torch.zeros((half, 4), dtype=torch.int32, device=m.device)
    half_vec[:, 0] = MONT_HALF
    c_plus = ef_add(half_vec, power)
    c_minus = ef_sub(half_vec, power)
    return ef_add(ef_mul(c_plus, m[:, 0, :]), ef_mul(c_minus, m[:, 1, :]))


def _ef_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact EF4 product of canonical (n, 4) uint64 arrays; each partial
    product is reduced before accumulation."""
    pp = np.uint64(P)
    c = [np.zeros(a.shape[0], dtype=np.uint64) for _ in range(4)]
    for i in range(4):
        for j in range(4):
            prod = (a[:, i] * b[:, j]) % pp
            k = i + j
            if k < 4:
                c[k] += prod
            else:
                c[k - 4] += np.uint64(11) * prod
    return np.stack([x % pp for x in c], axis=1)


def fold_matrix_host(beta: EF4, m: np.ndarray) -> np.ndarray:
    """Exact host twin of fold_matrix on CANONICAL uint32 arrays:
    (half, 2, 4) → (half, 4). The FRI commit phase folds its small tail
    layers with this (fri/prover.py)."""
    half = m.shape[0]
    log_half = log2_strict(half)
    pp = np.uint64(P)
    g_inv = pow(F.two_adic_generator(log_half + 1).v, P - 2, P)
    ginv = np_geom_powers(g_inv, half)[bitrev_indices(log_half)].astype(np.uint64)
    inv2 = np.uint64(pow(2, P - 2, P))
    half_beta = (np.array(beta.c, dtype=np.uint64) * inv2) % pp
    power = (half_beta[None, :] * ginv[:, None]) % pp
    c_plus = power.copy()
    c_plus[:, 0] = (c_plus[:, 0] + inv2) % pp
    c_minus = (pp - power) % pp
    c_minus[:, 0] = (c_minus[:, 0] + inv2) % pp
    e0 = m[:, 0, :].astype(np.uint64)
    e1 = m[:, 1, :].astype(np.uint64)
    out = (_ef_mul_np(c_plus, e0) + _ef_mul_np(c_minus, e1)) % pp
    return out.astype(np.uint32)


def fold_row_scalar(index: int, log_height: int, beta: EF4, e0: EF4, e1: EF4) -> EF4:
    """Exact host fold of one row (verifier path): 2-point interpolation
    evaluated at beta."""
    x0 = F.two_adic_generator(log_height + 1).exp(reverse_bits_len(index, log_height))
    x1 = x0 * F.two_adic_generator(1)
    return e0 + (beta - EF4.from_base(x0)) * (e1 - e0) * EF4.from_base(x1 - x0).inverse()
