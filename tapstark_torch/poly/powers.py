"""Modular power tables: exact host numpy, and their device-built twins
(twin of `tapstark.poly.powers`)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field.constants import P
from ..field.device import fp_const, fp_mul


def np_geom_powers(g: int, n: int, shift: int = 1) -> np.ndarray:
    """[shift, shift*g, ..., shift*g^(n-1)] mod P as canonical uint32,
    by vectorized square-and-multiply over the index bits."""
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    idx = np.arange(n, dtype=np.uint64)
    acc = np.full(n, shift % P, dtype=np.uint64)
    gp = g % P
    for b in range(max(1, int(n - 1).bit_length())):
        mask = (idx >> np.uint64(b)) & np.uint64(1)
        acc = (acc * np.where(mask == 1, np.uint64(gp), np.uint64(1))) % np.uint64(P)
        gp = gp * gp % P
    return acc.astype(np.uint32)


def geom_powers_mont_dev(base: int, log_n: int, shift: int, device) -> torch.Tensor:
    """(2^log_n,) Montgomery int32 [shift * base^i] built on `device` in
    log_n doubling steps: p_{k+1} = [p_k, p_k * base^(2^k)]."""
    p = torch.tensor([fp_const(shift)], dtype=torch.int32, device=device)
    step = base % P
    for _ in range(log_n):
        p = torch.cat([p, fp_mul(p, fp_const(step))])
        step = step * step % P
    return p


@functools.lru_cache(maxsize=None)
def bitrev_indices_dev(log_n: int, device) -> torch.Tensor:
    """Bit-reversal permutation of size 2^log_n as an int64 index tensor,
    built on `device` (cached per device)."""
    idx = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def bitrev_1d_dev(x: torch.Tensor, log_n: int) -> torch.Tensor:
    return x.index_select(0, bitrev_indices_dev(log_n, x.device))
