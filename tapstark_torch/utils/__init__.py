"""Index math helpers (reference parity: p3-util).

reverse_bits_len / log2_strict / bit-reversal permutations are used by the
NTT, FRI fold indexing and the PCS (reference: p3-util, used at e.g.
tap-stark's fri/src/two_adic_pcs.rs:491, fri/src/verifier.rs).
"""

from __future__ import annotations

import functools

import numpy as np


def log2_strict(n: int) -> int:
    """log2 of a power of two; raises otherwise."""
    if n <= 0 or (n & (n - 1)) != 0:
        raise ValueError(f"{n} is not a positive power of two")
    return n.bit_length() - 1


def log2_ceil(n: int) -> int:
    if n <= 0:
        raise ValueError("log2_ceil of non-positive")
    return (n - 1).bit_length()


def reverse_bits_len(x: int, bit_len: int) -> int:
    """Reverse the low `bit_len` bits of x."""
    r = 0
    for _ in range(bit_len):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def reverse_slice_index_bits(values: list) -> list:
    """Return a new list permuted by bit-reversing indices (len power of two)."""
    n = len(values)
    if n <= 1:
        return list(values)
    return [values[int(i)] for i in bitrev_indices(log2_strict(n))]


@functools.lru_cache(maxsize=None)
def bitrev_indices(log_n: int) -> np.ndarray:
    """Bit-reversal permutation indices for size 2**log_n (uint32 numpy)."""
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    r = np.zeros(n, dtype=np.uint32)
    for b in range(log_n):
        r |= ((idx >> b) & 1) << (log_n - 1 - b)
    return r
