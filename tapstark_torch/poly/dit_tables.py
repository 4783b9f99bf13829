"""Host-built tables of the column kernels (`tapstark_torch/csrc/dit_cols.cuh`
and its DIF twin `dif_cols.cuh`), exact numpy, with their device copies
cached per device.

- `dit_stage_pairs`: the stage twiddles of a DIT over 2^log_r rows, stage
  after stage, each with its Shoup companion. Stage s of a DIF multiplies
  by the same powers of the order-2^s root, so the DIF kernels take the
  same table.
- `first_member_tables`: what the first member of a forward coset LDE
  multiplies by. With n = R·C, input position p = p2·R + p1 in bitrev_n
  order and block rb's base b = shift·w_N^rb (N = blow·n), the block scale
  b^brv_n(p) is s1[rb, p1]·s2[rb, p2], since brv_n(p) = brv_R(p1)·C +
  brv_C(p2); s1 is applied on load (Shoup pairs), s2 on store with the
  outer twiddle (Montgomery words; it may carry 1/n). The outer twiddle
  w_n^e of e = k1·brv_C(p2) mod n is hi[e >> h]·lo[e mod 2^h].
- `last_member_tables`: what the last member of an inverse transform
  multiplies by on load: the outer twiddle w_n^-e of e = brv_R(p1)·i2 mod
  n, hi[e >> h]·lo[e mod 2^h] from the halves of the inverse root's
  powers, and c0 (1/n or 1) once a group.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field.constants import P, two_adic_generator
from ..field.device import fp_const, np_to_mont
from ..utils import bitrev_indices
from .powers import np_geom_powers


def shoup_pairs(canon: np.ndarray) -> np.ndarray:
    """(..., 2) uint32: each canonical value beside its Shoup companion
    floor(w·2^32 / p)."""
    c = canon.astype(np.uint64)
    return np.stack([c, (c << np.uint64(32)) // np.uint64(P)], axis=-1).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def dit_stage_pairs(log_r: int, inverse: bool) -> np.ndarray:
    """(R - 1, 2) uint32: stage s (1 ≤ s ≤ log_r) at rows 2^(s-1) - 1 ..
    2^s - 2, the first 2^(s-1) powers of the order-2^s root (or of its
    inverse) with their Shoup companions."""
    out = np.zeros(((1 << log_r) - 1, 2), dtype=np.uint32)
    for s in range(1, log_r + 1):
        g = two_adic_generator(s)
        if inverse:
            g = pow(g, P - 2, P)
        out[(1 << (s - 1)) - 1 : (1 << s) - 1] = shoup_pairs(np_geom_powers(g, 1 << (s - 1)))
    return out


@functools.lru_cache(maxsize=None)
def first_member_tables(log_r: int, log_c: int, log_blowup: int, shift: int, n_inv: bool) -> dict:
    """{"s1": (blow, R, 2) Shoup pairs; "s2": (blow, C), "hi", "lo":
    Montgomery words; "h": log2 of lo's length}, as the module docstring
    sets out; s2 times 1/n when n_inv."""
    log_n = log_r + log_c
    r, c, blow = 1 << log_r, 1 << log_c, 1 << log_blowup
    w_big = two_adic_generator(log_n + log_blowup)
    c0 = pow(1 << log_n, P - 2, P) if n_inv else 1
    s1 = np.empty((blow, r), dtype=np.uint32)
    s2 = np.empty((blow, c), dtype=np.uint32)
    for rb in range(blow):
        base = shift * pow(w_big, rb, P) % P
        s1[rb] = np_geom_powers(pow(base, c, P), r)[bitrev_indices(log_r)]
        s2[rb] = np_geom_powers(base, c, c0)[bitrev_indices(log_c)]
    return {"s1": shoup_pairs(s1), "s2": np_to_mont(s2), **_root_halves(log_n, two_adic_generator(log_n))}


@functools.lru_cache(maxsize=None)
def last_member_tables(log_r: int, log_c: int, n_inv: bool) -> dict:
    """{"hi", "lo": Montgomery words; "h": log2 of lo's length; "c0": the
    Montgomery word of 1/n if n_inv, else of 1}, as the module docstring
    sets out."""
    log_n = log_r + log_c
    w_inv = pow(two_adic_generator(log_n), P - 2, P)
    return {**_root_halves(log_n, w_inv), "c0": fp_const(pow(1 << log_n, P - 2, P) if n_inv else 1)}


def _root_halves(log_n: int, root: int) -> dict:
    """root^e = hi[e >> h]·lo[e mod 2^h] for e < n = 2^log_n: two
    Montgomery tables of about sqrt(n) entries."""
    h = (log_n + 1) // 2
    return {
        "hi": np_to_mont(np_geom_powers(pow(root, 1 << h, P), 1 << (log_n - h))),
        "lo": np_to_mont(np_geom_powers(root, 1 << h)),
        "h": h,
    }


def _dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def dit_stage_pairs_dev(log_r: int, inverse: bool, device) -> torch.Tensor:
    return _dev(dit_stage_pairs(log_r, inverse), device)


@functools.lru_cache(maxsize=None)
def first_member_tables_dev(log_r: int, log_c: int, log_blowup: int, shift: int, n_inv: bool, device) -> dict:
    t = first_member_tables(log_r, log_c, log_blowup, shift, n_inv)
    return {k: v if k == "h" else _dev(v, device) for k, v in t.items()}


@functools.lru_cache(maxsize=None)
def last_member_tables_dev(log_r: int, log_c: int, n_inv: bool, device) -> dict:
    t = last_member_tables(log_r, log_c, n_inv)
    return {k: v if k in ("h", "c0") else _dev(v, device) for k, v in t.items()}
