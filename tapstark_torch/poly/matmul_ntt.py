"""The exact limb-matmul NTT (twin of `tapstark/poly/matmul_ntt.py`).

A member transform of size R ≤ 128 is a dense (R, R) DFT-matrix product,
done exactly in int8: canonical values split into five 7-bit limbs, the
25 limb products summed into 9 int32 buckets by shift (each below
R·127²·5 < 2^31), the buckets recombined as Σ_s S_s·2^(7s) mod p.

- `mod_matmul` replaces `_fused_kernel` / `_fused_kernel_tw` (K7, via
  `mod_matmul_fused`): for a CUDA tensor it runs the int8 tensor-core
  kernel of `tapstark_torch/csrc/matmul_ntt.cu`, with the optional
  outer-twiddle multiply in its epilogue; for a CPU tensor its plain
  version, whose limb dots run in float64 (exact: the sums stay below
  2^31 ≪ 2^53); any other device raises.
- `ntt_matmul` is the mixed-radix recursion (radix 2^7) and
  `coset_lde_batch_matmul` the block-decomposed LDE on top of it. On every
  device the outer twiddle rides in `mod_matmul`'s epilogue, as the
  reference's TPU branch does, so the CPU runs the card's route.

All NTT math here is in canonical form; Montgomery conversion happens
only at the LDE's entry and exit. No prove calls this route: like the JAX
package's, it stands beside the butterfly routes as an exact alternative.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field.constants import P, R2_MOD_P, R_MOD_P, two_adic_generator
from ..field.device import fp_add, fp_mul
from ..utils import log2_strict
from .cuda_ntt import _check_cuda, _raise_on, _stream_ptr
from .powers import np_geom_powers

LIMB_BITS = 7
NUM_LIMBS = 5  # covers < 2^35; values are < 2^31
LOG_RADIX = 7  # member size of the recursion, and the largest exact R

# Launches of the kernel since the last reset (one per wrapper call that
# reached the card).
launches = {"mod_matmul": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def w_matrix_limbs(log_r: int, inverse: bool) -> np.ndarray:
    """(NUM_LIMBS, R, R) int8: 7-bit limbs of the DFT matrix W[k, i] = w^{ki}
    (inverse: w^{-ki}/R, the member transform's share of the 1/n)."""
    r = 1 << log_r
    w = two_adic_generator(log_r)
    if inverse:
        w = pow(w, P - 2, P)
    rows = np.stack([np_geom_powers(pow(w, k, P), r) for k in range(r)]).astype(np.uint64)
    if inverse:
        rows = rows * pow(r, P - 2, P) % P
    out = np.empty((NUM_LIMBS, r, r), np.int8)
    for limb in range(NUM_LIMBS):
        out[limb] = ((rows >> (LIMB_BITS * limb)) & ((1 << LIMB_BITS) - 1)).astype(np.int8)
    return out


@functools.lru_cache(maxsize=None)
def shift_consts_mont() -> np.ndarray:
    """mont(2^(7s)) for s = 0 .. 2·(NUM_LIMBS-1): fp_mul(S_s, c_s) is the
    canonical S_s·2^(7s) mod p. The kernel bakes these in; the loader
    checks them."""
    return np.array(
        [(1 << (LIMB_BITS * s)) % P * R_MOD_P % P for s in range(2 * NUM_LIMBS - 1)], np.uint32
    )


@functools.lru_cache(maxsize=None)
def outer_twiddle_mont_mm(log_r: int, log_c: int, inverse: bool) -> np.ndarray:
    """(R, C) mont(g^{k1·i2}): fp_mul against canonical keeps canonical."""
    g = two_adic_generator(log_r + log_c)
    if inverse:
        g = pow(g, P - 2, P)
    rows = [np_geom_powers(pow(g, k1, P), 1 << log_c) for k1 in range(1 << log_r)]
    return (np.stack(rows).astype(np.uint64) * R_MOD_P % P).astype(np.uint32)


def outer_twiddle_rep(log_r: int, log_c: int, w: int, inverse: bool) -> np.ndarray:
    """(R, C·w) outer twiddles repeated across the width batch (the layout
    of the member output's columns), for the kernel's epilogue."""
    return np.repeat(outer_twiddle_mont_mm(log_r, log_c, inverse), w, axis=1)


@functools.lru_cache(maxsize=None)
def block_scale_consts(log_n: int, log_blowup: int, shift: int) -> np.ndarray:
    """(n, blow) mont((shift·w_N^rb)^i): canonical coefficient times this
    is the canonical block-scaled coefficient (natural coefficient order)."""
    n = 1 << log_n
    w_big = two_adic_generator(log_n + log_blowup)
    cols = []
    for rb in range(1 << log_blowup):
        base = shift * pow(w_big, rb, P) % P
        cols.append(np_geom_powers(base, n).astype(np.uint64) * R_MOD_P % P)
    return np.stack(cols, axis=1).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _table_dev(make, args: tuple, device) -> torch.Tensor:
    """The host table `make(*args)` moved to `device` once (int8 limbs as
    int8, uint32 words as int32 of the same bits)."""
    table = make(*args)
    if table.dtype == np.uint32:
        table = table.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(table)).to(device)


def mod_matmul_plain(x: torch.Tensor, log_r: int, inverse: bool, tw=None) -> torch.Tensor:
    """The 25 limb dots in float64, the 9 buckets recombined mod p, then the
    optional twiddle: the same words as the kernel."""
    limbs_w = _table_dev(w_matrix_limbs, (log_r, inverse), x.device).to(torch.float64)
    xw = x.to(torch.int64)
    mask = (1 << LIMB_BITS) - 1
    limbs_x = [((xw >> (LIMB_BITS * b)) & mask).to(torch.float64) for b in range(NUM_LIMBS)]
    acc = None
    for s, c in enumerate(shift_consts_mont()):
        bucket = sum(
            limbs_w[a] @ limbs_x[s - a]
            for a in range(max(0, s - NUM_LIMBS + 1), min(s, NUM_LIMBS - 1) + 1)
        )
        term = fp_mul(bucket.to(torch.int64), int(c))
        acc = term if acc is None else fp_add(acc, term)
    return acc if tw is None else fp_mul(acc, tw)


def mod_matmul(x: torch.Tensor, log_r: int, inverse: bool, tw=None) -> torch.Tensor:
    """(R, R) DFT matrix (inverse: its inverse's member share) times an
    (R, B) canonical matrix, mod p, canonical out; optionally times an
    (R, B) Montgomery twiddle tensor."""
    if x.dim() != 2 or x.shape[0] != 1 << log_r:
        raise ValueError(f"mod_matmul: expected {1 << log_r} rows, got shape {tuple(x.shape)}")
    if tw is not None and (tw.shape != x.shape or tw.device != x.device):
        raise ValueError(f"mod_matmul: twiddles {tuple(tw.shape)} on {tw.device} do not match x")
    if x.device.type == "cpu":
        return mod_matmul_plain(x, log_r, inverse, tw)
    if x.device.type != "cuda":
        raise ValueError(f"mod_matmul: no path for device {x.device}")
    _check_cuda(x, "mod_matmul")
    if tw is not None:
        _check_cuda(tw, "mod_matmul twiddles")
    if not 0 <= log_r <= LOG_RADIX:
        raise ValueError(f"mod_matmul: R = 2^{log_r} is not exact in int32 (R <= 2^{LOG_RADIX})")
    from .._build import load_library

    lib = load_library()
    dev = x.device
    limbs_w = _table_dev(w_matrix_limbs, (log_r, inverse), dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.tapstark_limb_matmul(
            limbs_w.data_ptr(), x.data_ptr(), None if tw is None else tw.data_ptr(),
            out.data_ptr(), log_r, x.shape[1], _stream_ptr(dev),
        )
    _raise_on(err, "mod_matmul")
    launches["mod_matmul"] += 1
    return out


def ntt_matmul(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """NTT (iNTT) of (n, w) canonical words, natural → natural order.

    Mixed radix with i = C·i1 + i2, k = k1 + R·k2 (R = 2^7): A = W_R @
    x.reshape(R, C·w), twiddle g^{k1·i2}, transpose, recurse on C batched
    over (k1, w); flat k2·R + k1 = k. Each member's W holds its own 1/R
    share of the inverse's 1/n."""
    n, w = x.shape
    log_n = log2_strict(n)
    if log_n <= LOG_RADIX:
        return mod_matmul(x, log_n, inverse)
    log_r, log_c = LOG_RADIX, log_n - LOG_RADIX
    r, c = 1 << log_r, 1 << log_c
    m = x.reshape(r, c * w).contiguous()
    tw = _table_dev(outer_twiddle_rep, (log_r, log_c, w, inverse), x.device)  # in the epilogue
    a = mod_matmul(m, log_r, inverse, tw=tw).reshape(r, c, w)
    b = a.transpose(0, 1).reshape(c, r * w).contiguous()  # B[i2, (k1, w)]
    return ntt_matmul(b, inverse).reshape(n, w)  # Y[k2, (k1, w)]


def coset_lde_batch_matmul(evals: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    """Coset LDE (Montgomery in and out, natural-order rows) through the
    limb-matmul NTT: iNTT, per-block coset scales, one forward NTT of
    width blow·w (output rows rb::blow are block rb)."""
    n, w = evals.shape
    log_n = log2_strict(n)
    blow = 1 << log_blowup
    coeffs = ntt_matmul(fp_mul(evals, 1), inverse=True)  # mont → canonical, then iNTT
    scales = _table_dev(block_scale_consts, (log_n, log_blowup, shift % P), evals.device)
    scaled = fp_mul(coeffs[:, None, :], scales[:, :, None])  # (n, blow, w)
    y = ntt_matmul(scaled.reshape(n, blow * w))
    return fp_mul(y, R2_MOD_P).reshape(n * blow, w)  # canonical → mont
