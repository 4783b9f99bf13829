"""The exact limb-matmul NTT (twin of `tapstark/poly/matmul_ntt.py`).

A member transform of size R ≤ 128 is a dense (R, R) DFT-matrix product,
done exactly in 8-bit integer dots.

- `mod_matmul` replaces `_fused_kernel` / `_fused_kernel_tw` (K7, via
  `mod_matmul_fused`). For a CUDA tensor it runs the u8 tensor-core
  kernel of `tapstark_torch/csrc/matmul_ntt.cu`: four byte limbs, the 16
  limb products summed into 7 int32 buckets by shift (each below
  4·255²·128 < 2^25), one Montgomery reduction of Σ_s S_s·mont(2^(8s)) per
  output, and the optional outer-twiddle multiply in its epilogue. For a
  CPU tensor it runs its plain version, which keeps the reference's own
  arithmetic (five 7-bit limbs, 25 dots in float64, exact: the 9 buckets
  stay below 2^31 ≪ 2^53), so it stays an independent yardstick; any
  other device raises. Given `width`, either writes its output in the
  next recursion level's layout (the transpose of `ntt_matmul`).
- `ntt_matmul` is the mixed-radix recursion (radix 2^7), one `mod_matmul`
  a level, and `coset_lde_batch_matmul` the block-decomposed LDE on top
  of it. On every device the outer twiddle rides in `mod_matmul`'s
  epilogue and the transpose in its store, as on the card, so the CPU
  runs the card's route.

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

LIMB_BITS = 7  # the plain version's limbs, as the reference's
NUM_LIMBS = 5  # covers < 2^35; values are < 2^31
BYTE_LIMBS = 4  # the kernel's u8 limbs: covers < 2^32
LOG_RADIX = 7  # member size of the recursion, and the largest exact R

# Launches of the kernel since the last reset (one per wrapper call that
# reached the card).
launches = {"mod_matmul": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def dft_matrix(log_r: int, inverse: bool) -> np.ndarray:
    """(R, R) uint64 canonical DFT matrix W[k, i] = w^{ki} (inverse:
    w^{-ki}/R, the member transform's share of the 1/n)."""
    r = 1 << log_r
    w = two_adic_generator(log_r)
    if inverse:
        w = pow(w, P - 2, P)
    rows = np.stack([np_geom_powers(pow(w, k, P), r) for k in range(r)]).astype(np.uint64)
    if inverse:
        rows = rows * pow(r, P - 2, P) % P
    return rows


@functools.lru_cache(maxsize=None)
def w_matrix_limbs(log_r: int, inverse: bool) -> np.ndarray:
    """(NUM_LIMBS, R, R) int8: 7-bit limbs of `dft_matrix` (the plain
    version's)."""
    r = 1 << log_r
    rows = dft_matrix(log_r, inverse)
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
def w_matrix_smem(log_r: int, inverse: bool) -> np.ndarray:
    """The kernel's W: `dft_matrix`'s BYTE_LIMBS u8 limb planes, each RP =
    max(R, 16) rows (k) of 128 bytes (i), zero-padded, in the shared-memory
    layout wgmma reads (`csrc/matmul_ntt.cuh w_plane_byte`: the 16-byte
    chunk c of row k at chunk c ^ (k % 8)), flat, so one bulk copy
    loads it."""
    r = 1 << log_r
    rp = max(r, 16)
    rows = dft_matrix(log_r, inverse)
    k, i = np.arange(r)[:, None], np.arange(r)[None, :]
    col = (((i >> 4) ^ (k & 7)) << 4) | (i & 15)
    out = np.zeros((BYTE_LIMBS, rp, 128), np.uint8)
    for limb in range(BYTE_LIMBS):
        out[limb, k, col] = (rows >> (8 * limb)) & 0xFF
    return out.reshape(-1)


@functools.lru_cache(maxsize=None)
def byte_shift_consts_mont() -> np.ndarray:
    """mont(2^(8s)) for s = 0 .. 2·(BYTE_LIMBS-1): the kernel's one reduction
    of Σ_s S_s·c_s is the canonical Σ_s S_s·2^(8s) mod p. The kernel bakes
    these in; the loader checks them."""
    return np.array([(1 << (8 * s)) % P * R_MOD_P % P for s in range(2 * BYTE_LIMBS - 1)], np.uint32)


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
    """The host table `make(*args)` moved to `device` once (int8 and uint8
    bytes as themselves, uint32 words as int32 of the same bits)."""
    table = make(*args)
    if table.dtype == np.uint32:
        table = table.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(table)).to(device)


def to_next_level(a: torch.Tensor, width: int) -> torch.Tensor:
    """(R, C·width) member output → (C, R·width): element (k, i2·width + wi)
    to (i2, k·width + wi), the layout of the recursion's next level."""
    r, b = a.shape
    return a.reshape(r, b // width, width).transpose(0, 1).reshape(b // width, r * width)


def mod_matmul_plain(x: torch.Tensor, log_r: int, inverse: bool, tw=None, width=None) -> torch.Tensor:
    """The 25 limb dots in float64, the 9 buckets recombined mod p, then the
    optional twiddle, then the optional transpose: the same words as the
    kernel."""
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
    out = acc if tw is None else fp_mul(acc, tw)
    return out if width is None else to_next_level(out, width)


def mod_matmul(x: torch.Tensor, log_r: int, inverse: bool, tw=None, width=None) -> torch.Tensor:
    """(R, R) DFT matrix (inverse: its inverse's member share) times an
    (R, B) canonical matrix, mod p, canonical out; optionally times an
    (R, B) Montgomery twiddle tensor. With `width` (a divisor of B), the
    (R, B) result is written as `to_next_level(result, width)`."""
    if x.dim() != 2 or x.shape[0] != 1 << log_r:
        raise ValueError(f"mod_matmul: expected {1 << log_r} rows, got shape {tuple(x.shape)}")
    if tw is not None and (tw.shape != x.shape or tw.device != x.device):
        raise ValueError(f"mod_matmul: twiddles {tuple(tw.shape)} on {tw.device} do not match x")
    if width is not None and (width < 1 or x.shape[1] % width):
        raise ValueError(f"mod_matmul: width {width} does not divide {x.shape[1]} columns")
    if x.device.type == "cpu":
        return mod_matmul_plain(x, log_r, inverse, tw, width)
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
    r, b = x.shape
    w_smem = _table_dev(w_matrix_smem, (log_r, inverse), dev)
    if b % 4:  # TMA reads rows whose pitch is a multiple of 16 bytes
        x = torch.nn.functional.pad(x, (0, -b % 4))
        tw = None if tw is None else torch.nn.functional.pad(tw, (0, -b % 4))
    out = torch.empty((r, b) if width is None else (b // width, r * width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.tapstark_mod_matmul(
            w_smem.data_ptr(), x.data_ptr(), None if tw is None else tw.data_ptr(), x.shape[1],
            out.data_ptr(), log_r, b, width or 0, _stream_ptr(dev),
        )
    _raise_on(err, "mod_matmul")
    launches["mod_matmul"] += 1
    return out


def ntt_matmul(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """NTT (iNTT) of (n, w) canonical words, natural → natural order.

    Mixed radix with i = C·i1 + i2, k = k1 + R·k2 (R = 2^7): W_R @
    x.reshape(R, C·w), twiddle g^{k1·i2} in the epilogue, written as
    B[i2, (k1, w)] by the same launch; recurse on C batched over (k1, w);
    flat k2·R + k1 = k. Each member's W holds its own 1/R share of the
    inverse's 1/n."""
    n, w = x.shape
    log_n = log2_strict(n)
    if log_n <= LOG_RADIX:
        return mod_matmul(x, log_n, inverse)
    log_r, log_c = LOG_RADIX, log_n - LOG_RADIX
    r, c = 1 << log_r, 1 << log_c
    tw = _table_dev(outer_twiddle_rep, (log_r, log_c, w, inverse), x.device)
    b = mod_matmul(x.reshape(r, c * w).contiguous(), log_r, inverse, tw=tw, width=w)  # B[i2, (k1, w)]
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
