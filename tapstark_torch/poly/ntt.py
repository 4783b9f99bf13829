"""Radix-2 NTT / inverse NTT / coset LDE on torch tensors (twin of
`tapstark.poly.ntt`).

A polynomial batch is an (n, w) int32 Montgomery tensor: n evaluations or
coefficients down axis 0, w independent columns. These are the plain
versions: natural order in and out, an explicit bit-reversal gather, then
log_n butterfly stages of eager tensor ops. `coset_lde_batch_auto` is the
entry point the PCS calls: it picks a route by log_n alone, as the JAX
package's TPU path does, and each route's kernel wrappers run their CUDA
kernels for a CUDA tensor and their plain versions for a CPU tensor.
"""

from __future__ import annotations

import functools

import torch

from ..field.constants import P, two_adic_generator
from ..field.device import fp_add, fp_const, fp_mul, fp_sub
from ..utils import log2_strict
from .powers import bitrev_indices_dev, geom_powers_mont_dev


@functools.lru_cache(maxsize=None)
def stage_twiddles(s: int, inverse: bool, device) -> torch.Tensor:
    """First 2^(s-1) powers of the order-2^s root (or its inverse),
    Montgomery int32 on `device` — the DIT stage-s table."""
    g = two_adic_generator(s)
    if inverse:
        g = pow(g, P - 2, P)
    return geom_powers_mont_dev(g, s - 1, 1, device)


def _butterfly_stages(x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """The log_n DIT stages over bit-reversed (n, w) input."""
    n = x.shape[0]
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        tw = stage_twiddles(s, inverse, x.device)
        blk = x.reshape(n >> s, 2 * half, -1)
        lo = blk[:, :half, :]
        t = fp_mul(blk[:, half:, :], tw[None, :, None])
        x = torch.cat([fp_add(lo, t), fp_sub(lo, t)], dim=1).reshape(n, -1)
    return x


def bit_reverse_rows(mat: torch.Tensor) -> torch.Tensor:
    """Permute rows by bit reversal (p3-matrix bit_reverse_rows)."""
    log_n = log2_strict(mat.shape[0])
    return mat.index_select(0, bitrev_indices_dev(log_n, mat.device))


# Launches of `bit_reverse_cols`'s kernel since the last reset.
launches = {"bit_reverse_cols": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def bit_reverse_cols_plain(mat: torch.Tensor, m: int) -> torch.Tensor:
    return bit_reverse_rows(mat[:m]).t().contiguous().t()


def bit_reverse_cols(mat: torch.Tensor, m: int) -> torch.Tensor:
    """`bit_reverse_rows(mat[:m])` laid out by columns: a (w, m) tensor,
    returned as its (m, w) transpose (strides (1, m)). On the card one
    launch of `csrc/bitrev_cols.cu` (a tiled transpose that reads each
    source row's words and writes each column's, both coalesced); on a
    CPU tensor, its plain version."""
    log_m = log2_strict(m)
    if mat.dim() != 2 or mat.shape[0] < m:
        raise ValueError(f"bit_reverse_cols: shape {tuple(mat.shape)} has fewer than {m} rows")
    if mat.device.type == "cpu":
        return bit_reverse_cols_plain(mat, m)
    if mat.device.type != "cuda":
        raise ValueError(f"bit_reverse_cols: no path for device {mat.device}")
    if mat.dtype != torch.int32 or not mat.is_contiguous():
        raise ValueError("bit_reverse_cols: expected a contiguous int32 tensor")
    from .._build import load_library

    out = torch.empty((mat.shape[1], m), dtype=torch.int32, device=mat.device)
    with torch.cuda.device(mat.device):
        err = load_library().tapstark_bitrev_cols(mat.data_ptr(), mat.shape[1], log_m, out.data_ptr(),
                                                   torch.cuda.current_stream(mat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bit_reverse_cols: CUDA error {err}")
    launches["bit_reverse_cols"] += 1
    return out.t()


def ntt(coeffs: torch.Tensor) -> torch.Tensor:
    """Forward NTT: natural coefficients (n, w) → natural evaluations."""
    log_n = log2_strict(coeffs.shape[0])
    return _butterfly_stages(bit_reverse_rows(coeffs), log_n, inverse=False)


def intt(evals: torch.Tensor) -> torch.Tensor:
    """Inverse NTT: natural evaluations (n, w) → natural coefficients."""
    log_n = log2_strict(evals.shape[0])
    x = _butterfly_stages(bit_reverse_rows(evals), log_n, inverse=True)
    return fp_mul(x, fp_const(pow(1 << log_n, P - 2, P)))


def scale_by_shift_powers(coeffs: torch.Tensor, shift: int) -> torch.Tensor:
    """Coefficient i times shift^i (the coset shift of an LDE)."""
    log_n = log2_strict(coeffs.shape[0])
    sp = geom_powers_mont_dev(shift % P, log_n, 1, coeffs.device)
    return fp_mul(coeffs, sp[:, None])


def coset_lde_batch(evals: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    """Low-degree extension onto the coset shift·<g_{n·2^log_blowup}>
    (natural order out), p3-dft `coset_lde_batch` semantics: iNTT, scale
    coefficient i by shift^i, zero-pad to the large domain, NTT."""
    n, w = evals.shape
    coeffs = scale_by_shift_powers(intt(evals), shift)
    padded = torch.zeros((n << log_blowup, w), dtype=torch.int32, device=evals.device)
    padded[:n] = coeffs
    return ntt(padded)


def coset_lde_batch_auto(evals: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    """coset_lde_batch by the route `coset_lde_batch_pallas_fused` takes
    (tapstark/poly/pallas_ntt.py:517-520), on every device: 2^8–2^21 rows
    through the fused halves (`cuda_ntt.coset_lde_batch_cuda`, K1/K2's
    counterparts), any other height through the four-step blocks route
    (`cols_ntt.coset_lde_blocks`, K3/K4's; padded below 2^4 rows). Any
    device but the CPU and CUDA raises."""
    if evals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"coset_lde_batch_auto: no path for device {evals.device}")
    if 8 <= log2_strict(evals.shape[0]) <= 21:
        from .cuda_ntt import coset_lde_batch_cuda

        return coset_lde_batch_cuda(evals, log_blowup, shift)
    from .cols_ntt import coset_lde_blocks

    return coset_lde_blocks(evals, log_blowup, shift)
