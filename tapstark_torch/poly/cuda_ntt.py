"""The fused coset LDE on the card: `lde_inverse` (its kernel in
`tapstark_torch/csrc/coset_lde.cu`) and `lde_forward` (on the two DIT
kernels of `csrc/dit_cols.cuh`), and their plain versions.

- `lde_inverse` replaces `_fused_intt_kernel` (K1) of
  tapstark/poly/pallas_ntt.py: evaluations (n, w) natural order →
  coefficients (w, n), position p holding coefficient bitrev(p), times 1/n.
- `lde_forward` replaces `_fused_fwd_kernel` (K2): coefficients as
  `lde_inverse` leaves them → (n·2^log_blowup, w) natural-order evaluations
  on shift·<w_N>: block rb scales coefficient j by (shift·w_N^rb)^j, runs a
  size-n NTT and fills rows k·blow + rb. The zero-padded N-row array of
  the plain `coset_lde_batch` is never built. On the card it is the
  four-step DIT pair of `csrc/dit_cols.cuh` (split by `forward_split`),
  launched through `cols_ntt.launch_dit_first` and `launch_dit_cols`: its
  launches count under "lde_forward" here and under those kernels' own
  keys in `cols_ntt.launches`.

Each wrapper runs its kernel for a CUDA tensor and its plain version for a
CPU tensor, and raises for anything else. The source notes
(`csrc/coset_lde.cu`, `csrc/dit_cols.cuh`) say what bounds the kernels on
an H100 and what the design does about it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..field.constants import P, two_adic_generator
from ..field.device import fp_const
from ..utils import log2_strict
from .ntt import bit_reverse_rows, intt, ntt, scale_by_shift_powers
from .powers import bitrev_indices_dev, geom_powers_mont_dev

# `lde_forward`'s first member keeps 2^11 rows (64 KiB tiles of 8 lanes)
# and leaves the rest, at most 2^14 rows, to the second.
FORWARD_LOG_R = 11
MAX_FORWARD_LOG_C = 14

# Launches since the last reset: one per wrapper call that reached the card.
launches = {"lde_inverse": 0, "lde_forward": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def inverse_twiddles(log_n: int, device) -> torch.Tensor:
    """(n/2,) Montgomery powers w_n^{-e} on `device`."""
    return geom_powers_mont_dev(pow(two_adic_generator(log_n), P - 2, P), log_n - 1, 1, device)


@functools.lru_cache(maxsize=None)
def block_scales(log_n: int, log_blowup: int, shift: int, device) -> torch.Tensor:
    """(blow, n) Montgomery tables: row rb holds the powers of
    shift·w_N^rb (N = n·blow) in bit-reversed order, so that it lines up
    with the coefficients `lde_inverse` leaves."""
    w_big = two_adic_generator(log_n + log_blowup)
    rows = [
        geom_powers_mont_dev(shift * pow(w_big, rb, P) % P, log_n, 1, device)
        for rb in range(1 << log_blowup)
    ]
    brv = bitrev_indices_dev(log_n, device)
    return torch.stack(rows).index_select(1, brv).contiguous()


def forward_split(log_n: int) -> tuple[int, int]:
    """(log R, log C) of `lde_forward`'s two members; log C = 0 is one
    launch."""
    log_r = min(log_n, max(FORWARD_LOG_R, log_n - MAX_FORWARD_LOG_C))
    return log_r, log_n - log_r


def _check_cuda(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 Montgomery words, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 2-D tensor, got {tuple(x.shape)}")


def _stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def lde_inverse_plain(evals: torch.Tensor) -> torch.Tensor:
    return bit_reverse_rows(intt(evals)).T.contiguous()


def lde_forward_plain(coeffs_brv: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    coeffs = bit_reverse_rows(coeffs_brv.T)
    n, w = coeffs.shape
    padded = torch.zeros((n << log_blowup, w), dtype=torch.int32, device=coeffs.device)
    padded[:n] = scale_by_shift_powers(coeffs, shift)
    return ntt(padded)


def lde_inverse(evals: torch.Tensor) -> torch.Tensor:
    """(n, w) natural evaluations → (w, n) bit-reversed coefficients / n."""
    if evals.device.type == "cpu":
        return lde_inverse_plain(evals)
    if evals.device.type != "cuda":
        raise ValueError(f"lde_inverse: no path for device {evals.device}")
    _check_cuda(evals, "lde_inverse")
    n, w = evals.shape
    log_n = log2_strict(n)
    if not (1 <= log_n <= 27 and 1 <= w <= 65535):
        raise ValueError(f"lde_inverse: shape {(n, w)} unsupported")
    from .._build import load_library

    lib = load_library()
    tw = inverse_twiddles(log_n, evals.device)
    out = torch.empty((w, n), dtype=torch.int32, device=evals.device)
    with torch.cuda.device(evals.device):
        err = lib.tapstark_lde_inverse(
            evals.data_ptr(), out.data_ptr(), tw.data_ptr(), log_n, w,
            fp_const(pow(n, P - 2, P)), _stream_ptr(evals.device),
        )
    _raise_on(err, "lde_inverse")
    launches["lde_inverse"] += 1
    return out


def lde_forward(coeffs_brv: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    """(w, n) coefficients from `lde_inverse` → (n·2^log_blowup, w)
    natural-order evaluations on the coset shift·<w_N>."""
    if coeffs_brv.device.type == "cpu":
        return lde_forward_plain(coeffs_brv, log_blowup, shift)
    if coeffs_brv.device.type != "cuda":
        raise ValueError(f"lde_forward: no path for device {coeffs_brv.device}")
    _check_cuda(coeffs_brv, "lde_forward")
    w, n = coeffs_brv.shape
    log_n = log2_strict(n)
    if not (1 <= log_n and 0 <= log_blowup and log_n + log_blowup <= 27 and 1 <= w <= 65535
            and (w << log_blowup) < 1 << 31):
        raise ValueError(f"lde_forward: shape {(w, n)}, log_blowup {log_blowup} unsupported")
    from .cols_ntt import launch_dit_cols, launch_dit_first

    log_r, log_c = forward_split(log_n)
    out = torch.empty((n << log_blowup, w), dtype=torch.int32, device=coeffs_brv.device)
    b = torch.empty((1 << log_c, (w << log_blowup) << log_r), dtype=torch.int32, device=out.device) if log_c else out
    launch_dit_first(coeffs_brv, 1, n, b, log_r, log_c, log_blowup, w, shift, False, "lde_forward")
    if log_c:
        launch_dit_cols(b, out, log_c, False, "lde_forward")
    launches["lde_forward"] += 1
    return out


def coset_lde_batch_cuda(evals: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    """`coset_lde_batch` through the two kernels (word-for-word equal)."""
    return lde_forward(lde_inverse(evals), log_blowup, shift)
