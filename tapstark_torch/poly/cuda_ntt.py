"""The fused coset LDE on the card: `lde_inverse` (on the two DIF kernels
of `tapstark_torch/csrc/dif_cols.cuh`) and `lde_forward` (on the two DIT
kernels of `csrc/dit_cols.cuh`), and their plain versions.

- `lde_inverse` replaces `_fused_intt_kernel` (K1) of
  tapstark/poly/pallas_ntt.py: evaluations (n, w) natural order →
  coefficients (w, n), position p holding coefficient bitrev(p), times 1/n.
  On the card it is the four-step DIF pair (split by `inverse_split`):
  the column form over the natural (R, C·w) view, then the last member
  with 1/n into (w, n), launched through `cols_ntt.launch_dif_cols` and
  `launch_dif_last`: its launches count under "lde_inverse" here and
  under those kernels' own keys in `cols_ntt.launches`.
- `lde_forward` replaces `_fused_fwd_kernel` (K2): coefficients as
  `lde_inverse` leaves them → (n·2^log_blowup, w) natural-order evaluations
  on shift·<w_N>: block rb scales coefficient j by (shift·w_N^rb)^j, runs a
  size-n NTT and fills rows k·blow + rb. The zero-padded N-row array of
  the plain `coset_lde_batch` is never built. On the card it is the
  four-step DIT pair of `csrc/dit_cols.cuh` (split by `forward_split`),
  launched through `cols_ntt.launch_dit_first` and `launch_dit_cols`: its
  launches count under "lde_forward" here and under those kernels' own
  keys in `cols_ntt.launches`.

Each wrapper runs its kernels for a CUDA tensor and its plain version for
a CPU tensor, and raises for anything else. The source notes
(`csrc/dif_cols.cuh`, `csrc/dit_cols.cuh`) say what bounds the kernels on
an H100 and what the design does about it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..field.constants import P, two_adic_generator
from ..utils import log2_strict
from .ntt import bit_reverse_rows, intt, ntt, scale_by_shift_powers
from .powers import bitrev_indices_dev, geom_powers_mont_dev

# `lde_forward`'s first member keeps 2^11 rows (64 KiB tiles of 8 lanes)
# and leaves the rest, at most 2^14 rows, to the second; `lde_inverse`
# mirrors it (`inverse_split`): its last member keeps 2^11 rows of w lanes
# (16 KiB at w = 2, one block per row of its 2^9 at 2^20) and its column
# form takes the rest, whose 64 KiB tiles would be 128 at 2^20 x 2 against
# 132 SMs: the kernel then narrows them to 16 KiB (csrc/dif_cols.cuh), 512
# blocks.
FORWARD_LOG_R = 11
MAX_FORWARD_LOG_C = 14

# Launches since the last reset: one per wrapper call that reached the card.
launches = {"lde_inverse": 0, "lde_forward": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


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


def inverse_split(log_n: int) -> tuple[int, int]:
    """(log R, log C) of `lde_inverse`'s column form and last member, the
    mirror of `forward_split`; log R = 0 is one launch (the last member)."""
    log_c, log_r = forward_split(log_n)
    return log_r, log_c


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
    if not (1 <= log_n <= 27 and 1 <= w <= 65535 and n * w < 1 << 32):
        raise ValueError(f"lde_inverse: shape {(n, w)} unsupported")
    from .cols_ntt import launch_dif_cols, launch_dif_last

    log_r, log_c = inverse_split(log_n)
    out = torch.empty((w, n), dtype=torch.int32, device=evals.device)
    a = torch.empty((1 << log_r, w << log_c), dtype=torch.int32, device=out.device) if log_r else evals
    if log_r:
        launch_dif_cols(evals.view(1 << log_r, w << log_c), a, log_r, True, "lde_inverse")
    launch_dif_last(a, out, 1, n, log_r, log_c, w, True, "lde_inverse")
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
