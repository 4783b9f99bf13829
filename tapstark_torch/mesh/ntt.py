"""The four-step NTT over a mesh (twin of `tapstark/mesh/ntt.py`).

With n = R·C, i = i1·C + i2 and k = k1 + R·k2 (w = w_n):
    X[k1 + R·k2] = sum_{i2} w^(i2·k1) · w_C^(i2·k2) · sum_{i1} x[i1·C + i2] w_R^(i1·k1)
Each shard holds C/num whole columns i2 of the (R, C) layout M[i1, i2] =
x[i1·C + i2].
- Step 1: the column NTTs of size R on each shard's columns: rows
  bit-reversed, then `cols_ntt.dit_cols` (K3's counterpart) on the
  shard's device.
- Step 2: the outer twiddle w^(i2·k1), the shard's column slice of
  `cols_ntt.outer_twiddle_mont` (times 1/n for the inverse: the only 1/n).
- Step 3: one `all_to_all`: shard e receives the rows k1 of its R/num.
- Step 4: the column NTTs of size C on (C, R/num·w), rows bit-reversed
  first, `dit_cols` again. Shard e then holds Y[k2, k1] = X[k1 + R·k2]
  for its k1, so the (C, R) result read row by row is X in natural order.

The split and its limit are the JAX package's: log C = max(log num,
log_n // 2), and log R = log_n - log C must be at least log num.

`distributed_ntt` and `distributed_coset_lde` take and return (n, w)
tensors on the mesh's primary device, as the JAX functions return global
arrays. The coset LDE gathers the coefficients on the primary device
between its two transforms, scales them by the shift's powers there, and
scatters only the blocks' rows that hold coefficients: each shard pads
its own block with zeros. Its exchanges move, for n rows of w words, the
inverse's n·w words three times (scatter, all_to_all, gather) and the
forward's n·w, blow·n·w and blow·n·w words, each times (num - 1)/num
(`collectives.counts`). `coset_lde_shards` stops before the last gather
and leaves each shard its part of the transform, for the sharded
prover step.
"""

from __future__ import annotations

import functools

import torch

from ..field.constants import P
from ..field.device import fp_const, fp_mul
from ..poly.cols_ntt import dit_cols, outer_twiddle_mont
from ..poly.ntt import scale_by_shift_powers
from ..poly.powers import bitrev_indices_dev
from ..utils import log2_strict
from . import collectives


def split(log_n: int, num: int) -> tuple[int, int]:
    """(log R, log C) of the mesh's four-step split (tapstark/mesh/ntt.py:95-101)."""
    log_num = log2_strict(num)
    log_c = max(log_num, log_n // 2)
    log_r = log_n - log_c
    if log_r < log_num:
        raise ValueError(f"n=2^{log_n} too small to shard over {num} devices (need log_n >= 2*log(devices))")
    return log_r, log_c


@functools.lru_cache(maxsize=None)
def _twiddle_slice(log_r: int, log_c: int, inverse: bool, d: int, num: int, device) -> torch.Tensor:
    """Shard d's columns of the outer twiddle, (R, C/num); for the inverse
    times 1/n."""
    c_local = (1 << log_c) // num
    tw = outer_twiddle_mont(log_r, log_c, inverse, device)[:, d * c_local : (d + 1) * c_local]
    if inverse:
        tw = fp_mul(tw, fp_const(pow(1 << (log_r + log_c), P - 2, P)))
    return tw.contiguous()


def ntt_shards(mesh, blocks: list[torch.Tensor], log_r: int, log_c: int, inverse: bool) -> list[torch.Tensor]:
    """Steps 1-4 on the shards: blocks[d] is shard d's (R, C/num, w)
    columns of M; returns shard e's (C, R/num, w) rows of Y, Y[k2, k1] =
    X[k1 + R·k2] (times 1/n if inverse), k1 in e's R/num."""
    num = mesh.size
    r, c = 1 << log_r, 1 << log_c
    c_local, w = c // num, blocks[0].shape[2]
    sent = []
    for d, blk in enumerate(blocks):
        dev = blk.device
        m = blk.reshape(r, c_local * w).index_select(0, bitrev_indices_dev(log_r, dev))
        a = dit_cols(m, log_r, inverse).reshape(r, c_local, w)  # A[k1, i2 local]
        sent.append(fp_mul(a, _twiddle_slice(log_r, log_c, inverse, d, num, dev)[:, :, None]))
    recv = collectives.all_to_all(mesh, sent, 0)  # shard e: (num, R/num, C/num, w), [d] = d's columns
    out = []
    for e, got in enumerate(recv):
        dev = got.device
        brv = bitrev_indices_dev(log_c, dev)
        b = got[brv // c_local, :, brv % c_local, :]  # (C, R/num, w): row i2 = brv_C(position)
        out.append(dit_cols(b.reshape(c, -1), log_c, inverse).reshape(c, r // num, w))
    return out


def distributed_ntt(mesh, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """NTT (iNTT) of an (n, w) Montgomery matrix on the mesh's primary
    device over the mesh, natural order in and out, on the primary device."""
    n, w = x.shape
    log_r, log_c = split(log2_strict(n), mesh.size)
    blocks = collectives.scatter(mesh, x.reshape(1 << log_r, 1 << log_c, w), 1)
    ys = ntt_shards(mesh, blocks, log_r, log_c, inverse)
    return collectives.gather(mesh, ys, 1).reshape(n, w)


def coset_lde_shards(mesh, evals: torch.Tensor, log_blowup: int, shift: int):
    """The coset LDE of (n, w) evaluations on the primary device up to the
    forward transform's last step: (shard e's (C, R/num, w) rows of Y,
    (log R, log C)) of the N = n·2^log_blowup point transform."""
    n, w = evals.shape
    coeffs = scale_by_shift_powers(distributed_ntt(mesh, evals, inverse=True), shift)
    log_r, log_c = split(log2_strict(n) + log_blowup, mesh.size)
    r, c = 1 << log_r, 1 << log_c
    # the coefficients fill the first max(n, C) flat positions of the (R, C) layout
    if n < c:
        coeffs = torch.cat([coeffs, torch.zeros((c - n, w), dtype=coeffs.dtype, device=coeffs.device)])
    top = coeffs.reshape(-1, c, w)
    parts = collectives.scatter(mesh, top, 1)
    blocks = []
    for part in parts:
        blk = torch.zeros((r, c // mesh.size, w), dtype=part.dtype, device=part.device)
        blk[: part.shape[0]] = part
        blocks.append(blk)
    return ntt_shards(mesh, blocks, log_r, log_c, False), (log_r, log_c)


def distributed_coset_lde(mesh, evals: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    """Coset LDE of (n, w) Montgomery evaluations onto shift·<w_N>, N =
    n·2^log_blowup, over the mesh (p3-dft coset_lde_batch semantics, the
    words `poly.ntt.coset_lde_batch_auto` gives): distributed iNTT, shift
    powers, zero padding, distributed NTT; (N, w) natural order on the
    primary device."""
    n, w = evals.shape
    ys, _ = coset_lde_shards(mesh, evals, log_blowup, shift)
    return collectives.gather(mesh, ys, 1).reshape(n << log_blowup, w)
