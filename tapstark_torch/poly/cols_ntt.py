"""Column NTTs and the four-step LDE routes outside the fused range (twin
of the non-fused routes of `tapstark/poly/pallas_ntt.py`).

- `dit_cols` replaces `_butterfly_kernel` (K3, via `_ntt_cols_pallas`):
  the transform down axis 0 of an (R, B) Montgomery matrix, rows
  bit-reversed in, natural out, no 1/n.
- `dit_cols_first` is K3 again, as the first member of a forward coset
  LDE with the route's glue taken into the kernel: (n, w) coefficients in
  bitrev_n order → B[p2, (k1, rb, w)] = the R-point DIT of block rb's
  scaled coefficients p2·R .. p2·R + R - 1, times the outer twiddle
  (`dit_cols_first_plain` is the composition it replaces).
- `dif_cols` replaces `_dif_butterfly_kernel` (K4, via `_dif_cols_pallas`):
  natural in, bit-reversed out.
- `dif_cols_last` is K4 again, as the last member of an inverse transform
  with the route's glue taken into the kernel: A[p1, (i2, w)] (the column
  form's output over R) → (n, w) coefficients in bitrev_n order, position
  p1·C + p2 = the C-point DIF of row p1 times the outer twiddle
  (`dif_cols_last_plain` is the composition it replaces).

Each wrapper runs its kernel (entry points in
`tapstark_torch/csrc/ntt_cols.cu`, kernels in `dit_cols.cuh` and its DIF
twin `dif_cols.cuh`) for a CUDA tensor and its plain version for a CPU
tensor, and raises for anything else. The pipelines around them:

- `ntt_cols_fourstep` is `ntt_pallas`; `intt_to_bitrev` (`dif_cols` over
  R, then `dif_cols_last` with the 1/n) is `intt_to_bitrev_pallas`;
  `ntt_from_bitrev` (`dit_cols_first` with one block and no shift, then
  `dit_cols` over its C rows) is `ntt_from_bitrev_pallas`;
- `coset_lde_nogather` is `coset_lde_batch_pallas_nogather`: the two
  halves above with the shift powers (in bitrev_n order) and the zero pad
  of the bit-reversed big domain between them, as plain torch;
- `coset_lde_padded` is `coset_lde_batch_pallas` (the zero-padded LDE);
- `coset_lde_blocks` is `coset_lde_batch_pallas_blocks` (`blow` pre-scaled
  n-point NTTs as one NTT of width blow·w), which `coset_lde_batch_auto`
  takes for every trace outside 2^8–2^21 rows. It is four launches and
  nothing between them: the inverse half is `dif_cols` over the natural
  (R, C·w) view and `dif_cols_last` into (n, w) in bitrev_n order; the
  forward half is `dit_cols_first` (whose scale table carries the inverse
  half's 1/n) and `dit_cols` over the C rows of its output, which are
  already the natural (blow·n, w) rows.
"""

from __future__ import annotations

import functools

import torch

from ..field.constants import P, two_adic_generator
from ..field.device import fp_const, fp_mul
from ..utils import bitrev_indices, log2_strict
from .cuda_ntt import _check_cuda, _raise_on, _stream_ptr, block_scales
from .dit_tables import dit_stage_pairs_dev, first_member_tables_dev, last_member_tables_dev
from .ntt import _butterfly_stages, bit_reverse_rows, coset_lde_batch, intt, ntt, scale_by_shift_powers
from .powers import bitrev_indices_dev, geom_powers_mont_dev

# The largest log R one kernel launch takes (csrc/ntt_cols.cu kMaxLogR;
# the loader checks the two agree). The four-step split of 2^27, the
# field's largest two-adic size, is 14 + 13.
MAX_LOG_R = 14

# Launches since the last reset. "dit_cols" and "dif_cols": one per call of
# their wrappers that reached the card (each for both of its forms).
# "dit_cols.first" and "dit_cols.cols": one per launch of the two DIT
# kernels (`dit_first_kernel`, `dit_cols_kernel` of csrc/dit_cols.cuh),
# whichever wrapper made it: `dit_cols`'s two forms, or
# `cuda_ntt.lde_forward`, which runs on the same pair. "dif_cols.cols" and
# "dif_cols.last" likewise for the two DIF kernels (`dif_cols_kernel`,
# `dif_last_kernel` of csrc/dif_cols.cuh): `dif_cols`'s two forms, or
# `cuda_ntt.lde_inverse`.
launches = {"dit_cols": 0, "dit_cols.first": 0, "dit_cols.cols": 0,
            "dif_cols": 0, "dif_cols.cols": 0, "dif_cols.last": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def outer_twiddle_mont(log_r: int, log_c: int, inverse: bool, device) -> torch.Tensor:
    """(R, C) Montgomery w_N^{k1·i2} (w_N^{-k1·i2} if inverse), N = R·C,
    gathered from the N powers of w_N on `device`."""
    w = two_adic_generator(log_r + log_c)
    if inverse:
        w = pow(w, P - 2, P)
    powers = geom_powers_mont_dev(w, log_r + log_c, 1, device)
    k1 = torch.arange(1 << log_r, dtype=torch.int64, device=device)
    i2 = torch.arange(1 << log_c, dtype=torch.int64, device=device)
    exps = (k1[:, None] * i2[None, :]) & ((1 << (log_r + log_c)) - 1)
    return powers[exps]


@functools.lru_cache(maxsize=None)
def outer_twiddle_brv_rows(log_r: int, log_c: int, inverse: bool, device) -> torch.Tensor:
    """(R, C): T[p1, i2] = w^{±brv_R(p1)·i2} (rows bit-reversed)."""
    return outer_twiddle_mont(log_r, log_c, inverse, device).index_select(
        0, bitrev_indices_dev(log_r, device)
    )


@functools.lru_cache(maxsize=None)
def outer_twiddle_brv_cols(log_r: int, log_c: int, inverse: bool, device) -> torch.Tensor:
    """(R, C): T[k1, p2] = w^{±k1·brv_C(p2)} (columns bit-reversed)."""
    return outer_twiddle_mont(log_r, log_c, inverse, device).index_select(
        1, bitrev_indices_dev(log_c, device)
    ).contiguous()


def split(log_n: int) -> tuple[int, int]:
    """(log R, log C) of the four-step split: R takes the odd bit."""
    log_c = log_n // 2
    return log_n - log_c, log_c


def dit_cols_plain(mat: torch.Tensor, log_r: int, inverse: bool) -> torch.Tensor:
    return _butterfly_stages(mat, log_r, inverse)


def dif_cols_plain(mat: torch.Tensor, log_r: int, inverse: bool) -> torch.Tensor:
    return bit_reverse_rows(_butterfly_stages(bit_reverse_rows(mat), log_r, inverse))


def _cols(mat: torch.Tensor, log_r: int, inverse: bool, dif: bool) -> torch.Tensor:
    name = "dif_cols" if dif else "dit_cols"
    if mat.dim() != 2 or mat.shape[0] != 1 << log_r:
        raise ValueError(f"{name}: expected {1 << log_r} rows, got shape {tuple(mat.shape)}")
    if mat.device.type == "cpu":
        return (dif_cols_plain if dif else dit_cols_plain)(mat, log_r, inverse)
    if mat.device.type != "cuda":
        raise ValueError(f"{name}: no path for device {mat.device}")
    _check_cuda(mat, name)
    if not 1 <= log_r <= MAX_LOG_R or mat.shape[1] < 1 or (dif and mat.numel() >= 1 << 32):
        raise ValueError(f"{name}: shape {tuple(mat.shape)} unsupported (1 <= log R <= {MAX_LOG_R}; DIF: R·B < 2^32)")
    out = torch.empty_like(mat)
    (launch_dif_cols if dif else launch_dit_cols)(mat, out, log_r, inverse, name)
    launches[name] += 1
    return out


def launch_dit_cols(src: torch.Tensor, dst: torch.Tensor, log_r: int, inverse: bool, what: str) -> None:
    """`dit_cols_kernel` on the card: src (R, B) → dst (as many words),
    DIT down axis 0, rows bit-reversed in, natural out."""
    from .._build import load_library

    dev = src.device
    tw = dit_stage_pairs_dev(log_r, inverse, dev)
    with torch.cuda.device(dev):
        err = load_library().tapstark_dit_cols(src.data_ptr(), dst.data_ptr(), tw.data_ptr(), log_r, src.shape[1],
                                               _stream_ptr(dev))
    _raise_on(err, what)
    launches["dit_cols.cols"] += 1


def launch_dif_cols(src: torch.Tensor, dst: torch.Tensor, log_r: int, inverse: bool, what: str) -> None:
    """`dif_cols_kernel` on the card: src (R, B) → dst (as many words),
    DIF down axis 0, rows natural in, bit-reversed out."""
    from .._build import load_library

    dev = src.device
    tw = dit_stage_pairs_dev(log_r, inverse, dev)
    with torch.cuda.device(dev):
        err = load_library().tapstark_dif_cols(src.data_ptr(), dst.data_ptr(), tw.data_ptr(), log_r, src.shape[1],
                                               _stream_ptr(dev))
    _raise_on(err, what)
    launches["dif_cols.cols"] += 1


def launch_dif_last(a: torch.Tensor, out: torch.Tensor, out_row: int, out_col: int, log_r: int, log_c: int,
                    w: int, n_inv: bool, what: str) -> None:
    """`dif_last_kernel` on the card: A (R, C·w), row p1 = (i2, c) → the
    inverse transform's position p1·C + p2 (bitrev_n order) of column c at
    out's word (p1·C + p2)·out_row + c·out_col, times 1/n if n_inv."""
    from .._build import load_library

    dev = a.device
    tw = dit_stage_pairs_dev(log_c, True, dev)
    t = last_member_tables_dev(log_r, log_c, n_inv, dev)
    with torch.cuda.device(dev):
        err = load_library().tapstark_dif_last(
            a.data_ptr(), out.data_ptr(), out_row, out_col, tw.data_ptr(), t["hi"].data_ptr(), t["lo"].data_ptr(),
            t["c0"], log_r, log_c, t["h"], w, _stream_ptr(dev),
        )
    _raise_on(err, what)
    launches["dif_cols.last"] += 1


def launch_dit_first(x: torch.Tensor, x_row: int, x_col: int, out: torch.Tensor, log_r: int, log_c: int,
                     log_blowup: int, w: int, shift: int, n_inv: bool, what: str) -> None:
    """`dit_first_kernel` on the card: the n = R·C coefficients of w
    columns, coefficient j (bitrev_n order) of column c at x's word
    j·x_row + c·x_col → out (C, R·blow·w), B[p2, (k1, rb, c)]."""
    from .._build import load_library

    dev = x.device
    tw = dit_stage_pairs_dev(log_r, False, dev)
    t = first_member_tables_dev(log_r, log_c, log_blowup, shift % P, n_inv, dev)
    with torch.cuda.device(dev):
        err = load_library().tapstark_dit_first(
            x.data_ptr(), x_row, x_col, out.data_ptr(), tw.data_ptr(), t["s1"].data_ptr(), t["s2"].data_ptr(),
            t["hi"].data_ptr(), t["lo"].data_ptr(), log_r, log_c, t["h"], log_blowup, w, _stream_ptr(dev),
        )
    _raise_on(err, what)
    launches["dit_cols.first"] += 1


def dit_cols(mat: torch.Tensor, log_r: int, inverse: bool) -> torch.Tensor:
    """Column NTTs of an (R, B) Montgomery matrix: rows bit-reversed in,
    natural out, no 1/n."""
    return _cols(mat, log_r, inverse, dif=False)


def dif_cols(mat: torch.Tensor, log_r: int, inverse: bool) -> torch.Tensor:
    """Column NTTs of an (R, B) Montgomery matrix: natural in, rows
    bit-reversed out, no 1/n."""
    return _cols(mat, log_r, inverse, dif=True)


def dit_cols_first_plain(coeffs_brv: torch.Tensor, log_blowup: int, shift: int, n_inv: bool = False) -> torch.Tensor:
    """The composition `dit_cols_first` replaces: scale block rb by the
    powers of shift·w_N^rb (`block_scales`, and by 1/n if n_inv), view
    (C, R, blow·w) and transpose to (R, C·blow·w), `dit_cols_plain` over R,
    outer twiddle w_n^{k1·brv_C(p2)}, transpose to (C, R·blow·w)."""
    n, w = coeffs_brv.shape
    log_n = log2_strict(n)
    log_r, log_c = split(log_n)
    r, c, width = 1 << log_r, 1 << log_c, w << log_blowup
    dev = coeffs_brv.device
    scaled = fp_mul(coeffs_brv[:, None, :], block_scales(log_n, log_blowup, shift % P, dev).T[:, :, None])
    if n_inv:
        scaled = fp_mul(scaled, fp_const(pow(n, P - 2, P)))
    m = scaled.reshape(c, r, width).transpose(0, 1).reshape(r, c * width)  # rows brv_R(i1)
    a = dit_cols_plain(m, log_r, False)  # A[k1, (brv_C(i2), rb, w)]
    a = fp_mul(a.reshape(r, c, width), outer_twiddle_brv_cols(log_r, log_c, False, dev)[:, :, None])
    return a.transpose(0, 1).reshape(c, r * width).contiguous()  # B[brv_C(i2), (k1, rb, w)]


def dit_cols_first(coeffs_brv: torch.Tensor, log_blowup: int, shift: int, n_inv: bool = False) -> torch.Tensor:
    """(n, w) Montgomery coefficients in bitrev_n order → (C, R·blow·w):
    the first member of a forward coset LDE on shift·<w_N> (N = blow·n),
    `dit_cols_first_plain`'s function; `dit_cols` over its C rows finishes
    the LDE."""
    if coeffs_brv.dim() != 2:
        raise ValueError(f"dit_cols_first: expected (n, w), got shape {tuple(coeffs_brv.shape)}")
    if coeffs_brv.device.type == "cpu":
        return dit_cols_first_plain(coeffs_brv, log_blowup, shift, n_inv)
    if coeffs_brv.device.type != "cuda":
        raise ValueError(f"dit_cols_first: no path for device {coeffs_brv.device}")
    _check_cuda(coeffs_brv, "dit_cols_first")
    n, w = coeffs_brv.shape
    log_n = log2_strict(n)
    log_r, log_c = split(log_n)
    if not (1 <= log_r <= MAX_LOG_R and log_blowup >= 0 and (w << log_blowup) < 1 << 31):
        raise ValueError(f"dit_cols_first: shape {(n, w)}, log_blowup {log_blowup} unsupported")
    out = torch.empty((1 << log_c, (w << log_blowup) << log_r), dtype=torch.int32, device=coeffs_brv.device)
    launch_dit_first(coeffs_brv, w, 1, out, log_r, log_c, log_blowup, w, shift, n_inv, "dit_cols_first")
    launches["dit_cols"] += 1
    return out


def ntt_cols_fourstep(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """NTT (iNTT) of an (n, w) Montgomery matrix, natural → natural order
    (twin of `ntt_pallas`): bitrev_R, `dit_cols` over R, outer twiddle,
    transpose, bitrev_C, `dit_cols` over C."""
    n, w = x.shape
    log_n = log2_strict(n)
    if log_n <= 1:
        return intt(x) if inverse else ntt(x)
    log_r, log_c = split(log_n)
    r, c = 1 << log_r, 1 << log_c
    dev = x.device
    m = x.reshape(r, c * w).index_select(0, bitrev_indices_dev(log_r, dev))
    a = dit_cols(m, log_r, inverse)  # A[k1, (i2, w)]
    a = fp_mul(a.reshape(r, c, w), outer_twiddle_mont(log_r, log_c, inverse, dev)[:, :, None])
    b = a.transpose(0, 1).reshape(c, r * w).index_select(0, bitrev_indices_dev(log_c, dev))
    out = dit_cols(b, log_c, inverse).reshape(n, w)  # flat k2·R + k1 = k
    if inverse:
        out = fp_mul(out, fp_const(pow(n, P - 2, P)))
    return out


def dif_cols_last_plain(a: torch.Tensor, log_c: int, n_inv: bool = False) -> torch.Tensor:
    """The composition `dif_cols_last` replaces: outer twiddle
    w_n^{-brv_R(p1)·i2} (and 1/n if n_inv), transpose to (C, R·w),
    `dif_cols_plain` over C, transpose to (n, w), flat p1·C + p2."""
    r, cw = a.shape
    log_r = log2_strict(r)
    c, w = 1 << log_c, cw >> log_c
    n = r * c
    t = fp_mul(a.reshape(r, c, w), outer_twiddle_brv_rows(log_r, log_c, True, a.device)[:, :, None])
    if n_inv:
        t = fp_mul(t, fp_const(pow(n, P - 2, P)))
    b = t.transpose(0, 1).reshape(c, r * w)  # B[i2, (p1, w)]
    y = dif_cols_plain(b, log_c, True)  # Y[p2, (p1, w)]
    return y.reshape(c, r, w).transpose(0, 1).reshape(n, w)  # flat p1·C + p2


def dif_cols_last(a: torch.Tensor, log_c: int, n_inv: bool = False) -> torch.Tensor:
    """(R, C·w) Montgomery A[p1, (i2, w)], the column form's output over
    the natural (R, C·w) view of n = R·C evaluations → (n, w): the inverse
    transform's coefficients in bitrev_n order (times 1/n if n_inv),
    `dif_cols_last_plain`'s function."""
    if a.dim() != 2:
        raise ValueError(f"dif_cols_last: expected (R, C·w), got shape {tuple(a.shape)}")
    if a.device.type == "cpu":
        return dif_cols_last_plain(a, log_c, n_inv)
    if a.device.type != "cuda":
        raise ValueError(f"dif_cols_last: no path for device {a.device}")
    _check_cuda(a, "dif_cols_last")
    r, cw = a.shape
    log_r = log2_strict(r)
    w = cw >> log_c
    if not (log_r <= MAX_LOG_R and 1 <= log_c <= MAX_LOG_R and w >= 1 and w << log_c == cw):
        raise ValueError(f"dif_cols_last: shape {(r, cw)}, log_c {log_c} unsupported")
    out = torch.empty((r << log_c, w), dtype=torch.int32, device=a.device)
    launch_dif_last(a, out, w, 1, log_r, log_c, w, n_inv, "dif_cols_last")
    launches["dif_cols"] += 1
    return out


def intt_to_bitrev(evals: torch.Tensor, n_inv: bool = True) -> torch.Tensor:
    """(n, w) natural evaluations → coefficients in bitrev_n order, times
    1/n (twin of `intt_to_bitrev_pallas`): `dif_cols` over the natural
    (R, C·w) view, then `dif_cols_last`, and nothing between them. With
    n_inv False the 1/n is left out: the blocks route folds it into its
    forward half's scale table."""
    n, w = evals.shape
    log_r, log_c = split(log2_strict(n))
    a = dif_cols(evals.reshape(1 << log_r, w << log_c).contiguous(), log_r, True)  # A[p1, (i2, w)]
    return dif_cols_last(a, log_c, n_inv)  # flat p1·C + p2


def coset_lde_padded(evals: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    """Coset LDE by iNTT, coset shift, zero padding and a big NTT, both
    four-step (twin of `coset_lde_batch_pallas`)."""
    n, w = evals.shape
    coeffs = scale_by_shift_powers(ntt_cols_fourstep(evals, inverse=True), shift)
    padded = torch.zeros((n << log_blowup, w), dtype=torch.int32, device=evals.device)
    padded[:n] = coeffs
    return ntt_cols_fourstep(padded)


def coset_lde_blocks(evals: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    """Coset LDE with no zero padding (twin of
    `coset_lde_batch_pallas_blocks`): with N = blow·n and big-domain index
    k = blow·m + rb, shift·w_N^k = (shift·w_N^rb)·w_n^m, so output rows
    rb::blow are the n-point NTT of the coefficients scaled by the powers of
    shift·w_N^rb. All blow blocks run as one NTT of width blow·w. Below
    2^4 rows it takes the padded route, as the reference does."""
    n, w = evals.shape
    log_n = log2_strict(n)
    if log_n < 4:
        return coset_lde_padded(evals, log_blowup, shift)
    coeffs_brv = intt_to_bitrev(evals, n_inv=False)
    b = dit_cols_first(coeffs_brv, log_blowup, shift, n_inv=True)  # B[p2, (k1, rb, w)]
    y = dit_cols(b, split(log_n)[1], False)  # y[k2, (k1, rb, w)], k = k2·R + k1
    return y.reshape(n << log_blowup, w)


def bitrev_indices_np(log_n: int):
    """Bit-reversal permutation of size 2^log_n (uint32 numpy)."""
    return bitrev_indices(log_n)


def intt_to_bitrev_plain(evals: torch.Tensor) -> torch.Tensor:
    """`intt_to_bitrev` from the plain column transforms."""
    n, w = evals.shape
    log_r, log_c = split(log2_strict(n))
    a = dif_cols_plain(evals.reshape(1 << log_r, w << log_c), log_r, True)
    return dif_cols_last_plain(a, log_c, n_inv=True)


def ntt_from_bitrev_plain(coeffs_brv: torch.Tensor) -> torch.Tensor:
    """`ntt_from_bitrev` from the plain column transforms."""
    n, w = coeffs_brv.shape
    b = dit_cols_first_plain(coeffs_brv, 0, 1)
    return dit_cols_plain(b, split(log2_strict(n))[1], False).reshape(n, w)


def ntt_from_bitrev(coeffs_brv: torch.Tensor) -> torch.Tensor:
    """(n, w) coefficients in bitrev_n order → natural evaluations (twin of
    `ntt_from_bitrev_pallas`): `dit_cols_first` with one block and shift 1
    (its scales are all one: the reference's view, transpose, `dit_cols`
    over R and outer twiddle), then `dit_cols` over its C rows."""
    n, w = coeffs_brv.shape
    b = dit_cols_first(coeffs_brv, 0, 1)  # B[brv_C(i2), (k1, w)]
    return dit_cols(b, split(log2_strict(n))[1], False).reshape(n, w)  # flat k2·R + k1 = k


@functools.lru_cache(maxsize=None)
def shift_powers_brv(log_n: int, shift: int, device) -> torch.Tensor:
    """(2^log_n,) Montgomery shift^i at position brv_n(i), on `device`."""
    return geom_powers_mont_dev(shift, log_n, 1, device).index_select(0, bitrev_indices_dev(log_n, device))


def _nogather(evals: torch.Tensor, log_blowup: int, shift: int, inverse, forward) -> torch.Tensor:
    """The gather-free LDE around its two halves: `inverse` to bitrev_n
    coefficients, coefficient i times shift^i (the powers in bitrev_n
    order), the zero pad that puts bitrev_n position p at bitrev_N position
    p·blow, `forward` from bitrev_N order."""
    n, w = evals.shape
    log_n = log2_strict(n)
    coeffs_brv = inverse(evals)
    sp_brv = shift_powers_brv(log_n, shift % P, evals.device)
    padded = torch.zeros((n, 1 << log_blowup, w), dtype=torch.int32, device=evals.device)
    padded[:, 0, :] = fp_mul(coeffs_brv, sp_brv[:, None])
    return forward(padded.view(n << log_blowup, w))


def coset_lde_nogather_plain(evals: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    """`coset_lde_nogather` from the plain column transforms (below 2^4
    rows the plain radix-2 LDE, which equals the padded route)."""
    if log2_strict(evals.shape[0]) < 4:
        return coset_lde_batch(evals, log_blowup, shift)
    return _nogather(evals, log_blowup, shift, intt_to_bitrev_plain, ntt_from_bitrev_plain)


def coset_lde_nogather(evals: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    """Coset LDE with no row gather (twin of
    `coset_lde_batch_pallas_nogather`): `intt_to_bitrev`, the shift powers
    in bitrev_n order, the zero pad of the bit-reversed big domain, then
    `ntt_from_bitrev` over all blow·n rows (four launches). Below 2^4 rows
    it takes the padded route, as the reference does."""
    if log2_strict(evals.shape[0]) < 4:
        return coset_lde_padded(evals, log_blowup, shift)
    return _nogather(evals, log_blowup, shift, intt_to_bitrev, ntt_from_bitrev)
