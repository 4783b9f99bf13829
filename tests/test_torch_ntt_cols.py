"""The port's column NTTs and four-step LDE routes
(tapstark_torch.poly.cols_ntt) against the JAX package's Pallas routes
(tapstark/poly/pallas_ntt.py), word for word.

On the CPU `dit_cols`, `dit_cols_first`, `dif_cols` and `dif_cols_last`
run their plain versions; the JAX side runs K3 and K4 in Pallas interpret
mode, or the jitted plain LDE. The tables the column kernels multiply by
are held here too, applied as the kernels apply them, and so are the
kernels' own sources, built with g++ against stand-ins for the CUDA
built-ins. The CUDA kernels are held against the plain versions by the
`cuda`-marked tests (and by chip_smoke.py on the card). Exact equality
throughout: the words are integers.
"""

import ctypes
import pathlib
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tapstark.airs as jairs
from tapstark.challenger import BfChallenger as JBfChallenger
from tapstark.commit import BcManager as JBcManager
from tapstark.commit import TapTreeMmcs as JTapTreeMmcs
from tapstark.field import F as JF
from tapstark.field.constants import P
from tapstark.field.device import fp_mul as j_fp_mul
from tapstark.field.device import np_from_mont, np_to_mont
from tapstark.fri import FriConfig as JFriConfig
from tapstark.fri import TwoAdicFriPcs as JTwoAdicFriPcs
from tapstark.poly import pallas_ntt as jp
from tapstark.poly.ntt import coset_lde_batch_jit
from tapstark.stark import verify as j_verify
from tapstark.stark.serde import proof_from_bytes as j_proof_from_bytes
from tapstark_torch.airs import FibonacciAir, generate_fibonacci_trace
from tapstark_torch.challenger import BfChallenger
from tapstark_torch.field import F
from tapstark_torch.field.constants import MULT_GENERATOR
from tapstark_torch.field.device import fp_const, fp_mul
from tapstark_torch.interop import mont_np_from_tensor, pcs_from_reference, tensor_from_mont_np
from tapstark_torch.poly import cols_ntt, cuda_ntt, dit_tables
from tapstark_torch.poly.ntt import coset_lde_batch, coset_lde_batch_auto
from tapstark_torch.stark import prove, verify
from tapstark_torch.stark.serde import proof_from_bytes, proof_to_bytes
from tapstark_torch.utils import bitrev_indices

SHIFT = MULT_GENERATOR
CPU = torch.device("cpu")


def _mont(seed, rows, cols):
    rng = np.random.default_rng(seed)
    return np_to_mont(rng.integers(0, P, (rows, cols)).astype(np.uint32))


def _same(t, j):
    np.testing.assert_array_equal(mont_np_from_tensor(t), np.asarray(j))


@pytest.mark.parametrize("log_r", [1, 4, 7])
def test_shoup_twiddle_table_matches_jax(log_r):
    """The column kernels' stage pairs (both designs, both directions) are
    the TPU kernels' Shoup table, stage after stage."""
    for inverse in (False, True):
        packed = jp._packed_twiddles_shoup(log_r, inverse)
        want = np.concatenate([packed[:, s - 1, : 1 << (s - 1)].T for s in range(1, log_r + 1)])
        np.testing.assert_array_equal(dit_tables.dit_stage_pairs(log_r, inverse), want)


@pytest.mark.parametrize("log_r,log_c", [(2, 1), (3, 3), (4, 3)])
def test_outer_twiddles_match_jax(log_r, log_c):
    """The plain versions' outer twiddles, and the DIF last member's as its
    kernel forms them from its tables (hi[e >> h]·lo[e mod 2^h], e =
    brv_R(p1)·i2 mod n), against the JAX package's."""
    assert cols_ntt.split(log_r + log_c) == jp._split(log_r + log_c)
    t = dit_tables.last_member_tables(log_r, log_c, False)
    e = bitrev_indices(log_r).astype(np.uint64)[:, None] * np.arange(1 << log_c, dtype=np.uint64)[None, :]
    e %= np.uint64(1 << (log_r + log_c))
    hi, lo = np_from_mont(t["hi"]).astype(np.uint64), np_from_mont(t["lo"]).astype(np.uint64)
    tw = hi[e >> np.uint64(t["h"])] * lo[e & np.uint64((1 << t["h"]) - 1)] % np.uint64(P)
    want = np.asarray(jp._outer_twiddle_brv_rows(log_r, log_c, True))
    np.testing.assert_array_equal(np_to_mont(tw.astype(np.uint32)), want)
    assert t["c0"] == fp_const(1)
    assert dit_tables.last_member_tables(log_r, log_c, True)["c0"] == fp_const(pow(1 << (log_r + log_c), P - 2, P))
    for inverse in (False, True):
        _same(cols_ntt.outer_twiddle_mont(log_r, log_c, inverse, CPU), jp._outer_twiddle_mont(log_r, log_c, inverse))
        _same(
            cols_ntt.outer_twiddle_brv_rows(log_r, log_c, inverse, CPU),
            jp._outer_twiddle_brv_rows(log_r, log_c, inverse),
        )
        _same(
            cols_ntt.outer_twiddle_brv_cols(log_r, log_c, inverse, CPU),
            jp._outer_twiddle_brv_cols(log_r, log_c, inverse),
        )


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_r,b", [(3, 4), (5, 130)])
def test_cols_match_pallas_interpret(log_r, b, inverse):
    """`dit_cols` against K3 and `dif_cols` against K4, in interpret mode;
    130 lanes is no multiple of the TPU's 128-lane block."""
    x = _mont(10 + log_r, 1 << log_r, b)
    xt = tensor_from_mont_np(x, "cpu")
    _same(cols_ntt.dit_cols(xt, log_r, inverse), jp._ntt_cols_pallas(jnp.asarray(x), log_r, inverse))
    _same(cols_ntt.dif_cols(xt, log_r, inverse), jp._dif_cols_pallas(jnp.asarray(x), log_r, inverse))


@pytest.mark.parametrize("log_n", [5, 6])
def test_fourstep_transforms_match_pallas_interpret(log_n):
    """`ntt_cols_fourstep` both ways against `ntt_pallas`; the blocks
    route's halves against `intt_to_bitrev_pallas` (with the 1/n the route
    folds into its scale table, and the plain last member with its own 1/n
    after `dif_cols` over R, or alone on the one row of R = 1, as
    `lde_inverse` runs it at small sizes) and `ntt_from_bitrev_pallas`
    (`dit_cols_first` with one block and no shift, then `dit_cols`); the
    public halves `intt_to_bitrev` and `ntt_from_bitrev` and their plain
    versions against the same."""
    x = _mont(20 + log_n, 1 << log_n, 3)
    xt, xj = tensor_from_mont_np(x, "cpu"), jnp.asarray(x)
    for inverse in (False, True):
        _same(cols_ntt.ntt_cols_fourstep(xt, inverse), jp.ntt_pallas(xj, inverse))
    n_inv = fp_const(pow(1 << log_n, P - 2, P))
    want = jp.intt_to_bitrev_pallas(xj)
    _same(fp_mul(cols_ntt.intt_to_bitrev(xt, n_inv=False), n_inv), want)
    log_r, log_c = cols_ntt.split(log_n)
    a = cols_ntt.dif_cols_plain(xt.reshape(1 << log_r, 3 << log_c), log_r, True)
    _same(cols_ntt.dif_cols_last_plain(a, log_c, n_inv=True), want)
    _same(cols_ntt.dif_cols_last_plain(xt.reshape(1, 3 << log_n), log_n, n_inv=True), want)
    b = cols_ntt.dit_cols_first(xt, 0, 1)
    want = jp.ntt_from_bitrev_pallas(xj)
    _same(cols_ntt.dit_cols(b, cols_ntt.split(log_n)[1], False).reshape(1 << log_n, 3), want)
    _same(cols_ntt.ntt_from_bitrev(xt), want)
    _same(cols_ntt.ntt_from_bitrev_plain(xt), want)
    want = jp.intt_to_bitrev_pallas(xj)
    _same(cols_ntt.intt_to_bitrev(xt), want)
    _same(cols_ntt.intt_to_bitrev_plain(xt), want)
    np.testing.assert_array_equal(cols_ntt.bitrev_indices_np(log_n), jp.bitrev_indices_np(log_n))


def test_nogather_lde_matches_jax():
    """`coset_lde_nogather` and its plain version against the JAX package's
    plain LDE at 2^3 (the padded route), 2^4, 2^5 and 2^9 rows, odd and
    even splits, widths 1-3, blowups 1-4, and against `coset_lde_batch_auto`;
    at 2^5 rows also against `coset_lde_batch_pallas_nogather` (K3/K4 in
    interpret mode)."""
    for log_n, w, log_blowup in [(3, 2, 2), (4, 1, 4), (5, 3, 2), (9, 2, 1)]:
        x = _mont(90 + log_n, 1 << log_n, w)
        xt = tensor_from_mont_np(x, "cpu")
        want = coset_lde_batch_jit(jnp.asarray(x), log_blowup, SHIFT)
        got = cols_ntt.coset_lde_nogather(xt, log_blowup, SHIFT)
        _same(got, want)
        _same(cols_ntt.coset_lde_nogather_plain(xt, log_blowup, SHIFT), want)
        assert torch.equal(got, coset_lde_batch_auto(xt, log_blowup, SHIFT))
        if log_n == 5:
            _same(got, jp.coset_lde_batch_pallas_nogather(jnp.asarray(x), log_blowup, SHIFT))


@pytest.mark.parametrize("log_n,cases", [(4, [(2, 1), (4, 2)]), (5, [(2, 2), (4, 1)]), (7, [(2, 1), (4, 2)])])
def test_blocks_lde_matches_pallas_blocks_interpret(log_n, cases):
    """`coset_lde_blocks` (`dit_cols_first`, then `dit_cols`, for the
    forward half) against K3/K4's route, widths 2 and 4, blowups 2 and 4;
    odd log_n splits R = 2C."""
    for w, log_blowup in cases:
        x = _mont(30 + log_n + w, 1 << log_n, w)
        want = jp.coset_lde_batch_pallas_blocks(jnp.asarray(x), log_blowup, SHIFT)
        _same(cols_ntt.coset_lde_blocks(tensor_from_mont_np(x, "cpu"), log_blowup, SHIFT), want)


def test_first_member_plain_matches_unfused_jax_composition():
    """`dit_cols_first` (its plain version on the CPU) against the forward
    half's glue as the reference runs it: block scales, transpose, K3 in
    interpret mode, outer twiddle, transpose; with and without 1/n, at an
    odd and an even log_n."""
    for log_n, w, log_blowup in [(5, 2, 2), (8, 4, 1)]:
        x = _mont(70 + log_n, 1 << log_n, w)
        log_r, log_c = jp._split(log_n)
        r, c, width = 1 << log_r, 1 << log_c, w << log_blowup
        scales = jnp.asarray(jp._block_scales(log_n, log_blowup, SHIFT % P))
        scaled = j_fp_mul(jnp.asarray(x)[:, None, :], scales.T[:, :, None])
        m = jnp.swapaxes(scaled.reshape(c, r, width), 0, 1).reshape(r, c * width)
        a = jp._ntt_cols_pallas(m, log_r, inverse=False)
        tw = jnp.asarray(jp._outer_twiddle_brv_cols(log_r, log_c, False))
        want = jnp.swapaxes(j_fp_mul(a.reshape(r, c, width), tw[:, :, None]), 0, 1).reshape(c, r * width)
        xt = tensor_from_mont_np(x, "cpu")
        _same(cols_ntt.dit_cols_first(xt, log_blowup, SHIFT), want)
        n_inv = int(np_to_mont(np.array([pow(1 << log_n, P - 2, P)], np.uint32))[0])
        _same(cols_ntt.dit_cols_first(xt, log_blowup, SHIFT, n_inv=True), j_fp_mul(want, jnp.uint32(n_inv)))


def _emulate_first_member(x, log_r, log_c, log_blowup, n_inv):
    """`dit_first_kernel`'s arithmetic on the host, from the tables it is
    given: x (n, w) Montgomery in bitrev_n order scaled by s1[rb, p1], the
    R-point DIT (`dit_cols_plain`), then times s2[rb, p2] and the outer
    twiddle hi[e >> h]·lo[e mod 2^h], e = k1·brv_C(p2) mod n; (C, R·blow·w)
    out."""
    t = dit_tables.first_member_tables(log_r, log_c, log_blowup, SHIFT, n_inv)
    pair = t["s1"].astype(np.uint64)
    np.testing.assert_array_equal(pair[..., 1], (pair[..., 0] << np.uint64(32)) // np.uint64(P))
    n, w = x.shape
    r, c, width = 1 << log_r, 1 << log_c, w << log_blowup
    s1, s2 = pair[..., 0], np_from_mont(t["s2"]).astype(np.uint64)
    v = np_from_mont(x).astype(np.uint64).reshape(c, r, 1, w) * s1.T[None, :, :, None] % P  # [p2, p1, rb, c]
    m = np_to_mont(v.astype(np.uint32).transpose(1, 0, 2, 3).reshape(r, c * width))
    a = np_from_mont(mont_np_from_tensor(cols_ntt.dit_cols_plain(tensor_from_mont_np(m, "cpu"), log_r, False)))
    e = (np.arange(r, dtype=np.uint64)[:, None] * bitrev_indices(log_c).astype(np.uint64)[None, :]) % np.uint64(n)
    h = np.uint64(t["h"])
    hi, lo = np_from_mont(t["hi"]).astype(np.uint64), np_from_mont(t["lo"]).astype(np.uint64)
    tw = hi[e >> h] * lo[e & ((np.uint64(1) << h) - np.uint64(1))] % P
    out = a.astype(np.uint64).reshape(r, c, 1 << log_blowup, w) * tw[:, :, None, None] % P
    out = out * s2.T[None, :, :, None] % P
    return np_to_mont(out.astype(np.uint32).transpose(1, 0, 2, 3).reshape(c, r * width))


def test_kernel_tables_reproduce_both_forward_first_members():
    """The DIT kernels' tables, applied as the kernels apply them (the
    stage pairs are held in `test_shoup_twiddle_table_matches_jax`): the
    first-member tables give `dit_cols_first` (blocks route, with 1/n)
    and, at `forward_split` and with the second member, `lde_forward`
    (K2)."""
    for log_n, w, log_blowup in [(4, 2, 2), (7, 3, 1), (9, 4, 2)]:
        x = _mont(80 + log_n, 1 << log_n, w)
        log_r, log_c = cols_ntt.split(log_n)
        want = cols_ntt.dit_cols_first(tensor_from_mont_np(x, "cpu"), log_blowup, SHIFT, n_inv=True)
        _same(want, _emulate_first_member(x, log_r, log_c, log_blowup, True))
    for log_n, w, log_blowup in [(5, 2, 2), (13, 2, 2), (14, 3, 1)]:
        coeffs = _mont(90 + log_n, w, 1 << log_n)
        log_r, log_c = cuda_ntt.forward_split(log_n)
        b = tensor_from_mont_np(_emulate_first_member(coeffs.T.copy(), log_r, log_c, log_blowup, False), "cpu")
        got = cols_ntt.dit_cols_plain(b, log_c, False).reshape(-1, w)
        _same(got, mont_np_from_tensor(cuda_ntt.lde_forward_plain(tensor_from_mont_np(coeffs, "cpu"), log_blowup, SHIFT)))


def _host_dit_library(tmp_path):
    """csrc/dit_cols.cuh and dif_cols.cuh built with g++ against
    tests/cuda_host_shim."""
    here = pathlib.Path(__file__).parent
    shim, csrc = here / "cuda_host_shim", here.parent / "tapstark_torch" / "csrc"
    so = tmp_path / "libdit_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{shim}", f"-I{csrc}", "-o", str(so),
                    str(shim / "dit_host.cpp"), "-lpthread"], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_dit_cols.argtypes = [ptr, ptr, ptr, i32, i64]
    lib.host_dit_first.argtypes = [ptr, i64, i64, *[ptr] * 6, *[i32] * 5]
    lib.host_dif_cols.argtypes = [ptr, ptr, ptr, i32, i64, i32]
    lib.host_dif_last.argtypes = [ptr, ptr, i64, i64, ptr, ptr, ptr, ctypes.c_uint32, *[i32] * 4]
    return lib


def test_dit_kernels_on_a_host_shim_match_plain(tmp_path):
    """The column kernels' own sources (`csrc/dit_cols.cuh` and its DIF
    twin `dif_cols.cuh`), compiled with g++ against stand-ins for the CUDA
    built-ins (a std::thread per CUDA thread, a std::barrier for
    `__syncthreads`), against the plain versions. DIT: the column form
    both ways (ragged lane counts, one to three passes), the first member
    with its tables, and `lde_forward`'s pair at its `forward_split` (one
    launch and two). DIF: the column form both ways (the same, and at
    lane counts whose full tiles would not fill a card of 132 SMs), the
    last member in both layouts with and without 1/n, and `lde_inverse`'s
    pair at its `inverse_split` (one launch and two). This holds the
    kernels' index math and tables here; chip_smoke.py holds them on the
    card."""
    lib = _host_dit_library(tmp_path)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    def cols(x, log_r, inverse):
        tw = np.ascontiguousarray(dit_tables.dit_stage_pairs(log_r, inverse))
        out = np.zeros_like(x)
        assert lib.host_dit_cols(ptr(x), ptr(out), ptr(tw), log_r, x.shape[1]) == 0
        return out

    def first(x, x_row, x_col, w, log_r, log_c, log_blowup, n_inv):
        tw = np.ascontiguousarray(dit_tables.dit_stage_pairs(log_r, False))
        t = dit_tables.first_member_tables(log_r, log_c, log_blowup, SHIFT, n_inv)
        s1, s2, hi, lo = (np.ascontiguousarray(t[k]) for k in ("s1", "s2", "hi", "lo"))
        out = np.zeros((1 << log_c, (w << log_blowup) << log_r), np.uint32)
        assert lib.host_dit_first(ptr(x), x_row, x_col, ptr(out), ptr(tw), ptr(s1), ptr(s2), ptr(hi), ptr(lo),
                                  log_r, log_c, t["h"], log_blowup, w) == 0
        return out

    for log_r, b in [(1, 3), (4, 5), (6, 8), (9, 40), (11, 12)]:
        x = _mont(100 + log_r, 1 << log_r, b)
        for inverse in (False, True):
            _same(cols_ntt.dit_cols_plain(tensor_from_mont_np(x, "cpu"), log_r, inverse), cols(x, log_r, inverse))
    for log_n, w, log_blowup, n_inv in [(4, 2, 2, True), (7, 3, 1, False), (12, 2, 2, True)]:
        x = _mont(110 + log_n, 1 << log_n, w)
        log_r, log_c = cols_ntt.split(log_n)
        b = first(x, w, 1, w, log_r, log_c, log_blowup, n_inv)
        _same(cols_ntt.dit_cols_first_plain(tensor_from_mont_np(x, "cpu"), log_blowup, SHIFT, n_inv), b)
        _same(cols_ntt.dit_cols_plain(tensor_from_mont_np(b, "cpu"), log_c, False), cols(b, log_c, False))
    for log_n, w, log_blowup in [(3, 2, 2), (12, 2, 2), (13, 3, 1)]:
        coeffs = _mont(120 + log_n, w, 1 << log_n)
        log_r, log_c = cuda_ntt.forward_split(log_n)
        b = first(coeffs, 1, 1 << log_n, w, log_r, log_c, log_blowup, False)
        got = cols(b, log_c, False) if log_c else b
        want = cuda_ntt.lde_forward_plain(tensor_from_mont_np(coeffs, "cpu"), log_blowup, SHIFT)
        _same(want, got.reshape(-1, w))

    def dif(x, log_r, inverse, sms=132):
        tw = np.ascontiguousarray(dit_tables.dit_stage_pairs(log_r, inverse))
        out = np.zeros_like(x)
        assert lib.host_dif_cols(ptr(x), ptr(out), ptr(tw), log_r, x.shape[1], sms) == 0
        return out

    def last(a, out, out_row, out_col, w, log_r, log_c, n_inv):
        tw = np.ascontiguousarray(dit_tables.dit_stage_pairs(log_c, True))
        t = dit_tables.last_member_tables(log_r, log_c, n_inv)
        hi, lo = np.ascontiguousarray(t["hi"]), np.ascontiguousarray(t["lo"])
        assert lib.host_dif_last(ptr(a), ptr(out), out_row, out_col, ptr(tw), ptr(hi), ptr(lo), t["c0"],
                                 log_r, log_c, t["h"], w) == 0
        return out

    for log_r, b in [(1, 3), (4, 5), (6, 8), (9, 40), (11, 12), (5, 1000)]:
        x = _mont(130 + log_r, 1 << log_r, b)
        for inverse in (False, True):
            _same(cols_ntt.dif_cols_plain(tensor_from_mont_np(x, "cpu"), log_r, inverse), dif(x, log_r, inverse))
    for log_n, w, n_inv in [(4, 2, True), (7, 3, False), (12, 2, True), (13, 5, False)]:
        x = _mont(140 + log_n, 1 << log_n, w)
        log_r, log_c = cols_ntt.split(log_n)
        a = dif(x.reshape(1 << log_r, w << log_c), log_r, True)
        _same(cols_ntt.dif_cols_plain(tensor_from_mont_np(x.reshape(1 << log_r, -1), "cpu"), log_r, True), a)
        want = cols_ntt.dif_cols_last_plain(tensor_from_mont_np(a, "cpu"), log_c, n_inv)
        _same(want, last(a, np.zeros((1 << log_n, w), np.uint32), w, 1, w, log_r, log_c, n_inv))
        _same(want.T, last(a, np.zeros((w, 1 << log_n), np.uint32), 1, 1 << log_n, w, log_r, log_c, n_inv))
    for log_n, w in [(3, 2), (11, 3), (12, 2), (13, 4)]:
        x = _mont(150 + log_n, 1 << log_n, w)
        log_r, log_c = cuda_ntt.inverse_split(log_n)
        a = dif(x.reshape(1 << log_r, w << log_c), log_r, True) if log_r else x
        got = last(a, np.zeros((w, 1 << log_n), np.uint32), 1, 1 << log_n, w, log_r, log_c, True)
        _same(cuda_ntt.lde_inverse_plain(tensor_from_mont_np(x, "cpu")), got)


def test_blocks_forward_half_is_the_two_dit_launches(monkeypatch):
    """`coset_lde_blocks` is four launches and no op between or after them:
    `dif_cols` over the evaluations' natural (R, C·w) view, the DIF last
    member, then the forward half's two `dit_cols` calls; each takes the
    previous one's output object, and the route returns a view of the
    last one's."""
    calls = []

    def recorder(name, fn):
        def rec(x, *args, **kw):
            calls.append((name, x, fn(x, *args, **kw)))
            return calls[-1][2]

        return rec

    for name in ("dif_cols", "dif_cols_last", "dit_cols_first", "dit_cols"):
        monkeypatch.setattr(cols_ntt, name, recorder(name, getattr(cols_ntt, name)))
    evals = tensor_from_mont_np(_mont(33, 1 << 6, 2), "cpu")
    out = cols_ntt.coset_lde_blocks(evals, 2, SHIFT)
    assert [c[0] for c in calls] == ["dif_cols", "dif_cols_last", "dit_cols_first", "dit_cols"]
    assert calls[0][1].data_ptr() == evals.data_ptr() and calls[0][1].shape == (1 << 3, 2 << 3)
    for prev, cur in zip(calls, calls[1:]):
        assert cur[1] is prev[2]
    assert out.data_ptr() == calls[-1][2].data_ptr() and out.shape == (1 << 8, 2)


@pytest.mark.parametrize("log_n", [3, 5, 7, 9])
def test_lde_routes_match_jax(log_n):
    """The blocks and padded routes, and the dispatch, against the JAX
    plain LDE (width 3, blowups 2 and 4). log_n 3 takes the padded route
    inside `coset_lde_blocks`; log_n 9 goes to the fused halves in
    `coset_lde_batch_auto`."""
    x = _mont(40 + log_n, 1 << log_n, 3)
    xt = tensor_from_mont_np(x, "cpu")
    for log_blowup in (1, 2):
        want = np.asarray(coset_lde_batch_jit(jnp.asarray(x), log_blowup, SHIFT))
        _same(cols_ntt.coset_lde_blocks(xt, log_blowup, SHIFT), want)
        _same(cols_ntt.coset_lde_padded(xt, log_blowup, SHIFT), want)
        _same(coset_lde_batch_auto(xt, log_blowup, SHIFT), want)


@pytest.mark.parametrize("log_n,route", [(3, "blocks"), (7, "blocks"), (8, "fused"), (21, "fused"), (22, "blocks")])
def test_dispatch_routes_by_log_n(log_n, route, monkeypatch):
    """`coset_lde_batch_auto` picks the route by log_n alone (the JAX
    package's `coset_lde_batch_pallas_fused` split), on any device."""
    taken = []
    monkeypatch.setattr(cuda_ntt, "coset_lde_batch_cuda", lambda *a: taken.append("fused"))
    monkeypatch.setattr(cols_ntt, "coset_lde_blocks", lambda *a: taken.append("blocks"))
    coset_lde_batch_auto(torch.zeros((1 << log_n, 1), dtype=torch.int32), 2, SHIFT)
    assert taken == [route]


def test_cols_raise_off_cpu_and_cuda_and_on_bad_shapes():
    meta = torch.empty((8, 4), dtype=torch.int32, device="meta")
    for fn in (cols_ntt.dit_cols, cols_ntt.dif_cols):
        with pytest.raises(ValueError):
            fn(meta, 3, False)
        with pytest.raises(ValueError):
            fn(torch.zeros((8, 4), dtype=torch.int32), 2, False)
    with pytest.raises(ValueError):
        cols_ntt.coset_lde_blocks(torch.empty((32, 2), dtype=torch.int32, device="meta"), 2, SHIFT)


def test_fibonacci_2_5_prove_on_blocks_route_verifies_in_jax_package():
    """A 2^5-row Fibonacci proof (both LDEs on the blocks route, 4 queries):
    the port verifies it, and so does the JAX package through its serde."""
    nq = 4
    fri = JFriConfig(log_blowup=2, num_queries=nq, proof_of_work_bits=8, mmcs=JTapTreeMmcs(JBcManager(), nq, ext=True))
    ref_pcs = JTwoAdicFriPcs(JTapTreeMmcs(JBcManager(), nq, ext=False), fri)
    pcs = pcs_from_reference(ref_pcs, CPU)
    trace = generate_fibonacci_trace(0, 1, 1 << 5)
    pis = [F(0), F(1), F(int(trace[-1, 1]))]
    before = dict(cols_ntt.launches)
    proof = prove(pcs, FibonacciAir(), BfChallenger(), trace, pis)
    assert cols_ntt.launches == before  # plain versions on the CPU
    data = proof_to_bytes(proof)
    verify(pcs, FibonacciAir(), BfChallenger(), proof_from_bytes(data), pis)
    j_verify(ref_pcs, jairs.FibonacciAir(), JBfChallenger(), j_proof_from_bytes(data), [JF(p.v) for p in pis])


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_cols_match_plain():
    """Both directions at (log R, B) = (2, 4), (3, 4), (11, 4096), (12,
    3000), (14, 5), (9, 4096) (narrowed tiles), then the DIF last member
    over the column form's output at the 2^22 prove's shapes (widths 2 and
    4) and at an odd log_n of width 3, with and without 1/n; the DIT first
    member at the same shapes; the blocks, padded and gather-free LDE
    routes against the plain LDE, and the gather-free route's halves
    against their plain versions. One test, not many cases: see ROADMAP.md on how the
    suite's item count places the slow pre-port tests in the parallel
    run."""
    dev = _cuda()
    for log_r, b in [(2, 4), (3, 4), (11, 4096), (12, 3000), (14, 5), (9, 4096)]:
        x = tensor_from_mont_np(_mont(50 + log_r, 1 << log_r, b), dev)
        for inverse in (False, True):
            before = dict(cols_ntt.launches)
            assert torch.equal(cols_ntt.dit_cols(x, log_r, inverse), cols_ntt.dit_cols_plain(x, log_r, inverse))
            assert torch.equal(cols_ntt.dif_cols(x, log_r, inverse), cols_ntt.dif_cols_plain(x, log_r, inverse))
            assert cols_ntt.launches == {**before, "dit_cols": before["dit_cols"] + 1,
                                         "dit_cols.cols": before["dit_cols.cols"] + 1,
                                         "dif_cols": before["dif_cols"] + 1,
                                         "dif_cols.cols": before["dif_cols.cols"] + 1}
    for log_n, w, n_inv in [(22, 2, False), (22, 4, True), (7, 3, True)]:
        log_r, log_c = cols_ntt.split(log_n)
        x = tensor_from_mont_np(_mont(70 + w, 1 << log_n, w), dev)
        a = cols_ntt.dif_cols(x.view(1 << log_r, w << log_c), log_r, True)
        before = dict(cols_ntt.launches)
        got = cols_ntt.dif_cols_last(a, log_c, n_inv)
        assert torch.equal(got, cols_ntt.dif_cols_last_plain(a, log_c, n_inv))
        assert cols_ntt.launches == {**before, "dif_cols": before["dif_cols"] + 1,
                                     "dif_cols.last": before["dif_cols.last"] + 1}
        del x, a, got
    with pytest.raises(ValueError):
        cols_ntt.dit_cols(torch.zeros((1 << 15, 1), dtype=torch.int32, device=dev), 15, False)

    # the first member at the 2^22 prove's shapes (widths 2 and 4, blowup
    # 4, with 1/n, then the second member over its output) and at an odd
    # log_n of width 3
    for log_n, w, log_blowup, n_inv in [(22, 2, 2, True), (22, 4, 2, True), (7, 3, 1, False)]:
        x = tensor_from_mont_np(_mont(60 + w, 1 << log_n, w), dev)
        before = dict(cols_ntt.launches)
        b = cols_ntt.dit_cols_first(x, log_blowup, SHIFT, n_inv)
        assert torch.equal(b, cols_ntt.dit_cols_first_plain(x, log_blowup, SHIFT, n_inv))
        assert cols_ntt.launches == {**before, "dit_cols": before["dit_cols"] + 1,
                                     "dit_cols.first": before["dit_cols.first"] + 1}
        log_c = cols_ntt.split(log_n)[1]
        assert torch.equal(cols_ntt.dit_cols(b, log_c, False), cols_ntt.dit_cols_plain(b, log_c, False))
        del x, b

    # the blocks, padded and gather-free routes against the plain radix-2 LDE
    for log_n, w, log_blowup in [(3, 2, 2), (5, 3, 1), (12, 2, 2)]:
        x = tensor_from_mont_np(_mont(60 + log_n, 1 << log_n, w), dev)
        want = coset_lde_batch(x, log_blowup, SHIFT)
        assert torch.equal(cols_ntt.coset_lde_blocks(x, log_blowup, SHIFT), want)
        assert torch.equal(cols_ntt.coset_lde_padded(x, log_blowup, SHIFT), want)
        assert torch.equal(cols_ntt.coset_lde_nogather(x, log_blowup, SHIFT), want)
        assert torch.equal(cols_ntt.coset_lde_nogather_plain(x, log_blowup, SHIFT), want)
        assert torch.equal(cols_ntt.intt_to_bitrev(x), cols_ntt.intt_to_bitrev_plain(x))
        assert torch.equal(cols_ntt.ntt_from_bitrev(x), cols_ntt.ntt_from_bitrev_plain(x))
