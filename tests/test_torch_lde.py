"""The port's NTT and coset LDE (tapstark_torch.poly.ntt, poly.cuda_ntt)
against the JAX package's, word for word.

On the CPU the LDE wrappers run their plain versions; the CUDA kernels are
held against those plain versions by the `cuda`-marked test (and by
chip_smoke.py on the card). Exact equality throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapstark.field.constants import P
from tapstark.field.device import np_to_mont
from tapstark.poly.ntt import bit_reverse_rows as j_bit_reverse_rows
from tapstark.poly.ntt import coset_lde_batch_jit, intt_jit, ntt_jit
from tapstark.poly.pallas_ntt import _block_scales, coset_lde_batch_pallas_fused
from tapstark_torch.field.constants import MULT_GENERATOR
from tapstark_torch.interop import mont_np_from_tensor, tensor_from_mont_np
from tapstark_torch.poly import cols_ntt, cuda_ntt
from tapstark_torch.poly.ntt import (
    bit_reverse_rows,
    coset_lde_batch,
    coset_lde_batch_auto,
    intt,
    ntt,
)

SHIFT = MULT_GENERATOR


def _evals(seed, log_n, w):
    rng = np.random.default_rng(seed)
    return np_to_mont(rng.integers(0, P, (1 << log_n, w)).astype(np.uint32))


@pytest.mark.parametrize("log_ns", [(3, 4), (5, 6), (7, 8), (9, 10), (11, 12)])
def test_plain_lde_matches_jax(log_ns):
    """At each of the two heights, `_lde_matches_jax` (two heights an item:
    the ten heights 2^3 .. 2^12 in five items)."""
    for log_n in log_ns:
        _lde_matches_jax(log_n)


def _lde_matches_jax(log_n):
    """Widths 1, 2, 4 and blowups 2, 4 against one JAX LDE of width 4 at
    blowup 4: columns are independent, and the blowup-2 coset is every
    second point of the blowup-4 one (shift·w_2n^k = shift·w_4n^2k). At
    2^5 rows also the wide row's width 163 at blowup 16."""
    x = _evals(log_n, log_n, 4)
    ref = np.asarray(coset_lde_batch_jit(jnp.asarray(x), 2, SHIFT))
    for w in (1, 2, 4):
        xt = tensor_from_mont_np(x[:, :w], "cpu")
        for log_blowup, rows in ((2, slice(None)), (1, slice(None, None, 2))):
            want = ref[rows, :w]
            np.testing.assert_array_equal(mont_np_from_tensor(coset_lde_batch(xt, log_blowup, SHIFT)), want)
            halves = cuda_ntt.lde_forward(cuda_ntt.lde_inverse(xt), log_blowup, SHIFT)
            np.testing.assert_array_equal(mont_np_from_tensor(halves), want)
            np.testing.assert_array_equal(
                mont_np_from_tensor(coset_lde_batch_auto(xt, log_blowup, SHIFT)), want
            )
    if log_n == 5:
        x = _evals(163, log_n, 163)
        want = np.asarray(coset_lde_batch_jit(jnp.asarray(x), 4, SHIFT))
        xt = tensor_from_mont_np(x, "cpu")
        halves = cuda_ntt.lde_forward(cuda_ntt.lde_inverse(xt), 4, SHIFT)
        np.testing.assert_array_equal(mont_np_from_tensor(halves), want)
        np.testing.assert_array_equal(mont_np_from_tensor(coset_lde_batch_auto(xt, 4, SHIFT)), want)


@pytest.mark.parametrize("log_n,log_blowup,w", [(8, 2, 3), (9, 1, 2)])
def test_plain_lde_matches_pallas_fused_interpret(log_n, log_blowup, w):
    """The TPU kernels K1+K2, run in Pallas interpret mode on the CPU."""
    x = _evals(100 + log_n, log_n, w)
    want = np.asarray(coset_lde_batch_pallas_fused(jnp.asarray(x), log_blowup, SHIFT))
    got = coset_lde_batch(tensor_from_mont_np(x, "cpu"), log_blowup, SHIFT)
    np.testing.assert_array_equal(mont_np_from_tensor(got), want)


@pytest.mark.parametrize("log_n", [1, 6])
def test_ntt_intt_match_jax(log_n):
    x = _evals(200 + log_n, log_n, 3)
    xt = tensor_from_mont_np(x, "cpu")
    np.testing.assert_array_equal(mont_np_from_tensor(ntt(xt)), np.asarray(ntt_jit(jnp.asarray(x))))
    np.testing.assert_array_equal(mont_np_from_tensor(intt(xt)), np.asarray(intt_jit(jnp.asarray(x))))


@pytest.mark.parametrize("log_n", [1, 4, 11])
def test_bit_reverse_rows_matches_jax(log_n):
    x = _evals(300 + log_n, log_n, 2)
    np.testing.assert_array_equal(
        mont_np_from_tensor(bit_reverse_rows(tensor_from_mont_np(x, "cpu"))),
        np.asarray(j_bit_reverse_rows(jnp.asarray(x))),
    )


@pytest.mark.parametrize("log_n,log_blowup", [(3, 2), (9, 1)])
def test_kernel_block_scales_match_jax(log_n, log_blowup):
    """The block scales (of the first member's plain version) are the TPU
    path's `_block_scales`."""
    got = cuda_ntt.block_scales(log_n, log_blowup, SHIFT, torch.device("cpu"))
    np.testing.assert_array_equal(mont_np_from_tensor(got), _block_scales(log_n, log_blowup, SHIFT))


def test_lde_entry_points_raise_off_cpu_and_cuda():
    x = torch.empty((8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        cuda_ntt.lde_inverse(x)
    with pytest.raises(ValueError):
        cuda_ntt.lde_forward(x.T, 2, SHIFT)
    with pytest.raises(ValueError):
        coset_lde_batch_auto(x, 2, SHIFT)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Both halves at (log_n, w, log_blowup) = (3, 2, 2), (11, 3, 1), (20,
    2, 2), (20, 4, 2) (the north star's trace and quotient shapes), (5,
    163, 4), (18, 163, 4), (18, 4, 4) (the wide row's: blowup 16), with the
    launches each counts, its own and the DIF or DIT kernels' it runs on;
    one test, not many cases: see ROADMAP.md on how the suite's item count
    places the slow pre-port tests in the parallel run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for log_n, w, log_blowup in [(3, 2, 2), (11, 3, 1), (20, 2, 2), (20, 4, 2), (5, 163, 4), (18, 163, 4),
                                 (18, 4, 4)]:
        x = tensor_from_mont_np(_evals(400 + log_n, log_n, w), "cuda")
        before, before_dit = dict(cuda_ntt.launches), dict(cols_ntt.launches)
        coeffs = cuda_ntt.lde_inverse(x)
        assert torch.equal(coeffs, cuda_ntt.lde_inverse_plain(x))
        out = cuda_ntt.lde_forward(coeffs, log_blowup, SHIFT)
        assert torch.equal(out, cuda_ntt.lde_forward_plain(coeffs, log_blowup, SHIFT))
        assert torch.equal(out, coset_lde_batch(x, log_blowup, SHIFT))
        assert cuda_ntt.launches["lde_inverse"] == before["lde_inverse"] + 1
        assert cuda_ntt.launches["lde_forward"] == before["lde_forward"] + 1
        # lde_inverse runs on the two DIF kernels and lde_forward on the two
        # DIT kernels (the last or the first member alone up to 2^11 rows)
        two = cuda_ntt.forward_split(log_n)[1] > 0
        assert cuda_ntt.inverse_split(log_n)[0] == cuda_ntt.forward_split(log_n)[1]
        assert cols_ntt.launches == {**before_dit, "dit_cols.first": before_dit["dit_cols.first"] + 1,
                                     "dit_cols.cols": before_dit["dit_cols.cols"] + two,
                                     "dif_cols.last": before_dit["dif_cols.last"] + 1,
                                     "dif_cols.cols": before_dit["dif_cols.cols"] + two}
