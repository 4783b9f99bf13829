"""The port's column NTTs and four-step LDE routes
(tapstark_torch.poly.cols_ntt) against the JAX package's Pallas routes
(tapstark/poly/pallas_ntt.py), word for word.

On the CPU `dit_cols` and `dif_cols` run their plain versions; the JAX
side runs K3 and K4 in Pallas interpret mode, or the jitted plain LDE.
The CUDA kernels are held against the plain versions by the
`cuda`-marked tests (and by chip_smoke.py on the card). Exact equality
throughout: the words are integers.
"""

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
from tapstark.field.device import np_to_mont
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
from tapstark_torch.interop import mont_np_from_tensor, pcs_from_reference, tensor_from_mont_np
from tapstark_torch.poly import cols_ntt, cuda_ntt
from tapstark_torch.poly.ntt import coset_lde_batch, coset_lde_batch_auto
from tapstark_torch.stark import prove, verify
from tapstark_torch.stark.serde import proof_from_bytes, proof_to_bytes

SHIFT = MULT_GENERATOR
CPU = torch.device("cpu")


def _mont(seed, rows, cols):
    rng = np.random.default_rng(seed)
    return np_to_mont(rng.integers(0, P, (rows, cols)).astype(np.uint32))


def _same(t, j):
    np.testing.assert_array_equal(mont_np_from_tensor(t), np.asarray(j))


@pytest.mark.parametrize("log_r", [1, 4, 7])
def test_shoup_twiddle_table_matches_jax(log_r):
    for inverse in (False, True):
        np.testing.assert_array_equal(
            cols_ntt.packed_twiddles_shoup(log_r, inverse), jp._packed_twiddles_shoup(log_r, inverse)
        )


@pytest.mark.parametrize("log_r,log_c", [(2, 1), (3, 3), (4, 3)])
def test_outer_twiddles_match_jax(log_r, log_c):
    assert cols_ntt.split(log_r + log_c) == jp._split(log_r + log_c)
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
    xt = tensor_from_mont_np(x)
    _same(cols_ntt.dit_cols(xt, log_r, inverse), jp._ntt_cols_pallas(jnp.asarray(x), log_r, inverse))
    _same(cols_ntt.dif_cols(xt, log_r, inverse), jp._dif_cols_pallas(jnp.asarray(x), log_r, inverse))


@pytest.mark.parametrize("log_n", [5, 6])
def test_fourstep_transforms_match_pallas_interpret(log_n):
    """`ntt_cols_fourstep` both ways, `intt_to_bitrev` and
    `ntt_from_bitrev` against their `*_pallas` twins."""
    x = _mont(20 + log_n, 1 << log_n, 3)
    xt, xj = tensor_from_mont_np(x), jnp.asarray(x)
    for inverse in (False, True):
        _same(cols_ntt.ntt_cols_fourstep(xt, inverse), jp.ntt_pallas(xj, inverse))
    _same(cols_ntt.intt_to_bitrev(xt), jp.intt_to_bitrev_pallas(xj))
    _same(cols_ntt.ntt_from_bitrev(xt), jp.ntt_from_bitrev_pallas(xj))


def test_blocks_lde_matches_pallas_blocks_interpret():
    x = _mont(30, 1 << 5, 2)
    want = jp.coset_lde_batch_pallas_blocks(jnp.asarray(x), 2, SHIFT)
    _same(cols_ntt.coset_lde_blocks(tensor_from_mont_np(x), 2, SHIFT), want)


@pytest.mark.parametrize("log_n", [3, 5, 7, 9])
def test_lde_routes_match_jax(log_n):
    """The blocks and padded routes, and the dispatch, against the JAX
    plain LDE (width 3, blowups 2 and 4). log_n 3 takes the padded route
    inside `coset_lde_blocks`; log_n 9 goes to the fused halves in
    `coset_lde_batch_auto`."""
    x = _mont(40 + log_n, 1 << log_n, 3)
    xt = tensor_from_mont_np(x)
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
@pytest.mark.parametrize("log_r,b", [(2, 4), (3, 4), (11, 4096), (12, 3000), (14, 5)])
def test_cuda_cols_match_plain(log_r, b):
    dev = _cuda()
    x = tensor_from_mont_np(_mont(50 + log_r, 1 << log_r, b), dev)
    for inverse in (False, True):
        before = dict(cols_ntt.launches)
        assert torch.equal(cols_ntt.dit_cols(x, log_r, inverse), cols_ntt.dit_cols_plain(x, log_r, inverse))
        assert torch.equal(cols_ntt.dif_cols(x, log_r, inverse), cols_ntt.dif_cols_plain(x, log_r, inverse))
        assert cols_ntt.launches == {k: v + 1 for k, v in before.items()}
    with pytest.raises(ValueError):
        cols_ntt.dit_cols(torch.zeros((1 << 15, 1), dtype=torch.int32, device=dev), 15, False)


@pytest.mark.cuda
def test_cuda_lde_routes_match():
    """The blocks and padded routes on the card against the fused one, at
    (log_n, w, log_blowup) = (3, 2, 2), (5, 3, 1) and (12, 2, 2). One test,
    not three cases: see ROADMAP.md on how the suite's item count places
    the slow pre-port tests in the parallel run."""
    dev = _cuda()
    for log_n, w, log_blowup in [(3, 2, 2), (5, 3, 1), (12, 2, 2)]:
        x = tensor_from_mont_np(_mont(60 + log_n, 1 << log_n, w), dev)
        want = coset_lde_batch(x, log_blowup, SHIFT)
        assert torch.equal(cols_ntt.coset_lde_blocks(x, log_blowup, SHIFT), want)
        assert torch.equal(cols_ntt.coset_lde_padded(x, log_blowup, SHIFT), want)
