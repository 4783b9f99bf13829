"""The port's limb-matmul NTT (tapstark_torch.poly.matmul_ntt) against the
JAX package's (tapstark/poly/matmul_ntt.py), word for word.

On the CPU `mod_matmul` runs its plain version (limb dots in float64);
the JAX side runs K7 (`mod_matmul_fused`) in Pallas interpret mode, or
its unfused XLA route. The CUDA kernel is held against the plain version
by the `cuda`-marked test (and by chip_smoke.py on the card). Exact
equality throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapstark.field.constants import P
from tapstark.field.device import np_to_mont
from tapstark.poly import matmul_ntt as jm
from tapstark_torch.field.constants import MULT_GENERATOR
from tapstark_torch.interop import mont_np_from_tensor, tensor_from_mont_np
from tapstark_torch.poly import matmul_ntt as mm
from tapstark_torch.poly.ntt import coset_lde_batch

SHIFT = MULT_GENERATOR


def _canon(seed, rows, cols):
    return np.random.default_rng(seed).integers(0, P, (rows, cols)).astype(np.uint32)


def _same(t, j):
    np.testing.assert_array_equal(mont_np_from_tensor(t), np.asarray(j))


@pytest.mark.parametrize("log_r", [0, 3, 7])
def test_tables_match_jax(log_r):
    for inverse in (False, True):
        np.testing.assert_array_equal(mm.w_matrix_limbs(log_r, inverse), jm._w_matrix_limbs(log_r, inverse))
        np.testing.assert_array_equal(
            mm.outer_twiddle_rep(log_r, 2, 3, inverse), jm._outer_twiddle_rep(log_r, 2, 3, inverse)
        )
    np.testing.assert_array_equal(mm.shift_consts_mont(), jm._shift_consts_mont())
    np.testing.assert_array_equal(mm.block_scale_consts(log_r, 2, SHIFT), jm._block_scale_consts(log_r, 2, SHIFT))


@pytest.mark.parametrize("inverse", [False, True])
def test_mod_matmul_matches_fused_interpret(inverse):
    """Both forms of `mod_matmul` against K7 in interpret mode at R = 16,
    B = 40 (no multiple of the TPU's 512-column tile)."""
    log_r, b = 4, 40
    x = _canon(1, 1 << log_r, b)
    tw = np_to_mont(_canon(2, 1 << log_r, b))
    xt = tensor_from_mont_np(x)
    _same(mm.mod_matmul(xt, log_r, inverse), jm.mod_matmul_fused(jnp.asarray(x), log_r, inverse))
    _same(
        mm.mod_matmul(xt, log_r, inverse, tw=tensor_from_mont_np(tw)),
        jm.mod_matmul_fused(jnp.asarray(x), log_r, inverse, tw=jnp.asarray(tw)),
    )


@pytest.mark.parametrize("log_n", [5, 9])
def test_ntt_and_lde_match_jax(log_n):
    """`ntt_matmul` both ways at 2^log_n (log_n 9 recurses once: members of
    2^7 and 2^2, the twiddle in `mod_matmul`'s epilogue) and
    `coset_lde_batch_matmul` at 2^min(log_n, 7) against the JAX functions;
    the LDE is also the plain butterfly LDE."""
    x = _canon(3 + log_n, 1 << log_n, 2)
    xt = tensor_from_mont_np(x)
    for inverse in (False, True):
        _same(mm.ntt_matmul(xt, inverse), jm.ntt_matmul(jnp.asarray(x), inverse))
    evals = np_to_mont(x[: 1 << min(log_n, 7)])
    got = mm.coset_lde_batch_matmul(tensor_from_mont_np(evals), 2, SHIFT)
    _same(got, jm.coset_lde_batch_matmul(jnp.asarray(evals), 2, SHIFT))
    assert torch.equal(got, coset_lde_batch(tensor_from_mont_np(evals), 2, SHIFT))


def test_mod_matmul_raises_off_cpu_and_cuda_and_on_bad_shapes():
    with pytest.raises(ValueError):
        mm.mod_matmul(torch.empty((16, 4), dtype=torch.int32, device="meta"), 4, False)
    with pytest.raises(ValueError):
        mm.mod_matmul(torch.zeros((16, 4), dtype=torch.int32), 3, False)
    with pytest.raises(ValueError):
        mm.mod_matmul(torch.zeros((16, 4), dtype=torch.int32), 4, False, tw=torch.zeros((16, 3), dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("log_r,b", [(7, 1 << 14), (6, 1000), (3, 4), (0, 7)])
def test_cuda_mod_matmul_matches_plain(log_r, b):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    x = tensor_from_mont_np(_canon(10 + log_r, 1 << log_r, b), dev)
    tw = tensor_from_mont_np(np_to_mont(_canon(20 + log_r, 1 << log_r, b)), dev)
    for inverse in (False, True):
        before = mm.launches["mod_matmul"]
        assert torch.equal(mm.mod_matmul(x, log_r, inverse), mm.mod_matmul_plain(x, log_r, inverse))
        assert torch.equal(mm.mod_matmul(x, log_r, inverse, tw=tw), mm.mod_matmul_plain(x, log_r, inverse, tw))
        assert mm.launches["mod_matmul"] == before + 2
    with pytest.raises(ValueError):
        mm.mod_matmul(torch.zeros((256, 4), dtype=torch.int32, device=dev), 8, False)
    evals = tensor_from_mont_np(np_to_mont(_canon(30, 1 << 12, 2)), dev)
    assert torch.equal(mm.coset_lde_batch_matmul(evals, 2, SHIFT), coset_lde_batch(evals, 2, SHIFT))
