"""The port's field layer (tapstark_torch.field.device, poly.reduce,
poly.powers) against the JAX package's, word for word.

Inputs are canonical values from numpy's seeded generator, converted to
Montgomery words and handed to both packages. Field arithmetic is exact, so
every comparison is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tapstark.field.device as jdev
from tapstark.field.constants import P
from tapstark.field.scalar import EF4
from tapstark.poly.powers import bitrev_1d_dev as j_bitrev_1d
from tapstark.poly.powers import geom_powers_mont_dev as j_geom_powers
from tapstark.poly.reduce import fp_sum_axis0 as j_sum_axis0
from tapstark_torch.field import device as tdev
from tapstark_torch.interop import mont_np_from_tensor, tensor_from_mont_np
from tapstark_torch.poly.powers import bitrev_1d_dev, geom_powers_mont_dev, np_geom_powers
from tapstark_torch.poly.reduce import fp_sum_axis0


# one base and one extension shape throughout: JAX compiles each eager op
# once per shape, and that compile is most of these tests' time
BASE, EXT = (512,), (512, 4)


def _mont(rng, shape):
    return jdev.np_to_mont(rng.integers(0, P, shape).astype(np.uint32))


def _same(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(mont_np_from_tensor(t), np.asarray(j))


def test_binary_ops_match_jax():
    """fp_add, fp_sub, fp_mul, ef_add, ef_sub, ef_mul (one item for the six
    cases; see ROADMAP.md on the suite's item count)."""
    for op in ["fp_add", "fp_sub", "fp_mul", "ef_add", "ef_sub", "ef_mul"]:
        rng = np.random.default_rng(11)
        shape = EXT if op.startswith("ef") else BASE
        a, b = _mont(rng, shape), _mont(rng, shape)
        edge = jdev.np_to_mont(np.array([0, 1, P - 1, P - 2], np.uint32))
        a[:4] = 0
        b[:4] = edge.reshape((4,) + (1,) * (b.ndim - 1))
        got = getattr(tdev, op)(tensor_from_mont_np(a, "cpu"), tensor_from_mont_np(b, "cpu"))
        assert got.dtype == torch.int32, op
        _same(got, getattr(jdev, op)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("op", ["fp_neg", "fp_inv", "ef_neg", "ef_inv"])
def test_unary_ops_match_jax(op):
    rng = np.random.default_rng(12)
    a = _mont(rng, EXT if op.startswith("ef") else BASE)
    a[0] = 0  # inverse of 0 is 0 in both
    _same(getattr(tdev, op)(tensor_from_mont_np(a, "cpu")), getattr(jdev, op)(jnp.asarray(a)))


def test_pow_matches_jax():
    """Exponents 0, 1, 5, 2^20 and p - 2 (one item for the five cases)."""
    for e in [0, 1, 5, 1 << 20, P - 2]:
        rng = np.random.default_rng(13)
        a = _mont(rng, BASE)
        _same(tdev.fp_pow(tensor_from_mont_np(a, "cpu"), e), jdev.fp_pow(jnp.asarray(a), e))


def test_extension_ops_match_jax():
    """ef_add_base, ef_square, ef_one_like, fp_square, and ef_pow at
    exponents 0, 1, 2, 7 and p - 2."""
    rng = np.random.default_rng(18)
    a, b = _mont(rng, EXT), _mont(rng, BASE)
    a[0], b[1] = 0, 0
    ta, tb, ja, jb = tensor_from_mont_np(a, "cpu"), tensor_from_mont_np(b, "cpu"), jnp.asarray(a), jnp.asarray(b)
    _same(tdev.ef_add_base(ta, tb), jdev.ef_add_base(ja, jb))
    _same(tdev.ef_square(ta), jdev.ef_square(ja))
    _same(tdev.ef_one_like(ta), jdev.ef_one_like(ja))
    _same(tdev.fp_square(tb), jdev.fp_square(jb))
    for e in [0, 1, 2, 7, P - 2]:
        _same(tdev.ef_pow(ta, e), jdev.ef_pow(ja, e))


def test_mixed_ext_ops_match_jax():
    rng = np.random.default_rng(14)
    a, b = _mont(rng, EXT), _mont(rng, BASE)
    ta, tb = tensor_from_mont_np(a, "cpu"), tensor_from_mont_np(b, "cpu")
    _same(tdev.ef_mul_base(ta, tb), jdev.ef_mul_base(jnp.asarray(a), jnp.asarray(b)))
    _same(tdev.ef_from_base(tb), jdev.ef_from_base(jnp.asarray(b)))
    z = EF4([5, 6, 7, 8])
    _same(tdev.ef_const(z, "cpu"), jdev.ef_const(z))
    assert tdev.fp_const(12345) == int(jdev.fp_const(12345))


def test_montgomery_conversions_match_jax():
    rng = np.random.default_rng(15)
    canon = np.concatenate(
        [np.array([0, 1, 2, P - 1, P - 2], np.uint32), rng.integers(0, P, 507).astype(np.uint32)]
    )
    mont = tdev.to_mont(canon)
    _same(mont, jdev.to_mont(canon))
    np.testing.assert_array_equal(mont_np_from_tensor(tdev.from_mont(mont)), canon)
    np.testing.assert_array_equal(tdev.fetch_canonical(mont), canon)
    np.testing.assert_array_equal(tdev.np_to_mont(canon), jdev.np_to_mont(canon))
    np.testing.assert_array_equal(tdev.np_from_mont(jdev.np_to_mont(canon)), canon)


@pytest.mark.parametrize("shape", [(1, 3), (7, 4), (37, 2, 4)])
def test_sum_axis0_matches_jax(shape):
    a = _mont(np.random.default_rng(16), shape)
    _same(fp_sum_axis0(tensor_from_mont_np(a, "cpu")), j_sum_axis0(jnp.asarray(a)))


def test_powers_and_bitrev_match_jax():
    """At log_n 0, 1 and 9 (one item for the three)."""
    base, shift = 0x1A427A41, 31
    for log_n in (0, 1, 9):
        got = geom_powers_mont_dev(base, log_n, shift, "cpu")
        _same(got, j_geom_powers(base, log_n, shift))
        np.testing.assert_array_equal(
            tdev.fetch_canonical(got), np_geom_powers(base, 1 << log_n, shift)
        )
        x = _mont(np.random.default_rng(17), (1 << log_n,))
        _same(bitrev_1d_dev(tensor_from_mont_np(x, "cpu"), log_n), j_bitrev_1d(jnp.asarray(x), log_n))
