"""The port's limb-matmul NTT (tapstark_torch.poly.matmul_ntt) against the
JAX package's (tapstark/poly/matmul_ntt.py), word for word.

On the CPU `mod_matmul` runs its plain version (limb dots in float64);
the JAX side runs K7 (`mod_matmul_fused`) in Pallas interpret mode, or
its unfused XLA route. The CUDA kernel's own arithmetic and index math
(`csrc/matmul_ntt.cuh`: byte limbs, the bucket fold and its one
reduction, the fragment and store layouts) is held here too, built with
g++ against stand-ins for the CUDA built-ins and run through the kernel's
data flow (`tests/cuda_host_shim/matmul_host.cpp`). The CUDA kernel is
held against the plain version by the `cuda`-marked test (and by
chip_smoke.py on the card). Exact equality throughout.
"""

import ctypes
import pathlib
import subprocess

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


# canonical words whose byte limbs are the largest the kernel's buckets hold
EXTREMES = (0x77FFFFFF, P - 1)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/matmul_ntt.cuh and the kernel's data flow
    (tests/cuda_host_shim/matmul_host.cpp), built with g++."""
    here = pathlib.Path(__file__).parent
    shim, csrc = here / "cuda_host_shim", here.parent / "tapstark_torch" / "csrc"
    so = tmp_path_factory.mktemp("matmul_host") / "libmatmul_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{shim}", f"-I{csrc}", "-o", str(so),
                    str(shim / "matmul_host.cpp")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_mod_matmul.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32]
    lib.host_fold_buckets.argtypes = [ptr, ptr, i64]
    return lib


def _host_mod_matmul(lib, x, log_r, inverse, tw=None, width=None):
    """The kernel's data flow on the host: x (R, B) canonical uint32, tw
    Montgomery uint32 or None; the natural (R, B) output, or with `width`
    the next level's (B / width, R·width)."""
    r, b = x.shape
    out = np.zeros((r, b) if width is None else (b // width, r * width), np.uint32)
    tw = None if tw is None else np.ascontiguousarray(tw)
    assert lib.host_mod_matmul(_ptr(mm.w_matrix_smem(log_r, inverse)), _ptr(np.ascontiguousarray(x)),
                               None if tw is None else _ptr(tw), _ptr(out), log_r, b, width or 0) == 0
    return out


def _plain(x, log_r, inverse, tw=None, width=None):
    t = None if tw is None else tensor_from_mont_np(tw, "cpu")
    return mont_np_from_tensor(mm.mod_matmul_plain(tensor_from_mont_np(x, "cpu"), log_r, inverse, t, width))


@pytest.mark.parametrize("log_r", [0, 3, 7])
def test_tables_match_jax(log_r, host_kernel):
    """The tables against the JAX package's; the kernel's W table (byte
    planes in wgmma's swizzled layout) holds the JAX package's W; the
    kernel's data flow on the host at R = 2^log_r (ragged B, random and
    extreme inputs, both forms, with and without twiddle) against the plain
    version; at R = 128 its one-reduction fold over numpy's byte-limb bucket
    sums of the extreme inputs against the plain version."""
    r = 1 << log_r
    for inverse in (False, True):
        np.testing.assert_array_equal(mm.w_matrix_limbs(log_r, inverse), jm._w_matrix_limbs(log_r, inverse))
        np.testing.assert_array_equal(
            mm.outer_twiddle_rep(log_r, 2, 3, inverse), jm._outer_twiddle_rep(log_r, 2, 3, inverse)
        )
        planes = mm.w_matrix_smem(log_r, inverse).reshape(mm.BYTE_LIMBS, max(r, 16), 128).astype(np.uint64)
        k, i = np.arange(r)[:, None], np.arange(r)[None, :]
        w_bytes = planes[:, k, (((i >> 4) ^ (k & 7)) << 4) | (i & 15)]
        w_jax = sum(jm._w_matrix_limbs(log_r, inverse).astype(np.uint64)[l] << (7 * l) for l in range(5))
        np.testing.assert_array_equal(sum(w_bytes[l] << (8 * l) for l in range(4)), w_jax)
        assert int(planes.sum()) == int(w_bytes.sum())  # zero outside R x R
    np.testing.assert_array_equal(mm.shift_consts_mont(), jm._shift_consts_mont())
    np.testing.assert_array_equal(mm.byte_shift_consts_mont(), np_to_mont(np.array([(1 << (8 * s)) % P for s in range(7)])))
    np.testing.assert_array_equal(mm.block_scale_consts(log_r, 2, SHIFT), jm._block_scale_consts(log_r, 2, SHIFT))

    b = {0: 7, 3: 12, 7: 130}[log_r]  # 130: three tiles of 64 columns, the last ragged
    width = {0: 7, 3: 4, 7: 2}[log_r]
    rng = np.random.default_rng(40 + log_r)
    tw = np_to_mont(_canon(41 + log_r, r, b))
    for x in (_canon(42 + log_r, r, b), *(np.full((r, b), v, np.uint32) for v in EXTREMES)):
        for inverse in (False, True):
            for t in (None, tw):
                for wd in (None, width):
                    np.testing.assert_array_equal(_host_mod_matmul(host_kernel, x, log_r, inverse, t, wd),
                                                  _plain(x, log_r, inverse, t, wd))
        tw = np_to_mont(rng.integers(0, P, (r, b)).astype(np.uint32))
    if log_r == 7:
        for v in EXTREMES:
            x = np.full((r, 64), v, np.uint64)
            w = mm.dft_matrix(log_r, True)
            buckets = np.zeros((7, r, 64), np.uint64)
            for a in range(4):
                for c in range(4):
                    buckets[a + c] += ((w >> (8 * c)) & 0xFF) @ ((x >> (8 * a)) & 0xFF)
            assert buckets.max() < 1 << 25
            folded = np.zeros((r, 64), np.uint32)
            host_kernel.host_fold_buckets(_ptr(np.ascontiguousarray(buckets.transpose(1, 2, 0).astype(np.uint32))),
                                          _ptr(folded), r * 64)
            np.testing.assert_array_equal(folded, _plain(x.astype(np.uint32), log_r, True))


@pytest.mark.parametrize("inverse", [False, True])
def test_mod_matmul_matches_fused_interpret(inverse, host_kernel):
    """`mod_matmul` with and without twiddle, in both output forms, against
    K7 in interpret mode at R = 16, B = 40 (no multiple of the TPU's
    512-column tile; the next-level form as numpy transposes K7's output),
    and so is the kernel's data flow on the host, on random and extreme
    inputs."""
    log_r, b, width = 4, 40, 4
    r = 1 << log_r
    tw = np_to_mont(_canon(2, r, b))
    for x in (_canon(1, r, b), *(np.full((r, b), v, np.uint32) for v in EXTREMES)):
        xt = tensor_from_mont_np(x, "cpu")
        for t in (None, tw):
            want = np.asarray(jm.mod_matmul_fused(jnp.asarray(x), log_r, inverse,
                                                  tw=None if t is None else jnp.asarray(t)))
            want_next = want.reshape(r, b // width, width).transpose(1, 0, 2).reshape(b // width, r * width)
            tt = None if t is None else tensor_from_mont_np(t, "cpu")
            _same(mm.mod_matmul(xt, log_r, inverse, tw=tt), want)
            _same(mm.mod_matmul(xt, log_r, inverse, tw=tt, width=width), want_next)
            np.testing.assert_array_equal(_host_mod_matmul(host_kernel, x, log_r, inverse, t), want)
            np.testing.assert_array_equal(_host_mod_matmul(host_kernel, x, log_r, inverse, t, width), want_next)


@pytest.mark.parametrize("log_n", [5, 9])
def test_ntt_and_lde_match_jax(log_n):
    """`ntt_matmul` both ways at 2^log_n (log_n 9 recurses once: members of
    2^7 and 2^2, the twiddle in `mod_matmul`'s epilogue) and
    `coset_lde_batch_matmul` at 2^min(log_n, 7) against the JAX functions;
    the LDE is also the plain butterfly LDE."""
    x = _canon(3 + log_n, 1 << log_n, 2)
    xt = tensor_from_mont_np(x, "cpu")
    for inverse in (False, True):
        _same(mm.ntt_matmul(xt, inverse), jm.ntt_matmul(jnp.asarray(x), inverse))
    evals = np_to_mont(x[: 1 << min(log_n, 7)])
    got = mm.coset_lde_batch_matmul(tensor_from_mont_np(evals, "cpu"), 2, SHIFT)
    _same(got, jm.coset_lde_batch_matmul(jnp.asarray(evals), 2, SHIFT))
    assert torch.equal(got, coset_lde_batch(tensor_from_mont_np(evals, "cpu"), 2, SHIFT))


def test_mod_matmul_raises_off_cpu_and_cuda_and_on_bad_shapes():
    with pytest.raises(ValueError):
        mm.mod_matmul(torch.empty((16, 4), dtype=torch.int32, device="meta"), 4, False)
    with pytest.raises(ValueError):
        mm.mod_matmul(torch.zeros((16, 4), dtype=torch.int32), 3, False)
    with pytest.raises(ValueError):
        mm.mod_matmul(torch.zeros((16, 4), dtype=torch.int32), 4, False, tw=torch.zeros((16, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        mm.mod_matmul(torch.zeros((16, 6), dtype=torch.int32), 4, False, width=4)


@pytest.mark.cuda
def test_cuda_mod_matmul_matches_plain():
    """Both directions and output forms, with and without twiddle, on
    random and extreme inputs at (log R, B) = (7, 2^14), (6, 1000), (3, 4),
    (0, 7). One test, not four cases: see ROADMAP.md on how the suite's
    item count places the slow pre-port tests in the parallel run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for log_r, b in [(7, 1 << 14), (6, 1000), (3, 4), (0, 7)]:
        r = 1 << log_r
        width = 2 if b % 2 == 0 else b
        tw = tensor_from_mont_np(np_to_mont(_canon(20 + log_r, r, b)), dev)
        for x in (tensor_from_mont_np(_canon(10 + log_r, r, b), dev),
                  *(torch.full((r, b), v, dtype=torch.int64).to(torch.int32).to(dev) for v in EXTREMES)):
            for inverse in (False, True):
                before = mm.launches["mod_matmul"]
                for t in (None, tw):
                    for wd in (None, width):
                        assert torch.equal(mm.mod_matmul(x, log_r, inverse, t, wd),
                                           mm.mod_matmul_plain(x, log_r, inverse, t, wd))
                assert mm.launches["mod_matmul"] == before + 4
    with pytest.raises(ValueError):
        mm.mod_matmul(torch.zeros((256, 4), dtype=torch.int32, device=dev), 8, False)
    evals = tensor_from_mont_np(np_to_mont(_canon(30, 1 << 12, 2)), dev)
    assert torch.equal(mm.coset_lde_batch_matmul(evals, 2, SHIFT), coset_lde_batch(evals, 2, SHIFT))
