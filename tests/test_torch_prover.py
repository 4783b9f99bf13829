"""The port's prover layers (quotient, open, FRI fold) against the JAX
package's, and the port's whole prove/verify at the frozen golden
configuration: the proof must come out byte for byte as the JAX package's
frozen one (tests/test_golden.py), on the CPU and with neither JAX nor the
JAX package importable. The port side uses only the port's own objects
(AIRs, challenger, field scalars, TapTreeMmcs/BcManager); the JAX package
is imported for the reference side alone.
"""

import dataclasses
import hashlib
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

import tapstark.airs as jairs
from tapstark.challenger import BfChallenger as JBfChallenger
from tapstark.commit import BcManager as JBcManager
from tapstark.commit import TapTreeMmcs as JTapTreeMmcs
from tapstark.field import EF4 as JEF4
from tapstark.field import F as JF
from tapstark.field import P
from tapstark.field.device import np_to_mont
from tapstark.fri import FriConfig as JFriConfig
from tapstark.fri import TwoAdicFriPcs as JTwoAdicFriPcs
from tapstark.fri.pcs import _inv_denoms_jit, _open_height_kernel
from tapstark.poly.domain import TwoAdicMultiplicativeCoset as JCoset
from tapstark.poly.fold import fold_matrix_host as j_fold_matrix_host
from tapstark.poly.fold import fold_matrix_jit
from tapstark.stark import quotient_values as j_quotient_values
from tapstark.stark import verify as j_verify
from tapstark.stark.serde import proof_from_bytes as j_proof_from_bytes
from tapstark_torch.airs import FibonacciAir, MulAir, generate_fibonacci_trace
from tapstark_torch.challenger import BfChallenger
from tapstark_torch.commit.tcs import TCS
from tapstark_torch.field import EF4, F
from tapstark_torch.field.device import ef_const, fetch_canonical
from tapstark_torch.fri.pcs import _inv_denoms, _open_height
from tapstark_torch.interop import mont_np_from_tensor, pcs_from_reference, tensor_from_mont_np
from tapstark_torch.poly.domain import TwoAdicMultiplicativeCoset
from tapstark_torch.poly.fold import fold_matrix, fold_matrix_host
from tapstark_torch.stark import VerificationError, prove, quotient_values, verify
from tapstark_torch.stark.serde import proof_from_bytes, proof_to_bytes

GOLDEN_PROOF_SHA256 = "73a2a6b32e057d641283f4eaaade5cf0c0616474bd5623f803dbf6d975bd2d36"
GOLDEN_PROOF_LEN = 871117
GOLDEN_POW_WITNESS = 198
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mont(rng, shape):
    return np_to_mont(rng.integers(0, P, shape).astype(np.uint32))


def _same(t, j):
    np.testing.assert_array_equal(mont_np_from_tensor(t), np.asarray(j))


@pytest.mark.parametrize(
    "air,log_n", [((FibonacciAir(), jairs.FibonacciAir()), 5), ((MulAir(), jairs.MulAir()), 4)]
)
def test_quotient_values_match_jax(air, log_n):
    from tapstark_torch.air.symbolic import get_log_quotient_degree

    air, j_air = air
    rng = np.random.default_rng(21)
    pis_v = [int(v) for v in rng.integers(0, P, 3)]
    alpha_v = [int(v) for v in rng.integers(0, P, 4)]
    lqd = get_log_quotient_degree(air, len(pis_v))
    tq = _mont(rng, (1 << (log_n + lqd), air.width()))

    jd = JCoset(log_n, 1)
    want = j_quotient_values(
        j_air, [JF(v) for v in pis_v], jd, jd.create_disjoint_domain(1 << (log_n + lqd)),
        jnp.asarray(tq), JEF4(alpha_v),
    )
    td = TwoAdicMultiplicativeCoset(log_n, 1)
    got = quotient_values(
        air, [F(v) for v in pis_v], td, td.create_disjoint_domain(1 << (log_n + lqd)),
        tensor_from_mont_np(tq, "cpu"), EF4(alpha_v),
    )
    _same(got, want)


def test_open_height_reduction_matches_jax():
    """One height of the PCS open: 3 columns, one point, 2^6 LDE rows (the
    JAX side traces an inverse chain per point, which is this test's time)."""
    rng = np.random.default_rng(22)
    n, h, w, pts = 16, 64, 3, 1
    args = [
        _mont(rng, (n, w)),  # natural
        _mont(rng, (h, w)),  # mat
        _mont(rng, (pts, w, 4)),  # weights
        _mont(rng, (pts, 4)),  # zs
        _mont(rng, (pts, 4)),  # scales
        _mont(rng, (n,)),  # xs
        _mont(rng, (pts, h, 4)),  # invd
    ]
    ys, ro = _open_height(*[tensor_from_mont_np(a, "cpu") for a in args])
    j_ys, j_ro = _open_height_kernel(*[jnp.asarray(a) for a in args])
    _same(ys, j_ys)
    _same(ro, j_ro)

    xs, z = _mont(rng, (h,)), _mont(rng, (4,))
    _same(_inv_denoms(tensor_from_mont_np(xs, "cpu"), tensor_from_mont_np(z, "cpu")), _inv_denoms_jit(jnp.asarray(xs), jnp.asarray(z)))


def test_fold_matches_jax():
    for log_half in (0, 3, 8):  # one item, not three: ROADMAP.md, the item count
        rng = np.random.default_rng(23 + log_half)
        m = _mont(rng, (1 << log_half, 2, 4))
        beta_v = [int(v) for v in rng.integers(0, P, 4)]
        beta = EF4(beta_v)
        got = fold_matrix(ef_const(beta, "cpu"), tensor_from_mont_np(m, "cpu"))
        _same(got, fold_matrix_jit(jnp.asarray(np_to_mont(np.array(beta_v, np.uint32))), jnp.asarray(m)))
        canon = fetch_canonical(tensor_from_mont_np(m, "cpu"))
        np.testing.assert_array_equal(fold_matrix_host(beta, canon), j_fold_matrix_host(JEF4(beta_v), canon))
        np.testing.assert_array_equal(fold_matrix_host(beta, canon), fetch_canonical(got))


def _chain_roots(rng, reps):
    """(R, 8) big-endian SHA root words as the card holds them, and the
    commitment the host observes (each root's LE words)."""
    words = rng.integers(0, 2**32, (reps, 8), dtype=np.uint64).astype(np.uint32)
    return words, [[int.from_bytes(int(w).to_bytes(4, "big"), "little") for w in row] for row in words]


def _transcript_host_lib(tmp_path):
    """csrc/transcript.cu built with g++ against tests/cuda_host_shim."""
    import ctypes
    import pathlib

    here = pathlib.Path(__file__).parent
    shim, csrc = here / "cuda_host_shim", here.parent / "tapstark_torch" / "csrc"
    so = tmp_path / "libtranscript_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{shim}", f"-I{csrc}", "-o", str(so),
                    str(shim / "transcript_host.cpp"), "-lpthread"], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_transcript_step.argtypes = [ptr, ptr, i32, ptr, i32, i64, i64, i32, ptr]
    lib.tapstark_transcript_constants.argtypes = [ptr]
    return lib


def test_transcript_chain_matches_jax_and_host(tmp_path):
    """The FRI device transcript chain (challenger/device_tail.py) on the
    CPU, its plain step, against the host BfChallenger word for word (both
    compressions, the pending lengths of tests/test_device_chain.py, R in
    {3, 5, 28}, three layers) and against the JAX package's jitted chain at
    tests/test_device_chain.py's R; `chain_supported`'s bounds; and the
    kernel's own source (csrc/transcript.cu, built with g++ against
    tests/cuda_host_shim, one thread) against the plain step, roots read
    through K6's strided view."""
    from tapstark.challenger import TestPermutation as JTestPermutation
    from tapstark.challenger import device_tail as jdt
    from tapstark_torch.challenger import Blake3Compression, TestPermutation
    from tapstark_torch.challenger import device_tail as dt
    from tapstark_torch.field.constants import R2_MOD_P
    from tapstark_torch.field.device import np_from_mont
    from tapstark_torch.hashes.blake3 import IV

    pendings = {"blake3": ([], [3], list(range(8)), list(range(11))),
                "test": ([], [123456789], list(range(8)), list(range(13)))}
    for kind, jax_reps in (("blake3", 5), ("test", 3)):
        for pend in pendings[kind]:
            for reps in (3, 5, 28):
                host = BfChallenger(permutation=TestPermutation() if kind == "test" else None)
                jhost = JBfChallenger(permutation=JTestPermutation() if kind == "test" else None)
                for w in pend:
                    host.observe(w)
                    jhost.observe(w)
                chain = dt.DeviceTailChain(host)
                jchain = jdt.DeviceTailChain(jhost) if reps == jax_reps else None
                rng = np.random.default_rng(7 + reps + len(pend))
                for _ in range(3):
                    words, commitment = _chain_roots(rng, reps)
                    beta_mont, beta_words = chain.step(tensor_from_mont_np(words, "cpu"))
                    host.observe_commitment(commitment)
                    beta = host.sample()
                    popped = [int(x) for x in mont_np_from_tensor(beta_words)]
                    assert popped == host.sample_input[-1], (kind, pend, reps)
                    assert [int(x) for x in np_from_mont(mont_np_from_tensor(beta_mont))] == list(beta.c)
                    if jchain is not None:
                        j_mont, j_words = jchain.step(jnp.asarray(words))
                        assert popped == [int(x) for x in np.asarray(j_words)], (kind, pend, reps)
                        _same(beta_mont, j_mont)

    assert dt.chain_supported(BfChallenger(), 28) and dt.chain_supported(BfChallenger(), 32)
    assert not dt.chain_supported(BfChallenger(), 33)  # the digest would take two blake3 chunks
    assert dt.chain_supported(BfChallenger(permutation=TestPermutation()), 4)

    class Unknown(Blake3Compression):  # not one of the two compressions the kernel knows
        pass

    assert not dt.chain_supported(BfChallenger(permutation=Unknown()), 4)

    lib = _transcript_host_lib(tmp_path)
    consts = np.zeros(9, np.uint32)
    lib.tapstark_transcript_constants(consts.ctypes.data)
    assert consts.tolist() == [R2_MOD_P, *IV]
    rng = np.random.default_rng(8)
    for kind in (dt.KIND_BLAKE3, dt.KIND_TEST):
        for k in (0, 3, 8, 11, 15):
            for reps in (1, 3, 28, 32):
                cv = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
                pend = rng.integers(0, 2**32, k, dtype=np.uint64).astype(np.uint32)
                level = rng.integers(0, 2**32, (8, reps, 5), dtype=np.uint64).astype(np.uint32)
                roots = tensor_from_mont_np(level, "cpu")[:, :, -1].T  # (R, 8), strides (5, 5R)
                out = np.zeros(16, np.uint32)
                lib.host_transcript_step(cv.ctypes.data, pend.ctypes.data, k, level.ctypes.data + 4 * 4, reps,
                                         roots.stride(0), roots.stride(1), kind, out.ctypes.data)
                want = dt.transcript_step_plain(tensor_from_mont_np(cv, "cpu"), tensor_from_mont_np(pend, "cpu"), roots, kind)
                np.testing.assert_array_equal(out, np.concatenate([mont_np_from_tensor(t) for t in want]))


def test_interpolation_matches_jax_host_reference():
    """Barycentric weights summed over a coset equal the exact host
    evaluation, and the host evaluation equals the JAX package's."""
    from tapstark.poly.interpolate import interpolate_coset_host as j_interpolate_host
    from tapstark_torch.poly.interpolate import _interp_weights, interpolate_coset_host
    from tapstark_torch.poly.powers import geom_powers_mont_dev
    from tapstark_torch.poly.reduce import fp_sum_axis0
    from tapstark_torch.field.device import ef_mul, ef_mul_base

    rng = np.random.default_rng(24)
    log_n, shift = 4, F.generator().v
    canon = rng.integers(0, P, (1 << log_n, 2)).astype(np.uint32)
    z_v = [int(v) for v in rng.integers(0, P, 4)]
    z = EF4(z_v)
    rows = [[F(int(v)) for v in row] for row in canon]
    want = interpolate_coset_host(rows, shift, z)
    j_want = j_interpolate_host([[JF(int(v)) for v in row] for row in canon], shift, JEF4(z_v))
    assert [e.as_u32_vec() for e in want] == [e.as_u32_vec() for e in j_want]

    xs = geom_powers_mont_dev(F.two_adic_generator(log_n).v, log_n, shift, "cpu")
    iw = _interp_weights(xs, ef_const(z, "cpu"))
    sums = fp_sum_axis0(ef_mul_base(iw[:, None, :], tensor_from_mont_np(np_to_mont(canon), "cpu")))
    n = 1 << log_n
    s_pow_n = F(shift).exp(n)
    scale = (z.exp(n) - EF4.from_base(s_pow_n)) * EF4.from_base(F(n) * s_pow_n).inverse()
    got = fetch_canonical(ef_mul(sums, ef_const(scale, "cpu")))
    assert [EF4([int(x) for x in row]) for row in got] == want


def test_interpolate_coset_matches_jax_and_host(monkeypatch):
    """`interpolate_coset` against the JAX package's (jitted) at 2^4 rows
    of 70 columns (past the reference's 64-column chunk) and 2^7 rows of
    one, and against `interpolate_coset_host` at 2^0 rows of 3 and at the
    2^4 rows' first 5 columns, exactly, with the step bound at its default
    and cut so that steps split rows, and columns."""
    from tapstark.poly.interpolate import interpolate_coset as j_interpolate_coset
    from tapstark_torch.poly import interpolate

    rng = np.random.default_rng(25)
    shift = F.generator().v
    for log_n, w in ((0, 3), (4, 70), (7, 1)):
        m = _mont(rng, (1 << log_n, w))
        z = EF4([int(v) for v in rng.integers(0, P, 4)])
        if log_n:
            want = np.asarray(j_interpolate_coset(jnp.asarray(m), shift, JEF4(z.as_u32_vec())))
        for step in (interpolate.STEP_PRODUCTS, 32, 4):
            monkeypatch.setattr(interpolate, "STEP_PRODUCTS", step)
            got = interpolate.interpolate_coset(tensor_from_mont_np(m, "cpu"), shift, z)
            if log_n:
                _same(got, want)
        if log_n != 7:
            rows = [[F(int(v)) for v in row] for row in fetch_canonical(tensor_from_mont_np(m[:, :5], "cpu"))]
            host = interpolate.interpolate_coset_host(rows, shift, z)
            assert [e.as_u32_vec() for e in host] == [[int(v) for v in r] for r in fetch_canonical(got[:5])]


def _golden_setup():
    """The JAX package's golden configuration, and the port's twin of it
    (its own TapTreeMmcs and BcManagers, from the reference's fields)."""
    nq = 28
    fri = JFriConfig(
        log_blowup=2, num_queries=nq, proof_of_work_bits=8,
        mmcs=JTapTreeMmcs(JBcManager(), nq, ext=True),
    )
    ref_pcs = JTwoAdicFriPcs(JTapTreeMmcs(JBcManager(), nq, ext=False), fri)
    trace = generate_fibonacci_trace(0, 1, 1 << 3)
    pis = [F(0), F(1), F(int(trace[-1, 1]))]
    return ref_pcs, pcs_from_reference(ref_pcs, "cpu"), trace, pis


@pytest.fixture(scope="module")
def golden():
    ref_pcs, pcs, trace, pis = _golden_setup()
    commits = []
    real = TCS._commit_device

    def counted(self, *args):
        commits.append(args[0])
        return real(self, *args)

    TCS._commit_device = counted
    try:
        proof = prove(pcs, FibonacciAir(), BfChallenger(), trace, pis)
    finally:
        TCS._commit_device = real
    return ref_pcs, pcs, pis, proof, proof_to_bytes(proof), commits


def test_golden_proof_bytes_on_cpu(golden):
    ref_pcs, pcs, pis, proof, data, commits = golden
    assert proof.opening_proof.pow_witness == GOLDEN_POW_WITNESS
    assert len(data) == GOLDEN_PROOF_LEN
    assert hashlib.sha256(data).hexdigest() == GOLDEN_PROOF_SHA256
    verify(pcs, FibonacciAir(), BfChallenger(), proof_from_bytes(data), pis)


def test_golden_proof_verifies_in_jax_package(golden):
    ref_pcs, pcs, pis, proof, data, commits = golden
    j_pis = [JF(p.v) for p in pis]
    j_verify(ref_pcs, jairs.FibonacciAir(), JBfChallenger(), j_proof_from_bytes(data), j_pis)


def test_golden_proof_commits_through_device_path(golden, monkeypatch):
    """The trace and quotient commits took the device path (the kernels'
    plain versions on the CPU): the PCS hands TCS its LDE tensors. Then,
    with every FRI layer on the device path (HOST_TAIL_MAX_HALF = 0), the
    device transcript chain steps once a layer (3) and the proof is the
    frozen one, and it is with the chain switched off too; no opening
    copies a whole padding matrix (`DeviceValues.full`)."""
    from tapstark_torch.challenger import device_tail
    from tapstark_torch.commit.device_commit import DeviceValues
    from tapstark_torch.fri import prover as fri_prover

    ref_pcs, pcs, pis, proof, data, commits = golden
    assert len(commits) == 2
    assert all(m.dev is not None and m.dev.device.type == "cpu" for ms in commits for m in ms)
    assert hashlib.sha256(data).hexdigest() == GOLDEN_PROOF_SHA256

    monkeypatch.setattr(fri_prover, "HOST_TAIL_MAX_HALF", 0)
    full_before = DeviceValues.full_calls
    for chain, steps in ((True, 3), (False, 0)):
        _, pcs, trace, pis = _golden_setup()
        pcs.device_chain = chain
        before = device_tail.TOTAL_STEPS
        proof = prove(pcs, FibonacciAir(), BfChallenger(), trace, pis)
        assert device_tail.TOTAL_STEPS - before == steps
        data = proof_to_bytes(proof)
        assert (hashlib.sha256(data).hexdigest(), len(data), proof.opening_proof.pow_witness) == (
            GOLDEN_PROOF_SHA256, GOLDEN_PROOF_LEN, GOLDEN_POW_WITNESS)
    assert DeviceValues.full_calls == full_before


def test_wrong_public_values_rejected(golden):
    ref_pcs, pcs, pis, proof, data, commits = golden
    with pytest.raises(VerificationError):
        verify(pcs, FibonacciAir(), BfChallenger(), proof, [pis[0], pis[1], pis[2] + F(1)])


def test_tampered_opening_rejected(golden):
    ref_pcs, pcs, pis, proof, data, commits = golden
    ov = proof.opened_values
    tampered = dataclasses.replace(
        proof,
        opened_values=dataclasses.replace(
            ov, trace_local=[ov.trace_local[0] + EF4.one()] + ov.trace_local[1:]
        ),
    )
    with pytest.raises(VerificationError):
        verify(pcs, FibonacciAir(), BfChallenger(), tampered, pis)


def test_golden_prove_with_jax_blocked():
    """The port proves the golden configuration, and emits and executes its
    script verifier (the DSL and both script verifiers), in a process where
    neither JAX nor the JAX package can be imported; the report's numbers
    are the JAX package's (chip_smoke.py's GOLDEN_REPORT)."""
    script = textwrap.dedent(
        f"""
        import hashlib, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "tapstark"):
                    raise ImportError(name + " is blocked")

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        from tapstark_torch.airs import FibonacciAir, generate_fibonacci_trace
        from tapstark_torch.challenger import BfChallenger
        from tapstark_torch.commit import BcManager, TapTreeMmcs
        from tapstark_torch.field import F
        from tapstark_torch.fri import FriConfig, TwoAdicFriPcs
        from tapstark_torch.stark import prove
        from tapstark_torch.stark.serde import proof_to_bytes

        fri = FriConfig(2, 28, 8, TapTreeMmcs(BcManager(), 28, ext=True))
        pcs = TwoAdicFriPcs(TapTreeMmcs(BcManager(), 28, ext=False), fri, "cpu")
        trace = generate_fibonacci_trace(0, 1, 8)
        pis = [F(0), F(1), F(int(trace[-1, 1]))]
        proof = prove(pcs, FibonacciAir(), BfChallenger(), trace, pis)
        from tapstark_torch.stark.script_verifier import generate_script_verifier

        report = generate_script_verifier(pcs, FibonacciAir(), BfChallenger(), proof, pis)
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tapstark")]
        data = proof_to_bytes(proof)
        print(report.total_script_bytes, report.distinct_u32_count, report.challenger_compressions)
        print(hashlib.sha256(data).hexdigest(), len(data), proof.opening_proof.pow_witness)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, cwd=REPO, timeout=300
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-6:] == ["5451534", "325", "9", GOLDEN_PROOF_SHA256, str(GOLDEN_PROOF_LEN),
                                       str(GOLDEN_POW_WITNESS)]
