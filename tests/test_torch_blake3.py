"""The port's Blake3 AIRs (tapstark_torch.airs.blake3_compression,
airs.blake3g) and the quotient's constraint program (tapstark_torch.air.
program, kernel csrc/quotient.cuh) against the JAX package.

Inputs are made from numpy seeds and handed to both packages; exact
equality throughout. No test here proves with the JAX package or runs its
jitted quotient at 1548 columns (minutes of XLA compiles on a CPU): the
JAX side runs its trace generators and its host `VerifierConstraintFolder`
on EF4 scalars, and its verifier on the port's bytes of the small sponge
proof, whose digest is frozen from the JAX package's own proof
(`python tools/freeze_port_references.py blake3_small`). The quotient
kernel's source runs on the host through `tests/cuda_host_shim` (g++), held
word for word against the eager folder, its plain version; `chip_smoke.py`
holds the CUDA build against the same on the card.
"""

import ctypes
import hashlib
import pathlib
import subprocess

import numpy as np
import pytest

import tapstark.airs as jairs
from tapstark.air.folders import VerifierConstraintFolder as JVerifierConstraintFolder
from tapstark.challenger import BfChallenger as JBfChallenger
from tapstark.commit import BcManager as JBcManager
from tapstark.commit import TapTreeMmcs as JTapTreeMmcs
from tapstark.field import EF4 as JEF4
from tapstark.field import F as JF
from tapstark.fri import FriConfig as JFriConfig
from tapstark.fri import TwoAdicFriPcs as JTwoAdicFriPcs
from tapstark.poly.domain import LagrangeSelectors as JLagrangeSelectors
from tapstark.poly.domain import TwoAdicMultiplicativeCoset as JCoset
from tapstark.stark import VerificationError as JVerificationError
from tapstark.stark import verify as j_verify
from tapstark.stark.serde import proof_from_bytes as j_proof_from_bytes
from tapstark_torch.air.folders import VerifierConstraintFolder
from tapstark_torch.air.program import chunk_threads, program_for, quotient_eager
from tapstark_torch.air.symbolic import get_log_quotient_degree
from tapstark_torch.airs import (
    Blake3CompressionAir,
    Blake3GAir,
    Blake3SpongeChainAir,
    FibonacciAir,
    MulAir,
    RecursionAir,
    WideAir,
    generate_blake3_compression_trace,
    generate_blake3_sponge_trace,
    generate_blake3g_trace,
)
from tapstark_torch.challenger import BfChallenger
from tapstark_torch.field import EF4, F
from tapstark_torch.field.constants import MULT_GENERATOR, P, R_MOD_P
from tapstark_torch.field.device import np_from_mont, np_to_mont
from tapstark_torch.interop import mont_np_from_tensor, pcs_from_reference, tensor_from_mont_np
from tapstark_torch.poly.domain import LagrangeSelectors, TwoAdicMultiplicativeCoset
from tapstark_torch.poly.ntt import coset_lde_batch
from tapstark_torch.stark import VerificationError, prove, quotient_values, verify
from tapstark_torch.stark.serde import proof_from_bytes, proof_to_bytes

# (sha256, bytes, PoW witness) of the JAX package's proof of the sponge over
# 4 compressions (tests/test_blake3_sponge_air.py's shape)
BLAKE3_SMALL = ("bec0ea139d74e8a6d2990e9630259ff39538ecf9574473628eadca39b150ad74", 1497462, 0)

# the three AIRs: (port AIR, JAX AIR, number of public values)
BLAKE3_AIRS = [
    (Blake3GAir(), jairs.Blake3GAir(), 8),
    (Blake3CompressionAir(), jairs.Blake3CompressionAir(), 48),
    (Blake3SpongeChainAir(), jairs.Blake3SpongeChainAir(), 16),
]


def _sponge_blocks(n):
    return [[b * 16 + w for w in range(16)] for b in range(n)]


def _ef(rng):
    return [int(v) for v in rng.integers(0, P, 4)]


def test_trace_generators_match_jax():
    """The sponge over 4 compressions, one compression of a random message
    and 16 rows of Blake3GAir: traces, public values and digests equal."""
    rng = np.random.default_rng(40)
    blocks = _sponge_blocks(4)
    got, want = generate_blake3_sponge_trace(blocks), jairs.generate_blake3_sponge_trace(blocks)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (256, 1548) and got[1:] == want[1:]
    ch = BfChallenger()
    for blk in blocks:
        ch.observe_u32s(blk)
    assert got[2] == ch.cv

    message = rng.integers(0, 256, 64).astype(np.uint8).tobytes()
    got, want = generate_blake3_compression_trace(message), jairs.generate_blake3_compression_trace(message)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]

    state = tuple(int(v) for v in rng.integers(0, 1 << 32, 4, dtype=np.uint64))
    got, want = generate_blake3g_trace(state, 16, seed=3), jairs.generate_blake3g_trace(state, 16, seed=3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_verifier_folders_match_jax():
    """Each Blake3 AIR's `VerifierConstraintFolder` at random EF4 rows,
    public values, selectors and alpha: the accumulators are equal."""
    rng = np.random.default_rng(41)
    for air, j_air, num_public in BLAKE3_AIRS:
        w = air.width()
        local, nxt = [_ef(rng) for _ in range(w)], [_ef(rng) for _ in range(w)]
        pis = [int(v) for v in rng.integers(0, P, num_public)]
        sels, alpha = [_ef(rng) for _ in range(4)], _ef(rng)
        folder = VerifierConstraintFolder([EF4(v) for v in local], [EF4(v) for v in nxt], [F(v) for v in pis],
                                          LagrangeSelectors(*(EF4(v) for v in sels)), EF4(alpha))
        air.eval(folder)
        j_folder = JVerifierConstraintFolder([JEF4(v) for v in local], [JEF4(v) for v in nxt],
                                             [JF(v) for v in pis], JLagrangeSelectors(*(JEF4(v) for v in sels)),
                                             JEF4(alpha))
        j_air.eval(j_folder)
        assert folder.accumulator.as_u32_vec() == j_folder.accumulator.as_u32_vec(), type(air).__name__


def test_sponge_quotient_rows_match_jax_folder():
    """The port's quotient (on the CPU: the eager folder, the kernel's plain
    version) of the sponge over 4 compressions, its trace extended to the
    quotient coset (512 rows): at sampled rows, the JAX package's host
    folder at that coset point, times its inverse zeroifier."""
    rng = np.random.default_rng(42)
    trace, pis, _ = generate_blake3_sponge_trace(_sponge_blocks(4))
    log_n = 8
    tq = coset_lde_batch(tensor_from_mont_np(np_to_mont(trace)), 1, MULT_GENERATOR)
    alpha = _ef(rng)
    td = TwoAdicMultiplicativeCoset(log_n, 1)
    qd = td.create_disjoint_domain(1 << (log_n + 1))
    assert qd.shift == MULT_GENERATOR
    got = np_from_mont(mont_np_from_tensor(quotient_values(
        Blake3SpongeChainAir(), [F(v) for v in pis], td, qd, tq, EF4(alpha))))
    canon = np_from_mont(mont_np_from_tensor(tq))
    jd = JCoset(log_n, 1)
    m = qd.size()
    for i in (0, 1, 255, m - 1):
        point = JEF4.from_base(JF(MULT_GENERATOR) * JF(qd.gen().v).exp(i))
        sels = jd.selectors_at_point(point)
        folder = JVerifierConstraintFolder([JEF4.from_base(JF(int(v))) for v in canon[i]],
                                           [JEF4.from_base(JF(int(v))) for v in canon[(i + 2) % m]],
                                           [JF(v) for v in pis], sels, JEF4(alpha))
        jairs.Blake3SpongeChainAir().eval(folder)
        want = (folder.accumulator * sels.inv_zeroifier).as_u32_vec()
        assert [int(v) for v in got[i]] == want, i


@pytest.fixture(scope="module")
def host_program(tmp_path_factory):
    """csrc/quotient.cuh's kernel, built with g++ against
    tests/cuda_host_shim (quotient_host.cpp runs the launch's threads)."""
    here = pathlib.Path(__file__).parent
    shim, csrc = here / "cuda_host_shim", here.parent / "tapstark_torch" / "csrc"
    so = tmp_path_factory.mktemp("quotient_host") / "libquotient_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{shim}", f"-I{csrc}", "-o", str(so),
                    str(shim / "quotient_host.cpp")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    lib.host_quotient_program.argtypes = [ptr, i32, ptr, ptr, ptr, i64, i32, i64, ptr, ptr, u32, u32, u32, u32,
                                          ptr, i64, ptr]
    return lib


def test_program_on_host_shim_matches_eager(host_program):
    """The recorded program, run by the kernel's own source on the host,
    against the eager folder word for word: Fibonacci, MulAir, WideAir,
    RecursionAir (163 columns), Blake3GAir and both 1548-column AIRs, on
    random cosets of 16-32 rows, with as many threads as rows and with
    fewer (each thread then walks several rows)."""
    cases = [(FibonacciAir(), 3, 3, None), (MulAir(), 3, 4, 4), (WideAir(8), 8, 3, None),
             (RecursionAir(), 12, 3, 2), (Blake3GAir(), 8, 4, None), (Blake3CompressionAir(), 48, 3, None),
             (Blake3SpongeChainAir(), 16, 3, 4)]
    rng = np.random.default_rng(43)
    for air, num_public, log_n, threads in cases:
        prog = program_for(air, num_public)
        td = TwoAdicMultiplicativeCoset(log_n, 1)
        log_q = get_log_quotient_degree(air, num_public)
        qd = td.create_disjoint_domain(1 << (log_n + log_q))
        m, w, step = qd.size(), air.width(), 1 << log_q
        tq = np_to_mont(rng.integers(0, P, (m, w)).astype(np.uint32))
        pis = [F(int(v)) for v in rng.integers(0, P, num_public)]
        alpha = EF4(_ef(rng))
        sels = td.selectors_on_coset(qd, "cpu")
        want = mont_np_from_tensor(quotient_eager(air, pis, sels, step, tensor_from_mont_np(tq), alpha))

        threads = threads or chunk_threads(m, prog.slots)
        sel = np.stack([mont_np_from_tensor(s) for s in (sels.is_first_row, sels.is_last_row, sels.is_transition)])
        invz = mont_np_from_tensor(sels.inv_zeroifier).copy()
        pub = np.array([v.v * R_MOD_P % P for v in pis], np.uint32)
        consts = prog.consts if len(prog.consts) else np.zeros(1, np.uint32)
        scratch = np.full(max(prog.slots, 1) * threads, 0xA5A5A5A5, np.uint32)
        out = np.zeros((m, 4), np.uint32)
        code = np.ascontiguousarray(prog.code)
        alpha_w = [v * R_MOD_P % P for v in alpha.as_u32_vec()]
        err = host_program.host_quotient_program(
            code.ctypes.data, len(code), consts.ctypes.data, pub.ctypes.data, tq.ctypes.data, m, w, step,
            sel.ctypes.data, invz.ctypes.data, *alpha_w, scratch.ctypes.data, threads, out.ctypes.data)
        assert err == 0
        np.testing.assert_array_equal(out, want, err_msg=type(air).__name__)


def _j_pcs(num_queries, log_blowup, pow_bits):
    fri = JFriConfig(log_blowup=log_blowup, num_queries=num_queries, proof_of_work_bits=pow_bits,
                     mmcs=JTapTreeMmcs(JBcManager(), num_queries, ext=True))
    return JTwoAdicFriPcs(JTapTreeMmcs(JBcManager(), num_queries, ext=False), fri)


def test_blake3_small_proof_matches_frozen_jax():
    """The sponge over 4 compressions (256 x 1548), blowup 2, 1 query, 2 PoW
    bits, proved by the port on the CPU: its bytes equal the JAX package's
    frozen proof; the JAX package's verify and the port's accept them; with
    one public value changed, both reject."""
    ref_pcs = _j_pcs(1, 1, 2)
    pcs = pcs_from_reference(ref_pcs, "cpu")
    trace, pis, _ = generate_blake3_sponge_trace(_sponge_blocks(4))
    pis = [F(v) for v in pis]
    air = Blake3SpongeChainAir()
    proof = prove(pcs, air, BfChallenger(), trace, pis)
    data = proof_to_bytes(proof)
    assert (hashlib.sha256(data).hexdigest(), len(data), proof.opening_proof.pow_witness) == BLAKE3_SMALL
    verify(pcs, air, BfChallenger(), proof_from_bytes(data), pis)
    j_pis = [JF(p.v) for p in pis]
    j_verify(ref_pcs, jairs.Blake3SpongeChainAir(), JBfChallenger(), j_proof_from_bytes(data), j_pis)

    bad = list(pis)
    bad[3] = bad[3] + F(1)
    with pytest.raises(VerificationError):
        verify(pcs, air, BfChallenger(), proof_from_bytes(data), bad)
    j_bad = list(j_pis)
    j_bad[3] = j_bad[3] + JF(1)
    with pytest.raises(JVerificationError):
        j_verify(ref_pcs, jairs.Blake3SpongeChainAir(), JBfChallenger(), j_proof_from_bytes(data), j_bad)
