"""The port's Bitcoin-Script verifier (tapstark_torch.stark.script_verifier,
tapstark_torch.fri.script_verifier, TwoAdicFriPcs.generate_verify_expr,
tapstark_torch.dsl), early-stopping FRI, `prove(debug=True)`, the grind on
a tensor batch and `standard_config`, against the JAX package.

Both packages prove the same numpy trace on the CPU and their proof bytes
must be equal; both verifiers accept them, and both packages emit the
script verifier from them: every report field must be equal. The port
executes every segment; the JAX side only builds them (`run_scripts=False`),
which gives the same report. Exact equality throughout. The one exception
is RecursionAir: the JAX package traces its 163-column quotient as about
200,000 jitted operations, over two minutes on a CPU even with a warm
compile cache, so that proof's digest is frozen from
`python tools/freeze_port_references.py small`, and the JAX verifier and
emission run live on the port's bytes.
"""

import hashlib

import pytest
import torch

import tapstark.airs as jairs
from tapstark.challenger import BfChallenger as JBfChallenger
from tapstark.commit import BcManager as JBcManager
from tapstark.commit import TapTreeMmcs as JTapTreeMmcs
from tapstark.field import EF4 as JEF4
from tapstark.field import F as JF
from tapstark.fri import FriConfig as JFriConfig
from tapstark.fri import TwoAdicFriPcs as JTwoAdicFriPcs
from tapstark.stark import check_constraints as j_check_constraints
from tapstark.stark import prove as j_prove
from tapstark.stark import verify as j_verify
from tapstark.stark.config import standard_config as j_standard_config
from tapstark.stark.script_verifier import generate_script_verifier as j_generate_script_verifier
from tapstark.stark.serde import proof_from_bytes as j_proof_from_bytes
from tapstark.stark.serde import proof_to_bytes as j_proof_to_bytes
from tapstark_torch.airs import (
    FibonacciAir,
    MulAir,
    RecursionAir,
    generate_fibonacci_trace,
    generate_mul_trace,
    generate_recursion_trace,
)
from tapstark_torch.challenger import BfChallenger
from tapstark_torch.field import EF4, F
from tapstark_torch.interop import config_from_reference, pcs_from_reference
from tapstark_torch.mesh import Mesh
from tapstark_torch.stark import VerificationError, check_constraints, prove, verify
from tapstark_torch.stark.config import standard_config
from tapstark_torch.stark.script_verifier import generate_script_verifier
from tapstark_torch.stark.serde import proof_from_bytes, proof_to_bytes

GOLDEN_PROOF_SHA256 = "73a2a6b32e057d641283f4eaaade5cf0c0616474bd5623f803dbf6d975bd2d36"
# (sha256, bytes, PoW witness) of the JAX package's RecursionAir proof
WIDE_8 = ("819ae34f1eb2531daf6c3032c177fb4ef2122a40b0c0671cc603769846ae9eef", 178686, 0)
REPORT_FIELDS = ("segment_script_bytes", "total_script_bytes", "distinct_u32_count", "u32_values",
                 "challenger_compressions")


def _ref_pcs(num_queries, log_blowup, pow_bits, log_final_poly_len=0):
    fri = JFriConfig(
        log_blowup=log_blowup, num_queries=num_queries, proof_of_work_bits=pow_bits,
        mmcs=JTapTreeMmcs(JBcManager(), num_queries, ext=True), log_final_poly_len=log_final_poly_len,
    )
    return JTwoAdicFriPcs(JTapTreeMmcs(JBcManager(), num_queries, ext=False), fri)


def _fib(n):
    trace = generate_fibonacci_trace(0, 1, n)
    return trace, [F(0), F(1), F(int(trace[-1, 1]))]


def _prove(ref_pcs, air, trace, pis, ref_air=None, **kw):
    """Prove with the port's twin of `ref_pcs`; the port's verifier accepts
    the bytes. With `ref_air`, the JAX package proves the same trace too
    and the two proofs' bytes must be equal."""
    pcs = pcs_from_reference(ref_pcs, "cpu")
    proof = prove(pcs, air, BfChallenger(), trace, pis, **kw)
    data = proof_to_bytes(proof)
    verify(pcs, air, BfChallenger(), proof_from_bytes(data), pis)
    if ref_air is not None:
        j_proof = j_prove(ref_pcs, ref_air, JBfChallenger(), trace, [JF(p.v) for p in pis], **kw)
        assert data == j_proof_to_bytes(j_proof)
    return pcs, proof, data


def _reports_equal(pcs, air, proof, pis, ref_pcs, ref_air, data):
    """The port's report (every segment executed) against the JAX package's
    from the same bytes, field by field; returns the port's."""
    j_pis = [JF(p.v) for p in pis]
    j_verify(ref_pcs, ref_air, JBfChallenger(), j_proof_from_bytes(data), j_pis)
    report = generate_script_verifier(pcs, air, BfChallenger(), proof, pis)
    want = j_generate_script_verifier(ref_pcs, ref_air, JBfChallenger(), j_proof_from_bytes(data), j_pis,
                                      run_scripts=False)
    for name in REPORT_FIELDS:
        assert getattr(report, name) == getattr(want, name), name
    return report


def test_fibonacci_script_verifier_matches_jax():
    """tests/test_script_verifier.py's configuration (2^3 rows, blowup 4, 6
    queries, 8 PoW bits); then the tampered opening of its
    test_script_verifier_rejects_tampered_openings raises in both."""
    ref_pcs = _ref_pcs(6, 2, 8)
    trace, pis = _fib(8)
    pcs, proof, data = _prove(ref_pcs, FibonacciAir(), trace, pis, jairs.FibonacciAir())
    report = _reports_equal(pcs, FibonacciAir(), proof, pis, ref_pcs, jairs.FibonacciAir(), data)
    assert len(report.segment_script_bytes) == 9  # 6 queries, quotient, constraints, challenger
    assert report.total_script_bytes == sum(report.segment_script_bytes.values())

    # the query scripts' native fold mirror is the first check to fail
    proof.opened_values.quotient_chunks[0][0] += EF4.one()
    with pytest.raises(AssertionError, match="native fold mirror drift"):
        generate_script_verifier(pcs, FibonacciAir(), BfChallenger(), proof, pis)
    j_proof = j_proof_from_bytes(data)
    j_proof.opened_values.quotient_chunks[0][0] = j_proof.opened_values.quotient_chunks[0][0] + JEF4.one()
    with pytest.raises(AssertionError, match="native fold mirror drift"):
        j_generate_script_verifier(ref_pcs, jairs.FibonacciAir(), JBfChallenger(), j_proof,
                                   [JF(p.v) for p in pis], run_scripts=False)


def test_mul_air_debug_prove_matches_jax():
    """MulAir (two quotient chunks) proved with `debug=True`, 2 queries, 4
    PoW bits: bytes and report equal the JAX package's; a trace with one
    wrong cell makes `check_constraints` raise in both packages, and the
    port's debug prove with it."""
    ref_pcs = _ref_pcs(2, 2, 4)
    trace = generate_mul_trace(3, 5, 8)
    pis = [F(3), F(5), F(int(trace[-1, 0]))]
    pcs, proof, data = _prove(ref_pcs, MulAir(), trace, pis, jairs.MulAir(), debug=True)
    _reports_equal(pcs, MulAir(), proof, pis, ref_pcs, jairs.MulAir(), data)

    bad = trace.copy()
    bad[3, 1] = (int(bad[3, 1]) + 1) % 2013265921
    with pytest.raises(AssertionError):
        check_constraints(MulAir(), bad, pis)
    with pytest.raises(AssertionError):
        j_check_constraints(jairs.MulAir(), bad, [JF(p.v) for p in pis])
    with pytest.raises(AssertionError):
        prove(pcs_from_reference(ref_pcs, "cpu"), MulAir(), BfChallenger(), bad, pis, debug=True)


@pytest.mark.parametrize("n, log_final, layers", [(64, 2, 4), (8, 3, 0)], ids=["L2", "L3-no-fold"])
def test_early_stop_fri_matches_jax(n, log_final, layers):
    """tests/test_fri.py's two early-stopping cases through the port's
    `bf_prove`: Fibonacci 2^6 rows at L = 2 (two fewer fold layers than at
    L = 0) and 2^3 rows at L = 3 (no fold layer: the reduced opening
    enters at the stop height), blowup 4, 3 queries, 2 PoW bits. Bytes
    and script-verifier report equal the JAX package's, and the port's
    verifier rejects a tampered final coefficient."""
    ref_pcs = _ref_pcs(3, 2, 2, log_final)
    trace, pis = _fib(n)
    pcs, proof, data = _prove(ref_pcs, FibonacciAir(), trace, pis, jairs.FibonacciAir())
    fri_proof = proof.opening_proof
    assert len(fri_proof.commit_phase_commits) == layers
    assert isinstance(fri_proof.final_poly, list) and len(fri_proof.final_poly) == 1 << log_final
    _reports_equal(pcs, FibonacciAir(), proof, pis, ref_pcs, jairs.FibonacciAir(), data)
    bad = list(fri_proof.final_poly)
    bad[1] = bad[1] + EF4.one()
    fri_proof.final_poly = bad
    with pytest.raises(VerificationError):
        verify(pcs, FibonacciAir(), BfChallenger(), proof, pis)


def test_wide_recursion_air_matches_jax():
    """RecursionAir at 163 columns and 8 rows (the shape of
    tests/test_wide_air.py's spill test), 1 query, blowup 2, 2 PoW bits:
    bytes equal the JAX package's frozen proof, and the report the JAX
    package's from them; the FRI reduced opening
    spills into ro-part segments and the constraints into chunked parts,
    every one executed."""
    ref_pcs = _ref_pcs(1, 1, 2)
    trace, pis = generate_recursion_trace(8)
    pis = [F(x) for x in pis]
    pcs, proof, data = _prove(ref_pcs, RecursionAir(), trace, pis, debug=True)
    assert (hashlib.sha256(data).hexdigest(), len(data), proof.opening_proof.pow_witness) == WIDE_8
    report = _reports_equal(pcs, RecursionAir(), proof, pis, ref_pcs, jairs.RecursionAir(), data)
    seg = report.segment_script_bytes
    assert any("ro-part" in k for k in seg)
    assert any("trace-constraints part:" in k for k in seg)
    assert "trace-constraints" not in seg


def test_grind_on_a_tensor_batch_matches_host():
    """`grind(bits, batch=None, use_device=True)` on CPU tensors returns
    the host grind's witness and leaves the same transcript, at 8 bits and
    at 20 bits, the 20-bit witness read from the JAX package's grind."""
    def state(ch):
        return ch.cv, ch.input_buffer, ch.output_buffer, ch.grind_bits, ch.grind_output

    for bits, prefix in ((8, [1, 2, 3]), (20, [2, 7, 11])):
        host, dev, ref = BfChallenger(), BfChallenger(), JBfChallenger()
        for ch in (host, dev, ref):
            ch.observe_u32s(prefix)
            ch.sample()
        want = ref.grind(bits, use_device=False)
        assert host.grind(bits, use_device=False) == want
        batch = None if bits < 20 else 1 << 18
        assert dev.grind(bits, batch=batch, use_device=True, device="cpu") == want
        assert state(dev) == state(host) == state(ref)
        assert dev.op_log == host.op_log


def test_standard_config(monkeypatch):
    """`standard_config(device="cpu")`, `config_from_reference` and
    `standard_config` over a mesh of 2 CPU shards (the golden LDEs then run
    as distributed four-step transforms) prove the golden configuration to
    the frozen proof; without a device and without a card `standard_config`
    raises, and so does a mesh whose primary device is not the PCS's."""
    trace, pis = _fib(8)
    for config in (standard_config(device="cpu"), config_from_reference(j_standard_config(), "cpu"),
                   standard_config(mesh=Mesh(["cpu"] * 2))):
        assert config.pcs.device == torch.device("cpu")
        proof = prove(config.pcs, FibonacciAir(), config.challenger(), trace, pis)
        assert hashlib.sha256(proof_to_bytes(proof)).hexdigest() == GOLDEN_PROOF_SHA256
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        standard_config()
    with pytest.raises(ValueError):
        standard_config(mesh=Mesh(["cpu"] * 2), device="cuda")
