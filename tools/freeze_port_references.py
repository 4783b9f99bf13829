"""The JAX package's numbers that the PyTorch port is held to.

    python tools/freeze_port_references.py [golden | wide | small ...]

Proves each configuration with `tapstark` on the CPU backend, verifies
it, emits its Bitcoin-Script verifier, and prints one JSON line per
configuration: the proof's (SHA-256, bytes, PoW witness), the report's
digest (segment count and the SHA-256 of the sorted (name, bytes) pairs,
total script bytes, distinct u32 values and the SHA-256 of their sorted
list, challenger compressions; `chip_smoke.py report_digest`) and the
seconds of each step.

- golden: Fibonacci 2^3 rows, blowup 4, 28 queries, 8 PoW bits
  (`chip_smoke.py` GOLDEN_REPORT);
- wide: RecursionAir 2^18 x 163, blowup 16, 16 queries, 8 PoW bits, a
  final polynomial of degree < 2^5 (`chip_smoke.py` WIDE_PROOF,
  WIDE_REPORT). A full-size run: tens of GiB and minutes of CPU;
- small: RecursionAir 2^3 x 163, blowup 2, 1 query, 2 PoW bits
  (`tests/test_torch_script_verifier.py` WIDE_8, the proof digest only;
  the other configurations there are proved live by both packages).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import report_digest  # noqa: E402

# chip_smoke blocks JAX and the JAX package for its own runs; this tool
# proves with them.
del sys.modules["jax"], sys.modules["tapstark"]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def run(name, air_name, log_n, log_blowup, nq, pow_bits, log_final=0, emit=True) -> None:
    from tapstark.airs import FibonacciAir, generate_fibonacci_trace
    from tapstark.airs.recursion import RecursionAir, generate_recursion_trace
    from tapstark.challenger import BfChallenger
    from tapstark.commit import BcManager, TapTreeMmcs
    from tapstark.field import F
    from tapstark.fri import FriConfig, TwoAdicFriPcs
    from tapstark.stark import prove, verify
    from tapstark.stark.script_verifier import generate_script_verifier
    from tapstark.stark.serde import proof_to_bytes

    fri = FriConfig(log_blowup=log_blowup, num_queries=nq, proof_of_work_bits=pow_bits,
                    mmcs=TapTreeMmcs(BcManager(), nq, ext=True), log_final_poly_len=log_final)
    pcs = TwoAdicFriPcs(TapTreeMmcs(BcManager(), nq, ext=False), fri)
    if air_name == "recursion":
        trace, pis = generate_recursion_trace(1 << log_n)
        pis, air = [F(x) for x in pis], RecursionAir()
    else:
        trace = generate_fibonacci_trace(0, 1, 1 << log_n)
        pis, air = [F(0), F(1), F(int(trace[-1, 1]))], FibonacciAir()
    t0 = time.perf_counter()
    proof = prove(pcs, air, BfChallenger(), trace, pis)
    t1 = time.perf_counter()
    verify(pcs, air, BfChallenger(), proof, pis)
    t2 = time.perf_counter()
    report = generate_script_verifier(pcs, air, BfChallenger(), proof, pis) if emit else None
    t3 = time.perf_counter()
    data = proof_to_bytes(proof)
    out = {"name": name, "config": [air_name, log_n, log_blowup, nq, pow_bits, log_final],
           "proof": [hashlib.sha256(data).hexdigest(), len(data), proof.opening_proof.pow_witness],
           "report": report_digest(report) if emit else None,
           "prove_s": t1 - t0, "verify_s": t2 - t1, "emit_s": t3 - t2}
    print(json.dumps(out), flush=True)


CONFIGS = {
    "golden": [("golden", "fib", 3, 2, 28, 8)],
    "wide": [("wide row", "recursion", 18, 4, 16, 8, 5)],
    "small": [("WIDE_8", "recursion", 3, 1, 1, 2, 0, False)],
}


def main() -> None:
    for which in sys.argv[1:] or ["golden", "small"]:
        for cfg in CONFIGS[which]:
            run(*cfg)


if __name__ == "__main__":
    main()
