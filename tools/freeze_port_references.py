"""The JAX package's numbers that the PyTorch port is held to.

    python tools/freeze_port_references.py [golden | wide | small | blake3_small | blake3 | blake3_port | mesh ...]

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
  the other configurations there are proved live by both packages);
- blake3_small: Blake3SpongeChainAir over 4 compressions (256 rows x 1548),
  blowup 2, 1 query, 2 PoW bits, the shape of
  `tests/test_blake3_sponge_air.py` (`tests/test_torch_blake3.py`
  BLAKE3_SMALL, the proof digest only);
- blake3: the flagship's settings (`chip_smoke.py` BLAKE3: blowup 2, 16
  queries, 4 PoW bits, the messages of `bench_blake3.py`) over 64
  compressions, 4096 rows (`chip_smoke.py` BLAKE3_64_PROOF). The JAX
  package does not prove the flagship's 1024 on a host of 96 GiB: its flat
  quotient program alone peaks at ~82 GB on a CPU (README);
- blake3_port: the JAX package's verify on the port's flagship proof,
  which `chip_study.py blake3` wrote to chiprun_out/blake3_proof.bin;
  prints its digest (`chip_smoke.py` BLAKE3_PROOF) once verify accepts it;
- mesh: the configuration of `tests/test_mesh_prover.py` (Fibonacci 2^12
  rows, blowup 2, 4 queries, 4 PoW bits) proved through a PCS over the
  JAX package's mesh of 8 virtual CPU devices
  (`tests/test_torch_mesh.py` MESH_PROOF, the proof digest only).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import report_digest  # noqa: E402

# chip_smoke blocks JAX and the JAX package for its own runs; this tool
# proves with them, on 8 virtual CPU devices (the mesh target's, as in
# tests/conftest.py).
del sys.modules["jax"], sys.modules["tapstark"]
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def make_pcs(log_blowup, nq, pow_bits, log_final=0, mesh=None):
    from tapstark.commit import BcManager, TapTreeMmcs
    from tapstark.fri import FriConfig, TwoAdicFriPcs

    fri = FriConfig(log_blowup=log_blowup, num_queries=nq, proof_of_work_bits=pow_bits,
                    mmcs=TapTreeMmcs(BcManager(), nq, ext=True), log_final_poly_len=log_final)
    return TwoAdicFriPcs(TapTreeMmcs(BcManager(), nq, ext=False), fri, mesh=mesh)


def cpu_mesh():
    """The JAX package's mesh over every (virtual) CPU device."""
    import numpy as np
    from jax.sharding import Mesh

    from tapstark.mesh.ntt import AXIS

    return Mesh(np.array(jax.devices()), (AXIS,))


def sponge(blocks: int):
    """(trace, public values, AIR) of the Blake3 sponge chain over
    `blocks` compressions of `chip_smoke.sponge_blocks`' messages, its
    digest checked against the challenger's."""
    from chip_smoke import sponge_blocks
    from tapstark.airs.blake3_compression import Blake3SpongeChainAir, generate_blake3_sponge_trace
    from tapstark.challenger import BfChallenger
    from tapstark.field import F

    msgs = sponge_blocks(blocks)
    trace, pis, digest = generate_blake3_sponge_trace(msgs)
    ch = BfChallenger()
    for blk in msgs:
        ch.observe_u32s(blk)
    assert digest == ch.cv, "the AIR's digest differs from the challenger's"
    return trace, [F(x) for x in pis], Blake3SpongeChainAir()


@contextlib.contextmanager
def quotient_op_by_op():
    """Inside, a `jax.jit` made at run time returns its function unjitted:
    the JAX package's quotient (whose program `quotient_values` jits at
    run time) then runs its jnp ops one by one, with the same exact words.
    XLA's compile of the 1548-column AIRs' ~57,000-op program ran for more
    than 25 minutes and past 96 GiB on the H100 host's CPU at the 4-block
    sponge, and it is no part of what the port is held to."""
    import jax

    real = jax.jit
    jax.jit = lambda fn=None, **kw: fn if fn is not None else (lambda f: f)
    try:
        yield
    finally:
        jax.jit = real


def run(name, air_name, log_n, log_blowup, nq, pow_bits, log_final=0, emit=True, mesh=False) -> None:
    from tapstark.airs import FibonacciAir, generate_fibonacci_trace
    from tapstark.airs.recursion import RecursionAir, generate_recursion_trace
    from tapstark.challenger import BfChallenger
    from tapstark.field import F
    from tapstark.stark import prove, verify
    from tapstark.stark.script_verifier import generate_script_verifier
    from tapstark.stark.serde import proof_to_bytes

    pcs = make_pcs(log_blowup, nq, pow_bits, log_final, cpu_mesh() if mesh else None)
    if air_name == "recursion":
        trace, pis = generate_recursion_trace(1 << log_n)
        pis, air = [F(x) for x in pis], RecursionAir()
    elif air_name == "sponge":  # 64 rows a compression
        trace, pis, air = sponge((1 << log_n) // 64)
    else:
        trace = generate_fibonacci_trace(0, 1, 1 << log_n)
        pis, air = [F(0), F(1), F(int(trace[-1, 1]))], FibonacciAir()
    t0 = time.perf_counter()
    with quotient_op_by_op() if air_name == "sponge" else contextlib.nullcontext():
        proof = prove(pcs, air, BfChallenger(), trace, pis)
    t1 = time.perf_counter()
    verify(pcs, air, BfChallenger(), proof, pis)
    t2 = time.perf_counter()
    report = generate_script_verifier(pcs, air, BfChallenger(), proof, pis) if emit else None
    t3 = time.perf_counter()
    data = proof_to_bytes(proof)
    out = {"name": name, "config": [air_name, log_n, log_blowup, nq, pow_bits, log_final],
           "mesh": len(jax.devices()) if mesh else None,
           "proof": [hashlib.sha256(data).hexdigest(), len(data), proof.opening_proof.pow_witness],
           "report": report_digest(report) if emit else None,
           "prove_s": t1 - t0, "verify_s": t2 - t1, "emit_s": t3 - t2}
    print(json.dumps(out), flush=True)


def verify_port_blake3(path: str = "chiprun_out/blake3_proof.bin") -> None:
    """The JAX package's verify on the port's flagship proof bytes
    (`chip_smoke.py` BLAKE3); raises if it rejects them."""
    from chip_smoke import BLAKE3
    from tapstark.challenger import BfChallenger
    from tapstark.stark import verify
    from tapstark.stark.serde import proof_from_bytes

    with open(path, "rb") as f:
        data = f.read()
    trace, pis, air = sponge(BLAKE3["blocks"])
    proof = proof_from_bytes(data)
    t0 = time.perf_counter()
    verify(make_pcs(BLAKE3["log_blowup"], BLAKE3["num_queries"], BLAKE3["pow_bits"]), air, BfChallenger(), proof, pis)
    out = {"name": "blake3 port proof", "config": ["sponge", trace.shape[0], BLAKE3["blocks"]],
           "proof": [hashlib.sha256(data).hexdigest(), len(data), proof.opening_proof.pow_witness],
           "jax_verify": "accepted", "verify_s": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)


CONFIGS = {
    "golden": [("golden", "fib", 3, 2, 28, 8)],
    "wide": [("wide row", "recursion", 18, 4, 16, 8, 5)],
    "small": [("WIDE_8", "recursion", 3, 1, 1, 2, 0, False)],
    "blake3_small": [("BLAKE3_SMALL", "sponge", 8, 1, 1, 2, 0, False)],
    "blake3": [("BLAKE3_64_PROOF", "sponge", 12, 1, 16, 4, 0, False)],
    "blake3_full": [("BLAKE3_PROOF", "sponge", 16, 1, 16, 4, 0, False)],
    "mesh": [("MESH_PROOF", "fib", 12, 1, 4, 4, 0, False, True)],
}


def main() -> None:
    for which in sys.argv[1:] or ["golden", "small"]:
        if which == "blake3_port":
            verify_port_blake3()
            continue
        for cfg in CONFIGS[which]:
            run(*cfg)


if __name__ == "__main__":
    main()
