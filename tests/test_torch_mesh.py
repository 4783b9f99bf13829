"""The port's device mesh (tapstark_torch.mesh, the PCS's mesh route)
against the JAX package's (tapstark.mesh on the 8 virtual CPU devices of
tests/conftest.py), on 8 CPU shards.

Inputs are canonical values from numpy's seeded generator, as Montgomery
words, handed to both packages; the sharded step's are its own example
arguments, which both packages draw alike. Field arithmetic and proofs are
exact: every comparison is equality of words or bytes.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

import tapstark.airs as jairs
from tapstark.field import P
from tapstark.field.device import np_to_mont
from tapstark.mesh import distributed_coset_lde as j_distributed_coset_lde
from tapstark.mesh import distributed_ntt as j_distributed_ntt
from tapstark.mesh import make_sharded_prover_step as j_make_sharded_prover_step
from tapstark.mesh.ntt import AXIS
from tapstark.stark.config import standard_config as j_standard_config
from tapstark_torch.airs import FibonacciAir, generate_fibonacci_trace
from tapstark_torch.challenger import BfChallenger
from tapstark_torch.commit import BcManager, TapTreeMmcs
from tapstark_torch.field import F
from tapstark_torch.fri import FriConfig, TwoAdicFriPcs
from tapstark_torch.interop import config_from_reference, mont_np_from_tensor, tensor_from_mont_np
from tapstark_torch.mesh import (
    Mesh,
    collectives,
    distributed_coset_lde,
    distributed_ntt,
    dryrun_multichip,
    make_sharded_prover_step,
)
from tapstark_torch.stark import prove, verify
from tapstark_torch.stark.config import standard_config
from tapstark_torch.stark.serde import proof_to_bytes

SHARDS = 8
# tests/test_mesh_prover.py's configuration proved through the JAX
# package's PCS over its 8-device CPU mesh: (sha256, bytes, PoW witness),
# frozen by `python tools/freeze_port_references.py mesh`
MESH_PROOF = ("be45c3dbde523ac192462b5041672f4cf652d41557c133de2c30507e54ec2358", 416941, 11)


def _j_mesh():
    return JMesh(np.array(jax.devices()[:SHARDS]), (AXIS,))


def _same(t, j, what) -> None:
    np.testing.assert_array_equal(mont_np_from_tensor(t), np.asarray(j), err_msg=what)


def test_distributed_lde_and_sharded_step_match_jax():
    """distributed_ntt, its inverse (round trip) and distributed_coset_lde
    (blowup 2 and 4) at log_n 6 and 8, and the sharded prover step's four
    outputs at log_n 6 (Fibonacci, blowup 2, 8 PoW bits), each equal to
    the JAX package's on its mesh, word for word; the exchanges counted."""
    jmesh, mesh = _j_mesh(), Mesh(["cpu"] * SHARDS)
    rng = np.random.default_rng(0)
    shift = F.generator().v
    collectives.reset_counts()
    for log_n in (6, 8):
        x = np_to_mont(rng.integers(0, P, (1 << log_n, 3)).astype(np.uint32))
        y = distributed_ntt(mesh, tensor_from_mont_np(x, "cpu"))
        _same(y, j_distributed_ntt(jmesh, jnp.asarray(x)), f"ntt 2^{log_n}")
        back = distributed_ntt(mesh, y, inverse=True)
        _same(back, x, f"inverse 2^{log_n}")
        _same(back, j_distributed_ntt(jmesh, jnp.asarray(mont_np_from_tensor(y)), inverse=True), f"intt 2^{log_n}")
        for log_blowup in (1, 2):
            _same(distributed_coset_lde(mesh, tensor_from_mont_np(x, "cpu"), log_blowup, shift),
                  j_distributed_coset_lde(jmesh, jnp.asarray(x), log_blowup, shift), f"lde 2^{log_n} x {log_blowup}")
    # each transform: scatter, all_to_all, gather; a coset LDE two transforms
    assert collectives.counts["exchanges"] == 2 * (3 * 2 + 2 * 6)
    assert collectives.counts["copies"] > 0 and collectives.counts["bytes"] > 0

    step, args = make_sharded_prover_step(mesh, FibonacciAir(), log_n=6, log_blowup=1)
    j_step, j_args = j_make_sharded_prover_step(jmesh, jairs.FibonacciAir(), log_n=6, log_blowup=1)
    for a, ja in zip(args, j_args):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(ja))
    got, want = step(*args), jax.block_until_ready(j_step(*j_args))
    for name, g, w in zip(("lde", "quotient", "folded"), got[:3], want[:3]):
        assert tuple(g.shape) == tuple(w.shape), name
        _same(g, w, name)
    assert int(got[3]) == int(want[3])


def _pcs(device, mesh=None):
    nq = 4
    fri = FriConfig(log_blowup=1, num_queries=nq, proof_of_work_bits=4, mmcs=TapTreeMmcs(BcManager(), nq, ext=True))
    return TwoAdicFriPcs(TapTreeMmcs(BcManager(), nq, ext=False), fri, device, mesh=mesh)


def test_mesh_prove_matches_one_device_and_frozen_jax():
    """tests/test_mesh_prover.py's configuration (Fibonacci 2^12 rows,
    blowup 2, 4 queries, 4 PoW bits): the port's prove through a PCS over
    8 CPU shards equals its one-device prove and the JAX package's mesh
    prove (MESH_PROOF) byte for byte, and verifies. Then the other mesh
    entry points: dryrun_multichip on 8 CPU shards, standard_config and
    config_from_reference on a mesh, and the refusals (no card here)."""
    trace = generate_fibonacci_trace(0, 1, 1 << 12)
    pis = [F(0), F(1), F(int(trace[-1, 1]))]
    mesh = Mesh(["cpu"] * SHARDS)
    one = proof_to_bytes(prove(_pcs("cpu"), FibonacciAir(), BfChallenger(), trace, pis))
    collectives.reset_counts()
    proof = prove(_pcs("cpu", mesh), FibonacciAir(), BfChallenger(), trace, pis)
    data = proof_to_bytes(proof)
    assert collectives.counts["exchanges"] == 2 * 6  # the trace's and the quotient's LDE over the mesh
    assert data == one
    assert (hashlib.sha256(data).hexdigest(), len(data), proof.opening_proof.pow_witness) == MESH_PROOF
    verify(_pcs("cpu"), FibonacciAir(), BfChallenger(), proof, pis)

    lde, quotient, folded, winner = dryrun_multichip(SHARDS, devices=["cpu"] * SHARDS)
    assert tuple(lde.shape) == (2 << 14, 2) and tuple(quotient.shape) == (2 << 14, 4)
    assert tuple(folded.shape) == (1 << 14, 4) and lde.device.type == "cpu"

    config = standard_config(mesh=mesh)
    assert config.pcs.mesh is mesh and config.pcs.device.type == "cpu"
    ref = j_standard_config(mesh=_j_mesh())
    for devices in (None, ["cpu"] * SHARDS):
        ported = config_from_reference(ref, "cpu", devices)
        assert ported.pcs.mesh.size == SHARDS and ported.pcs.mesh.primary.type == "cpu"
    assert config_from_reference(j_standard_config(), "cpu").pcs.mesh is None

    with pytest.raises(RuntimeError):
        Mesh.cards(1)
    with pytest.raises(RuntimeError):
        dryrun_multichip(SHARDS)
    with pytest.raises(ValueError):
        standard_config(mesh=mesh, device="cuda")
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 3)
