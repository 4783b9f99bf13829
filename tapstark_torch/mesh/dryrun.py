"""The multichip dry run (twin of `__graft_entry__.py:54 dryrun_multichip`)."""

from __future__ import annotations

from ..utils import log2_strict


def dryrun_multichip(n_devices: int, devices=None):
    """One sharded prover step (Fibonacci, blowup 2) over a mesh of
    `n_devices` shards at 2^max(14, 2·log n_devices + 1) trace rows, the
    height where the four-step split and its all_to_all do real work.
    The mesh is the first n_devices cards (raises with fewer), or
    `devices` where the caller names them (the tests: CPUs). Asserts the
    LDE's height; returns the step's outputs (lde, quotient, folded,
    winner) on the mesh's primary device."""
    from ..airs import FibonacciAir
    from . import Mesh
    from .prover_step import make_sharded_prover_step

    if devices is None:
        mesh = Mesh.cards(n_devices)
    else:
        if len(devices) != n_devices:
            raise ValueError(f"dryrun_multichip: {n_devices} devices asked for, {len(devices)} named")
        mesh = Mesh(devices)
    log_n = max(14, 2 * log2_strict(n_devices) + 1)
    step, args = make_sharded_prover_step(mesh, FibonacciAir(), log_n=log_n, log_blowup=1)
    out = step(*args)
    if out[0].shape[0] != 2 << log_n:
        raise AssertionError(f"dryrun_multichip: LDE of {out[0].shape[0]} rows, expected {2 << log_n}")
    return out
