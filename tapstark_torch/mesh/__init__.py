"""The device mesh (twin of `tapstark.mesh`): a four-step NTT and coset
LDE spread over several devices, and the sharded prover step.

The JAX package is single-controller: one process runs the prover's host
pipeline (transcript, keygen, queries) and XLA spreads the LDE over
`jax.devices()`. The port keeps that shape. A `Mesh` is an ordered tuple
of devices, a power of two of them, driven from one process; the shards
exchange blocks by copies between their devices (`collectives.py`), which
go card to card on an NVLink host. A mesh may list one device several
times: eight shards on the CPU (the tests' counterpart of the JAX
package's eight virtual CPU devices), or four on one card, where every
shard's kernels and every exchange run but nothing crosses a link.
"""

from __future__ import annotations

import torch

from ..utils import log2_strict


def normalize_device(device) -> torch.device:
    """`device` as a torch.device with its index: a bare "cuda" is the
    current card (card 0 where there is none)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return d


class Mesh:
    """An ordered tuple of devices, a power of two of them, all CPUs or all
    CUDA devices; shard d runs on `devices[d]`."""

    AXIS = "shard"  # the JAX package's mesh axis name (tapstark/mesh/ntt.py AXIS)

    def __init__(self, devices):
        devs = tuple(normalize_device(d) for d in devices)
        if not devs:
            raise ValueError("Mesh: no devices")
        log2_strict(len(devs))  # raises unless a power of two
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"Mesh: expected CPUs only or CUDA devices only, got {[str(d) for d in devs]}")
        self.devices = devs

    @classmethod
    def cards(cls, n: int) -> "Mesh":
        """The first n CUDA devices; raises if there are fewer (never falls
        back to the CPU or to fewer shards)."""
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"Mesh.cards: {n} CUDA devices asked for, {have} present")
        return cls([torch.device("cuda", i) for i in range(n)])

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def log_size(self) -> int:
        return log2_strict(len(self.devices))

    @property
    def primary(self) -> torch.device:
        """The device that holds a whole array before and after a
        distributed step (the PCS's device)."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


from .dryrun import dryrun_multichip  # noqa: E402
from .ntt import distributed_coset_lde, distributed_ntt  # noqa: E402
from .prover_step import make_sharded_prover_step  # noqa: E402

__all__ = ["Mesh", "distributed_ntt", "distributed_coset_lde", "make_sharded_prover_step", "dryrun_multichip"]
