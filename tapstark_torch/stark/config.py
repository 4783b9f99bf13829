"""StarkConfig — convenience bundle (twin of `tapstark.stark.config`;
reference uni-stark/src/config.rs StarkConfig/StarkGenericConfig).

The prove/verify functions take the PCS directly; this wrapper mirrors the
reference's config object shape and standard construction. The PCS lives
on the card unless the caller names another device."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..challenger import BfChallenger
from ..commit.bitcomm import BcManager
from ..commit.mmcs import TapTreeMmcs
from ..fri.config import FriConfig
from ..fri.pcs import TwoAdicFriPcs


@dataclass
class StarkConfig:
    pcs: TwoAdicFriPcs

    def challenger(self) -> BfChallenger:
        return BfChallenger(field="ext")


def standard_config(
    log_blowup: int = 2,
    num_queries: int = 28,
    proof_of_work_bits: int = 8,
    mesh=None,
    device=None,
    log_final_poly_len: int = 0,
) -> StarkConfig:
    """The fib_air-shaped configuration (uni-stark/tests/fib_air.rs:117-131)
    on `device`, the card by default: without one it raises, it never
    falls back to the CPU. With a mesh (`tapstark_torch.mesh.Mesh`) the
    PCS's LDEs run over it and the PCS lives on its primary device (a
    `device` named beside it must be that one)."""
    if mesh is not None and device is None:
        device = mesh.primary
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("standard_config: no CUDA device; pass device='cpu' to prove on the CPU")
        device = "cuda"
    fri = FriConfig(
        log_blowup=log_blowup,
        num_queries=num_queries,
        proof_of_work_bits=proof_of_work_bits,
        mmcs=TapTreeMmcs(BcManager(), num_queries, ext=True),
        log_final_poly_len=log_final_poly_len,
    )
    return StarkConfig(
        pcs=TwoAdicFriPcs(TapTreeMmcs(BcManager(), num_queries, ext=False), fri, device, mesh=mesh)
    )
