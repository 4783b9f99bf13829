"""Carry-across between the JAX package and the port (used by the tests).

Field arrays cross as Montgomery words: numpy uint32 on the JAX side,
int32 tensors here. Configurations cross by value: `pcs_from_reference`
(and `config_from_reference` around it) builds the port's own
TapTreeMmcs and BcManager from the reference object's fields, so both
packages derive the same bit-commitment secrets in the same order.
Proofs cross as bytes: the two serdes write the same format. Nothing of
the JAX package is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from .commit import BcManager, TapTreeMmcs
from .fri.config import FriConfig
from .fri.pcs import TwoAdicFriPcs
from .mesh import Mesh
from .stark.config import StarkConfig


def tensor_from_mont_np(a: np.ndarray, device) -> torch.Tensor:
    """Montgomery uint32 numpy array → int32 tensor of the same words on
    `device`."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(device)


def mont_np_from_tensor(t: torch.Tensor) -> np.ndarray:
    """int32 Montgomery tensor → uint32 numpy array of the same words."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def mmcs_from_reference(ref_mmcs) -> TapTreeMmcs:
    """The port's TapTreeMmcs for a JAX-package one: a BcManager with the
    same seed, at the same point of its secrets stream (BcManager derives
    secret k from (seed, k) alone)."""
    manager = BcManager(ref_mmcs.manager._seed)
    manager._counter = ref_mmcs.manager._counter
    return TapTreeMmcs(manager, ref_mmcs.num_queries, ref_mmcs.ext)


def pcs_from_reference(ref_pcs, device, mesh=None) -> TwoAdicFriPcs:
    """The port's PCS for a JAX-package `TwoAdicFriPcs`, with the port's
    own copies of its input mmcs and its FRI mmcs (and `mesh`, whose
    primary device is `device`)."""
    f = ref_pcs.fri
    fri = FriConfig(
        log_blowup=f.log_blowup,
        num_queries=f.num_queries,
        proof_of_work_bits=f.proof_of_work_bits,
        mmcs=mmcs_from_reference(f.mmcs),
        log_final_poly_len=f.log_final_poly_len,
    )
    return TwoAdicFriPcs(mmcs_from_reference(ref_pcs.mmcs), fri, device, mesh=mesh)


def config_from_reference(ref_config, device, devices=None) -> StarkConfig:
    """The port's StarkConfig for a JAX-package one, its PCS on `device`.
    A reference PCS over a mesh of k devices becomes one over a port mesh
    of k shards: on `devices` where the caller names them (the first is
    then the PCS's device), else k shards on `device`."""
    ref_mesh = getattr(ref_config.pcs, "mesh", None)
    if ref_mesh is None:
        return StarkConfig(pcs=pcs_from_reference(ref_config.pcs, device))
    k = int(np.size(ref_mesh.devices))
    if devices is None:
        devices = [device] * k
    elif len(devices) != k:
        raise ValueError(f"config_from_reference: the reference mesh has {k} devices, {len(devices)} named")
    mesh = Mesh(devices)
    return StarkConfig(pcs=pcs_from_reference(ref_config.pcs, mesh.primary, mesh))
