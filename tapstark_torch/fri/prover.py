"""FRI prover: commit and fold, taptree commits per layer (twin of
`tapstark.fri.prover`; reference fri/src/prover.rs).

- commit phase: while the layer is longer than blowup · 2^L, commit the
  (n/2, 2) fold matrix, observe the roots, sample beta, fold, absorb any
  input of the new height (prover.rs:92-141); with L =
  log_final_poly_len > 0 the last folded layer's 2^L coefficients are the
  final polynomial, observed before the grind;
- PoW grind (host); query phase: num_queries indices, each opening the
  input rounds and every commit-phase layer (prover.rs:45-59).

Inputs are (n, 4) extension Montgomery tensors sorted by descending
length. A layer folded on the card commits its tensor, so its trees hash on
the card; the host tail commits canonical numpy arrays on the host engine.
"""

from __future__ import annotations

import numpy as np
import torch

from ..challenger import BfChallenger
from ..commit.tcs import FMatrix
from ..field.constants import P
from ..field.device import ef_add, ef_const, fetch_canonical, to_mont
from ..field.scalar import EF4
from ..poly.fold import fold_matrix, fold_matrix_host
from ..poly.ntt import intt
from ..utils import bitrev_indices, log2_strict
from ..utils.profiling import span
from .config import FriConfig
from .proof import BfQueryProof, FriProof

# Layers that fold to at most this many rows fold and commit on the host.
# Measured on an H100 80GB HBM3 (700 W), with layer trees hashed on the
# card (chip_smoke.py): one 28-repetition layer's fold + commit costs
# 18-35 ms on the host and 23-49 ms on the card up to 2^12 rows, but
# 42-57 ms on the host and 25-47 ms on the card at 2^14 (the eager fold's
# ~400 launches and the host keygen are in both; PERF.md, "FRI host tail").
HOST_TAIL_MAX_HALF = 1 << 13


def bf_prove(
    config: FriConfig,
    inputs: list[torch.Tensor],
    challenger: BfChallenger,
    open_input,
) -> FriProof:
    if any(inputs[i].shape[0] < inputs[i + 1].shape[0] for i in range(len(inputs) - 1)):
        raise ValueError("inputs must be sorted by descending length")
    log_max_height = log2_strict(int(inputs[0].shape[0]))
    dev = inputs[0].device

    with span("fri/commit-phase", dev):
        commits, data, final_poly = _commit_phase(config, inputs, challenger)

    # With L > 0 the final coefficients come from the last folded layer,
    # which no commitment covers: they enter the transcript before the
    # grind and the query indices. L = 0 keeps the reference's transcript.
    if config.log_final_poly_len > 0:
        for c in final_poly:
            challenger.observe_u32s(c.as_u32_vec())

    with span("fri/grind"):
        pow_witness = challenger.grind(config.proof_of_work_bits, device=dev)

    with span("fri/queries"):
        query_proofs = []
        for qti in range(config.num_queries):
            query_index = challenger.sample_bits(log_max_height)
            query_proofs.append(
                BfQueryProof(
                    input_proof=open_input(qti, query_index),
                    commit_phase_openings=[
                        config.mmcs.open_batch(qti, query_index >> i >> 1, layer_data)
                        for i, layer_data in enumerate(data)
                    ],
                )
            )

    return FriProof(
        commit_phase_commits=commits,
        query_proofs=query_proofs,
        final_poly=final_poly,
        pow_witness=pow_witness,
    )


def _commit_phase(config: FriConfig, inputs: list[torch.Tensor], challenger: BfChallenger):
    folded = inputs[0]  # (n, 4) Montgomery tensor, until the host tail
    pending = list(inputs[1:])
    folded_host = None  # canonical (n, 4) numpy once the host tail starts
    commits, data = [], []

    stop = config.blowup() * config.final_poly_len()
    while (folded_host if folded_host is not None else folded).shape[0] > stop:
        half = (folded_host if folded_host is not None else folded).shape[0] // 2
        if folded_host is None and half <= HOST_TAIL_MAX_HALF:
            folded_host = fetch_canonical(folded)
            pending = [fetch_canonical(p) for p in pending]
        if folded_host is not None:
            mat = FMatrix(folded_host.reshape(half, 2, 4))
        else:
            mat_dev = folded.reshape(half, 2, 4)
            mat = FMatrix(dev=mat_dev)
        commit, prover_data = config.mmcs.commit_matrix(mat)
        challenger.observe_commitment(commit)
        beta: EF4 = challenger.sample()
        commits.append(commit)
        data.append(prover_data)

        if folded_host is not None:
            folded_host = fold_matrix_host(beta, mat.values)
            if pending and pending[0].shape[0] == half:
                total = folded_host.astype(np.uint64) + pending.pop(0)
                folded_host = (total % np.uint64(P)).astype(np.uint32)
        else:
            folded = fold_matrix(ef_const(beta, folded.device), mat_dev)
            if pending and pending[0].shape[0] == half:
                folded = ef_add(folded, pending.pop(0))

    if pending:
        raise ValueError("an input height was never absorbed (log_final_poly_len too large?)")
    final_host = folded_host if folded_host is not None else fetch_canonical(folded)
    if final_host.shape[0] != stop:
        raise ValueError(f"the last layer holds {final_host.shape[0]} rows, not blowup * 2^L = {stop}")
    if config.log_final_poly_len == 0:
        # `blowup` evaluations of a constant polynomial
        final_poly = EF4([int(x) for x in final_host[0]])
        if any(EF4([int(x) for x in row]) != final_poly for row in final_host):
            raise RuntimeError("final poly is not constant")
        return commits, data, final_poly

    # blowup · 2^L bit-reversed evaluations of a degree < 2^L polynomial
    # over the natural domain of that size: the coefficients are the iNTT
    # of each extension component (base-field twiddles), on the host; the
    # high ones must vanish.
    nat = final_host[bitrev_indices(log2_strict(stop))]
    coeffs = fetch_canonical(intt(to_mont(nat)))
    flen = config.final_poly_len()
    if coeffs[flen:].any():
        raise RuntimeError("final poly exceeds the declared degree")
    return commits, data, [EF4([int(x) for x in row]) for row in coeffs[:flen]]
