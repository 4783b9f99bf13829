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
the card, and takes its beta from the device transcript chain
(challenger/device_tail.py) with no round trip to the host; the host tail
commits canonical numpy arrays on the host engine. The openings' leaf
blocks and paths left on the card come to the host in one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..challenger import BfChallenger
from ..challenger.device_tail import DeviceTailChain, chain_supported
from ..commit.device_commit import to_host
from ..commit.tcs import FMatrix, materialize_path_plans
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
    extra_query_index_bits: int = 0,
    plan_input=None,
    device_chain: bool = True,
) -> FriProof:
    """`plan_input(qti, query_index)` lists the input rounds' gathers of a
    query (`CommitedData.plan_query`); `device_chain=False` samples every
    layer's beta on the host (same bytes: the chain is a twin)."""
    if any(inputs[i].shape[0] < inputs[i + 1].shape[0] for i in range(len(inputs) - 1)):
        raise ValueError("inputs must be sorted by descending length")
    log_max_height = log2_strict(int(inputs[0].shape[0]))
    dev = inputs[0].device

    with span("fri/commit-phase", dev):
        commits, data, final_poly = _commit_phase(config, inputs, challenger, device_chain)

    # With L > 0 the final coefficients come from the last folded layer,
    # which no commitment covers: they enter the transcript before the
    # grind and the query indices. L = 0 keeps the reference's transcript.
    if config.log_final_poly_len > 0:
        for c in final_poly:
            challenger.observe_u32s(c.as_u32_vec())

    with span("fri/grind"):
        pow_witness = challenger.grind(config.proof_of_work_bits, device=dev)

    # Every query index first (openings never touch the challenger, so the
    # transcript is the same), then every opening's leaf blocks and paths
    # left on the card, copied in one copy, then the openings.
    query_indices = [
        challenger.sample_bits(log_max_height + extra_query_index_bits)
        for _ in range(config.num_queries)
    ]
    plans = []
    for qti, query_index in enumerate(query_indices):
        if plan_input is not None:
            plans += plan_input(qti, query_index)
        index = query_index >> extra_query_index_bits
        for i, layer_data in enumerate(data):
            plans += layer_data[qti].plan_query(index >> i >> 1)
    with span("fri/path-prefetch", dev):
        materialize_path_plans(plans)

    with span("fri/queries"):
        query_proofs = []
        for qti, query_index in enumerate(query_indices):
            index = query_index >> extra_query_index_bits
            query_proofs.append(
                BfQueryProof(
                    input_proof=open_input(qti, query_index),
                    commit_phase_openings=[
                        config.mmcs.open_batch(qti, index >> i >> 1, layer_data)
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


def _commit_phase(config: FriConfig, inputs: list[torch.Tensor], challenger: BfChallenger, device_chain: bool):
    folded = inputs[0]  # (n, 4) Montgomery tensor, until the host tail
    pending = list(inputs[1:])
    folded_host = None  # canonical (n, 4) numpy once the host tail starts
    commits, data = [], []

    # The device transcript chain: a layer folded on the card commits
    # without copying its roots (a deferred commit), its beta comes from
    # `transcript_step` on those roots, and the fold follows at once, with
    # no round trip to the host. `flush_chain` catches the host challenger
    # up before anything else touches it: one copy of every chained
    # layer's roots and popped words, the host's observe_commitment and
    # sample replayed (its records are what the script verifier replays),
    # each popped word held against the chain's.
    chain_on = device_chain and chain_supported(challenger, config.mmcs.num_queries)
    chain = None
    deferred = []  # (slot in commits and data, DeferredDeviceCommit, popped words on the card)

    def flush_chain():
        nonlocal chain
        chain = None  # a later chain snapshots the caught-up challenger
        if not deferred:
            return
        handles = [h for _, dfr, words in deferred for h in (*dfr.root_handles, words)]
        with span("fri/chain-flush", handles[0].device):
            fetched = to_host(handles)
        pos = 0
        for slot, dfr, _ in deferred:
            prover_data = dfr.finalize(fetched[pos : pos + dfr.num_groups])
            words = [int(w) for w in fetched[pos + dfr.num_groups]]
            pos += dfr.num_groups + 1
            commitment = [d.root_words() for d in prover_data]
            challenger.observe_commitment(commitment)
            challenger.sample()
            if challenger.sample_input[-1] != words:
                raise RuntimeError(
                    f"FRI layer {slot}: the device transcript chain sampled {words}, "
                    f"the host challenger {challenger.sample_input[-1]}"
                )
            commits[slot] = commitment
            data[slot] = prover_data
        deferred.clear()

    stop = config.blowup() * config.final_poly_len()
    while (folded_host if folded_host is not None else folded).shape[0] > stop:
        half = (folded_host if folded_host is not None else folded).shape[0] // 2
        if folded_host is None and half <= HOST_TAIL_MAX_HALF:
            flush_chain()
            pending = [FMatrix.lazy(p) for p in pending]  # their copies overlap the layer's
            folded_host = fetch_canonical(folded)
        if folded_host is None and chain_on:
            mat_dev = folded.reshape(half, 2, 4)
            dfr = config.mmcs.commit_matrix_deferred(FMatrix(dev=mat_dev))
            if chain is None:
                chain = DeviceTailChain(challenger)
            beta_mont, beta_words = chain.step(dfr.roots_rep_order_dev())
            folded = fold_matrix(beta_mont, mat_dev)
            commits.append(None)
            data.append(None)
            deferred.append((len(commits) - 1, dfr, beta_words))
            if pending and pending[0].shape[0] == half:
                folded = ef_add(folded, pending.pop(0))
            continue
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
            if pending and pending[0].height == half:
                total = folded_host.astype(np.uint64) + pending.pop(0).values
                folded_host = (total % np.uint64(P)).astype(np.uint32)
        else:
            folded = fold_matrix(ef_const(beta, folded.device), mat_dev)
            if pending and pending[0].shape[0] == half:
                folded = ef_add(folded, pending.pop(0))

    flush_chain()  # before the final polynomial's observation and the grind
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
