"""FRI verifier, exact host arithmetic (twin of `tapstark.fri.verifier`,
which cannot be imported without jax).

Behavioral port of the reference's fri/src/verifier.rs: re-derive betas from
the transcript, check the PoW witness, sample query indices, then per query
walk the commit-phase layers top-down, folding via 2-point interpolation at
beta and absorbing reduced openings at matching heights; the final value must
equal the proof's constant final_poly.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..challenger import BfChallenger
from ..field.scalar import EF4, F
from ..poly.fold import fold_row_scalar
from ..utils import reverse_bits_len
from .config import FriConfig
from .proof import FriProof


class FriError(Exception):
    pass


@dataclass
class FriChallenges:
    query_indices: list[tuple[int, int]]
    betas: list[EF4]


def verify_shape_and_sample_challenges(
    config: FriConfig, proof: FriProof, challenger: BfChallenger
) -> FriChallenges:
    betas = []
    for comm in proof.commit_phase_commits:
        challenger.observe_commitment(comm)
        betas.append(challenger.sample())

    if config.log_final_poly_len > 0:
        # bind the early-stop final coefficients before query sampling
        # (mirrors bf_prove; see the soundness note there)
        if (
            not isinstance(proof.final_poly, list)
            or len(proof.final_poly) != config.final_poly_len()
        ):
            raise FriError("InvalidProofShape")
        for c in proof.final_poly:
            challenger.observe_u32s(c.as_u32_vec())

    if len(proof.query_proofs) != config.num_queries:
        raise FriError("InvalidProofShape")

    if not challenger.check_witness(config.proof_of_work_bits, proof.pow_witness):
        raise FriError("InvalidPowWitness")

    log_max_height = (
        len(proof.commit_phase_commits)
        + config.log_blowup
        + config.log_final_poly_len
    )
    query_indices = [
        (qti, challenger.sample_bits(log_max_height))
        for qti in range(config.num_queries)
    ]
    return FriChallenges(query_indices=query_indices, betas=betas)


def verify_challenges(
    config: FriConfig,
    proof: FriProof,
    challenges: FriChallenges,
    open_input,
) -> None:
    """open_input(query_times_index, query_index, input_proof) ->
    list[(log_height, reduced_opening)] descending."""
    log_max_height = (
        len(proof.commit_phase_commits)
        + config.log_blowup
        + config.log_final_poly_len
    )
    for (qti, query_index), query_proof in zip(
        challenges.query_indices, proof.query_proofs
    ):
        ro = open_input(qti, query_index, query_proof.input_proof)
        folded_eval, final_index = _verify_query(
            config,
            proof.commit_phase_commits,
            query_index,
            qti,
            query_proof,
            challenges.betas,
            ro,
            log_max_height,
        )
        if config.log_final_poly_len == 0:
            if folded_eval != proof.final_poly:
                raise FriError("FinalPolyMismatch")
        else:
            # evaluate the final polynomial at the query's point in the stop
            # domain: x = g_m^{rev(index)}, m = blowup * 2^L
            log_m = config.log_blowup + config.log_final_poly_len
            x = F.two_adic_generator(log_m).exp(
                reverse_bits_len(final_index, log_m)
            )
            acc = EF4.zero()
            for c in reversed(proof.final_poly):
                acc = acc * EF4.from_base(x) + c
            if folded_eval != acc:
                raise FriError("FinalPolyMismatch")


def _verify_query(
    config: FriConfig,
    commit_phase_commits,
    query_index: int,
    qti: int,
    proof,
    betas,
    reduced_openings,
    log_max_height: int,
) -> tuple[EF4, int]:
    folded_eval = EF4.zero()
    ro_iter = iter(reduced_openings)
    ro_next = next(ro_iter, None)

    for log_folded_height, commit, step, beta in zip(
        range(log_max_height - 1, -1, -1),
        commit_phase_commits,
        proof.commit_phase_openings,
        betas,
    ):
        point_index = query_index & 1

        if ro_next is not None and ro_next[0] == log_folded_height + 1:
            folded_eval = folded_eval + ro_next[1]
            ro_next = next(ro_iter, None)

        opened_values, commit_proof = step
        if len(opened_values) != 1:
            raise FriError("InvalidProofShape: a commit-phase layer holds one matrix")
        commited_folded_eval = opened_values[0][point_index]
        # The reference only performs this check below the top layer
        # (fri/src/verifier.rs:144-146); at the top layer the committed
        # matrix IS the reduced-opening vector, so for honest proofs the
        # equality holds there too — we check every layer (strictly
        # stronger, linking the input openings to commit-phase layer 0).
        if folded_eval != commited_folded_eval:
            raise FriError("folded eval mismatch with committed layer value")

        if not config.mmcs.verify_batch(qti, opened_values, commit_proof, commit):
            raise FriError("CommitPhaseMmcsError")

        query_index >>= 1
        folded_eval = fold_row_scalar(
            query_index,
            log_folded_height,
            beta,
            opened_values[0][0],
            opened_values[0][1],
        )

    # Inputs entering exactly at the stop height (including the degenerate
    # zero-fold-layer case, where the whole input IS the final polynomial)
    # are never absorbed by the loop above — fold them in here.
    log_stop = config.log_blowup + config.log_final_poly_len
    if ro_next is not None and ro_next[0] == log_stop:
        folded_eval = folded_eval + ro_next[1]
        ro_next = next(ro_iter, None)
    if ro_next is not None:
        raise FriError(f"input at log height {ro_next[0]} below the FRI stop height")

    if query_index >= config.blowup() * config.final_poly_len():
        raise FriError(f"index out of range: {query_index}")
    return folded_eval, query_index
