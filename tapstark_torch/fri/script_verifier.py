"""FRI script verifier — emits the per-query Bitcoin-Script verification
expressions while natively re-verifying the proof.

Reference parity: fri/src/script_verifier.rs and the DSL fold
fold_row_with_expr (fri/src/two_adic_pcs.rs:153-200). Per query a dedicated
InputManager holds the witness (openings, betas, final poly) and prover hints
(multiplicative inverses, verified in-script). The in-script fold uses the
accumulated folded value for the queried point (linking the input openings
through every layer) and the committed sibling as witness.

Challenger-consistency expressions (sample/grind replay in script) live in
dsl.challenger_expr and are appended by the uni-stark script verifier.
"""

from __future__ import annotations

from ..challenger import BfChallenger
from ..dsl.expr import Expr, InputManager, ManagerAssign
from ..field.scalar import EF4, F
from .config import FriConfig
from .proof import FriProof
from .verifier import FriChallenges, FriError, verify_shape_and_sample_challenges


def bf_sample_challenges(
    config: FriConfig, proof: FriProof, challenger: BfChallenger
) -> FriChallenges:
    """Native transcript replay (the DSL challenger replay is emitted
    separately by the challenger-expression layer)."""
    return verify_shape_and_sample_challenges(config, proof, challenger)


def fold_row_with_expr(
    folded_eval: Expr,
    folded_native: EF4,
    sibling_eval: Expr,
    sibling_native: EF4,
    x: Expr,
    x_hint: F,
    point_index: int,
    index_sibling: int,
    beta: Expr,
    beta_native: EF4,
    manager: InputManager,
) -> tuple[Expr, EF4]:
    """One in-script fold: 2-point interpolation at beta. The FOLDED VALUE
    itself is the verified hint — the script checks the multiplied-through
    identity  (g - e0)*(xs1 - xs0) == (beta - xs0)*(e1 - e0)  instead of
    computing e0 + (beta - xs0)(e1 - e0)*inv, which replaces two chained
    dynamic extension Karatsubas (~17 KB each) with one plus an ext-by-base
    multiply, at the same hint-commitment count (g replaces inv)."""
    g1 = F.two_adic_generator(1)
    rev_x_hint = x_hint * g1
    xs_hint = [x_hint, x_hint]
    xs_hint[index_sibling % 2] = rev_x_hint

    if index_sibling % 2 == 0:
        xs_0 = x * Expr.constant(g1)
        xs_1 = x
    else:
        xs_0 = x
        xs_1 = x * Expr.constant(g1)

    evals = [None, None]
    evals[index_sibling % 2] = sibling_eval
    evals[(index_sibling + 1) % 2] = folded_eval
    evals_n = [None, None]
    evals_n[index_sibling % 2] = sibling_native
    evals_n[(index_sibling + 1) % 2] = folded_native

    d_inv = (xs_hint[1] - xs_hint[0]).inverse()
    g_native = evals_n[0] + (
        beta_native - EF4.from_base(xs_hint[0])
    ) * (evals_n[1] - evals_n[0]) * EF4.from_base(d_inv)
    g_in = manager.assign_hint_input_f(g_native)
    manager.add_hint_verify(
        ((g_in - evals[0]) * (xs_1 - xs_0)).equal_verify(
            (beta - xs_0) * (evals[1] - evals[0])
        )
    )
    return g_in, g_native


def bf_verify_challenges(
    config: FriConfig,
    proof: FriProof,
    challenges: FriChallenges,
    open_input,
) -> ManagerAssign:
    """open_input(qti, query_index, input_proof, manager, manager_assign) ->
    list[(log_height, reduced-opening Expr)] descending. Builds one manager
    per FRI query (reference fri/src/script_verifier.rs:85-140); wide traces
    may spill the reduced-opening computation into extra chained sub-managers
    (see TwoAdicFriPcs.generate_verify_expr)."""
    log_max_height = (
        len(proof.commit_phase_commits)
        + config.log_blowup
        + config.log_final_poly_len
    )
    manager_assign = ManagerAssign()
    for (qti, query_index), query_proof in zip(
        challenges.query_indices, proof.query_proofs
    ):
        manager = manager_assign.next_manager(
            f"fri-pcs-verify query_index:{query_index}"
        )
        ro = open_input(
            qti, query_index, query_proof.input_proof, manager, manager_assign
        )
        folded_eval, x_final, folded_native = _bf_verify_query(
            config,
            proof,
            query_index,
            qti,
            query_proof,
            challenges.betas,
            ro,
            log_max_height,
            manager,
        )
        if config.log_final_poly_len == 0:
            assert folded_native == proof.final_poly, "native fold mirror drift"
            final_poly_input = manager.assign_input_f(proof.final_poly)
            manager.set_exec_dsl(folded_eval.equal(final_poly_input))
        else:
            # Horner evaluation of the committed final coefficients at the
            # query's stop-domain point (one ext-by-base multiply per
            # coefficient); the coefficients are shared witness values
            # across every query segment.
            coeff_in = [manager.assign_input_f(c) for c in proof.final_poly]
            acc = coeff_in[-1]
            for c_in in reversed(coeff_in[:-1]):
                acc = acc * x_final + c_in
            manager.set_exec_dsl(folded_eval.equal(acc))
    return manager_assign


def _bf_verify_query(
    config: FriConfig,
    proof: FriProof,
    query_index: int,
    qti: int,
    query_proof,
    betas: list[EF4],
    reduced_openings,
    log_max_height: int,
    manager: InputManager,
) -> Expr:
    ro_iter = iter(reduced_openings)
    ro_next = next(ro_iter, None)
    folded_eval = Expr.constant(EF4.zero())
    folded_native = EF4.zero()

    # x = g_{log_max}^{reverse_bits(index)} computed IN SCRIPT from the index
    x = Expr.constant_num(query_index).index_to_rou(log_max_height)
    from ..utils import reverse_bits_len

    x_hint = F.two_adic_generator(log_max_height).exp(
        reverse_bits_len(query_index, log_max_height)
    )

    for log_folded_height, commit, step, beta in zip(
        range(log_max_height - 1, -1, -1),
        proof.commit_phase_commits,
        query_proof.commit_phase_openings,
        betas,
    ):
        point_index = query_index & 1
        index_sibling = point_index ^ 1

        if ro_next is not None and ro_next[0] == log_folded_height + 1:
            folded_eval = folded_eval + ro_next[1]
            folded_native = folded_native + ro_next[2]
            ro_next = next(ro_iter, None)

        opened_values, commited_proof = step
        assert len(opened_values) == 1
        if not config.mmcs.verify_batch(qti, opened_values, commited_proof, commit):
            raise FriError("CommitPhaseMmcsError")

        sibling_native = opened_values[0][index_sibling]
        folded_eval, folded_native = fold_row_with_expr(
            folded_eval,
            folded_native,
            manager.assign_input_f(sibling_native),
            sibling_native,
            x,
            x_hint,
            point_index,
            index_sibling,
            manager.assign_input_f(beta),
            beta,
            manager,
        )

        query_index >>= 1
        if log_folded_height != 1:
            x = x.square()
            x_hint = x_hint * x_hint

    # Absorb inputs entering exactly at the stop height (zero-fold-layer
    # case included) — mirrors the native verifier's post-loop absorption.
    log_stop = config.log_blowup + config.log_final_poly_len
    if ro_next is not None and ro_next[0] == log_stop:
        folded_eval = folded_eval + ro_next[1]
        folded_native = folded_native + ro_next[2]
        ro_next = next(ro_iter, None)
    assert ro_next is None, "input below the FRI stop height"

    assert query_index < config.blowup() * config.final_poly_len()
    if config.log_final_poly_len > 0:
        # x must sit at the stop height for the final Horner evaluation
        log_m = config.log_blowup + config.log_final_poly_len
        assert log_m >= 2, "log_blowup + log_final_poly_len must be >= 2"
        assert x_hint == F.two_adic_generator(log_m).exp(
            reverse_bits_len(query_index, log_m)
        ), "script x diverged from the stop-domain point"
    return folded_eval, x, folded_native
