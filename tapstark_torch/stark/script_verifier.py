"""uni-STARK Bitcoin-Script verifier emission.

Reference parity: uni-stark/src/script_verifier.rs (generate_script_verifier)
and uni-stark/src/scripts/bf_unistark.rs (compute_quotient_expr). Runs the
native verification AND emits the full on-chain verifier as a set of script
segments, each executed under the Tapscript interpreter:

  - per-FRI-query verification scripts (pcs.generate_verify_expr);
  - the quotient-reconstruction script (generator-power lookups and
    denominator-inverse hints);
  - the trace-constraint script (AIR evaluated by ScriptConstraintBuilder,
    accumulator checked against the native accumulator);
  - challenger-consistency scripts (sample replays; emitted once the
    in-script Blake3 permutation gadget is wired into dsl.challenger_expr).

Returns a report with per-segment script sizes and the dedup count of u32
witness values (the bit-commitment count — the reference README's metrics).
Spans (utils/profiling.py, when on): script/fri-pcs (query segments, with
the native opening checks), script/constraints (the trace-constraint
segments), script/run-segments (every segment compiled and executed),
script/challenger (the transcript replay, built and executed).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..air.folders import VerifierConstraintFolder
from ..air.symbolic import get_log_quotient_degree
from ..challenger import BfChallenger
from ..dsl.constraint_builder import (
    ScriptConstraintBuilder,
    emit_sharded_constraints,
)
from ..dsl.expr import Expr, InputManager, ManagerAssign
from ..dsl.lagrange import selectors_at_point_expr
from ..dsl.value_counter import ValueCounter
from ..field.scalar import EF4, F
from ..fri.pcs import TwoAdicFriPcs
from ..utils.profiling import span
from .proof import Proof
from .verifier import VerificationError


@dataclass
class ScriptVerifierReport:
    segment_script_bytes: dict[str, int] = field(default_factory=dict)
    total_script_bytes: int = 0
    distinct_u32_count: int = 0
    challenger_compressions: int = 0
    # the deduped committed-u32 value set behind distinct_u32_count —
    # lets callers itemize the count against the proof's contents
    # (tools/script_sizes.py wide-row itemization)
    u32_values: frozenset = frozenset()

    def total_kb(self) -> float:
        return self.total_script_bytes / 1024


def compute_quotient_expr(
    zeta: EF4,
    trace_degree: int,
    generator: F,
    quotient_chunk_nums: int,
    open_values: list[list[EF4]],
    denominator_inverse: list[F],
    quotient_res: EF4,
    manager: InputManager,
) -> None:
    """In-script reassembly of quotient(zeta) from the chunk openings
    (reference bf_unistark.rs:10-99): vanishing-ratio numerators from
    generator-power lookups, denominator inverses as verified hints."""
    assert len(open_values) == quotient_chunk_nums
    assert len(denominator_inverse) == quotient_chunk_nums

    open_in = [
        [manager.assign_input_f(v) for v in chunk] for chunk in open_values
    ]
    denom_inv_in = [manager.assign_hint_input_f(v) for v in denominator_inverse]

    zeta_div_a = Expr.constant(zeta) * Expr.constant(F.generator().inverse())

    # generator powers G^{-(k-1)} .. G^{k-1} (the reference's lookup table)
    k = quotient_chunk_nums
    inv_g = generator.inverse()

    def g_pow(e: int) -> F:
        return generator.exp(e) if e >= 0 else inv_g.exp(-e)

    numerators = []
    for i in range(k):
        acc = Expr.constant(EF4.one())
        for j in range(k):
            if j != i:
                w_j = Expr.constant(g_pow(-j))
                term = (zeta_div_a * w_j).exp_const(trace_degree) - Expr.constant(
                    EF4.one()
                )
                acc = acc * term
        numerators.append(acc)

    for i in range(k):
        acc = Expr.constant(F.one())
        for j in range(k):
            if j != i:
                term = Expr.constant(g_pow(i - j)).exp_const(
                    trace_degree
                ) - Expr.constant(F.one())
                acc = acc * term
        manager.add_hint_verify(
            (acc * denom_inv_in[i]).equal_verify_for_f(F.one())
        )

    quotient_zeta = Expr.constant(EF4.zero())
    for i in range(k):
        zps_i = denom_inv_in[i] * numerators[i]
        acc = Expr.constant(EF4.zero())
        for j in range(4):
            acc = acc + open_in[i][j] * Expr.constant(EF4.monomial(j))
        quotient_zeta = quotient_zeta + acc * zps_i

    manager.set_exec_dsl(quotient_zeta.equal_verify_for_f(quotient_res))


def generate_script_verifier(
    pcs: TwoAdicFriPcs,
    air,
    challenger: BfChallenger,
    proof: Proof,
    public_values: list[F],
    run_scripts: bool = True,
) -> ScriptVerifierReport:
    degree = 1 << proof.degree_bits
    log_quotient_degree = get_log_quotient_degree(air, len(public_values))
    quotient_degree = 1 << log_quotient_degree

    trace_domain = pcs.natural_domain_for_degree(degree)
    quotient_domain = trace_domain.create_disjoint_domain(
        1 << (proof.degree_bits + log_quotient_degree)
    )
    quotient_chunks_domains = quotient_domain.split_domains(quotient_degree)

    ov = proof.opened_values
    air_width = air.width()
    if not (
        len(ov.trace_local) == air_width
        and len(ov.trace_next) == air_width
        and len(ov.quotient_chunks) == quotient_degree
        and all(len(qc) == 4 for qc in ov.quotient_chunks)
    ):
        raise VerificationError("InvalidProofShape")

    challenger.observe_commitment(proof.commitments.trace)
    alpha: EF4 = challenger.sample()
    challenger.observe_commitment(proof.commitments.quotient_chunks)
    zeta: EF4 = challenger.sample()
    zeta_next = trace_domain.next_point(zeta)

    with span("script/fri-pcs"):
        manager_assign: ManagerAssign = pcs.generate_verify_expr(
            [
                (
                    proof.commitments.trace,
                    [
                        (
                            trace_domain,
                            [(zeta, ov.trace_local), (zeta_next, ov.trace_next)],
                        )
                    ],
                ),
                (
                    proof.commitments.quotient_chunks,
                    [
                        (domain, [(zeta, values)])
                        for domain, values in zip(
                            quotient_chunks_domains, ov.quotient_chunks
                        )
                    ],
                ),
            ],
            proof.opening_proof,
            challenger,
        )

    # native quotient reassembly (verifier.rs:103-132)
    zps = []
    denominator_inverse = []
    for i, domain in enumerate(quotient_chunks_domains):
        acc = EF4.one()
        dacc = F.one()
        for j, other_domain in enumerate(quotient_chunks_domains):
            if j == i:
                continue
            zp_first = other_domain.zp_at_point(
                EF4.from_base(domain.first_point())
            )
            acc = acc * (other_domain.zp_at_point(zeta) * zp_first.inverse())
            assert all(c == 0 for c in zp_first.c[1:])
            dacc = dacc * F(zp_first.c[0]).inverse()
        zps.append(acc)
        denominator_inverse.append(dacc)

    quotient = EF4.zero()
    for ch_i, ch in enumerate(ov.quotient_chunks):
        for e_i, c in enumerate(ch):
            quotient = quotient + zps[ch_i] * EF4.monomial(e_i) * c

    quotient_manager = manager_assign.next_manager("compute-quotient")
    compute_quotient_expr(
        zeta,
        degree,
        F.two_adic_generator(proof.degree_bits + log_quotient_degree),
        quotient_degree,
        ov.quotient_chunks,
        denominator_inverse,
        quotient,
        quotient_manager,
    )

    # native constraint check at zeta
    sels = trace_domain.selectors_at_point(zeta)
    folder = VerifierConstraintFolder(
        ov.trace_local, ov.trace_next, public_values, sels, alpha
    )
    air.eval(folder)
    folded_constraints = folder.accumulator
    if folded_constraints * sels.inv_zeroifier != quotient:
        raise VerificationError("OodEvaluationMismatch")

    # trace-constraint script. Wide AIRs (openings alone would exceed the
    # 1000-element stack) shard into chunked accumulator scripts with
    # bit-committed boundaries (dsl/constraint_builder.py).
    with span("script/constraints"):
        sels_expr = selectors_at_point_expr(F.one(), zeta, proof.degree_bits)
        if 8 * air_width + len(public_values) <= 600:
            constraint_manager = manager_assign.next_manager("trace-constraints")
            script_folder = ScriptConstraintBuilder(
                constraint_manager,
                ov.trace_local,
                ov.trace_next,
                public_values,
                sels_expr.is_first_row,
                sels_expr.is_last_row,
                sels_expr.is_transition,
                alpha,
            )
            air.eval(script_folder)
            constraint_manager.set_exec_dsl(
                script_folder.accumulator_expr().equal_verify_for_f(
                    folded_constraints
                )
            )
        else:
            recording = ScriptConstraintBuilder(
                None,
                ov.trace_local,
                ov.trace_next,
                public_values,
                sels_expr.is_first_row,
                sels_expr.is_last_row,
                sels_expr.is_transition,
                alpha,
            )
            air.eval(recording)
            emit_sharded_constraints(
                manager_assign, recording, alpha, folded_constraints
            )

    report = ScriptVerifierReport()
    counter = ValueCounter()
    with span("script/run-segments"):
        for m in manager_assign.managers:
            if run_scripts:
                m.run()
            size = m.get_script_len()
            report.segment_script_bytes[m.name] = size
            report.total_script_bytes += size
            counter.add_manager(m)
    report.distinct_u32_count = counter.get_value_num()
    report.u32_values = frozenset(counter._values)

    # challenger-consistency script: replay the whole Fiat-Shamir transcript
    # in-script (blake3 permutations chained on the stack) and check every
    # sampled challenge against its claimed value
    from ..dsl.challenger_expr import build_challenger_script
    from ..script.interpreter import execute_script

    with span("script/challenger"):
        ch_stats: dict = {}
        challenger_script = build_challenger_script(challenger.op_log, ch_stats)
        if run_scripts:
            res = execute_script(challenger_script)
            assert res.success, f"challenger script failed: {res.error}"
    report.segment_script_bytes["challenger"] = len(challenger_script)
    report.total_script_bytes += len(challenger_script)
    report.challenger_compressions = ch_stats.get("compressions", 0)
    return report
