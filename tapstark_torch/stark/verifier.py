"""uni-STARK verifier (twin of `tapstark.stark.verifier`; reference
uni-stark/src/verifier.rs).

Exact host arithmetic: shape checks, transcript replay, PCS verification,
quotient reassembly from chunk openings via vanishing-polynomial ratios, and
the out-of-domain constraint check folded * Z_H^{-1} == quotient.
"""

from __future__ import annotations

from ..air.folders import VerifierConstraintFolder
from ..air.symbolic import get_log_quotient_degree
from ..challenger import BfChallenger
from ..field.scalar import EF4, F
from ..fri.pcs import TwoAdicFriPcs
from .proof import Proof


class VerificationError(Exception):
    pass


def verify(
    pcs: TwoAdicFriPcs,
    air,
    challenger: BfChallenger,
    proof: Proof,
    public_values: list[F],
) -> None:
    degree = 1 << proof.degree_bits
    log_quotient_degree = get_log_quotient_degree(air, len(public_values))
    quotient_degree = 1 << log_quotient_degree

    trace_domain = pcs.natural_domain_for_degree(degree)
    quotient_domain = trace_domain.create_disjoint_domain(
        1 << (proof.degree_bits + log_quotient_degree)
    )
    quotient_chunks_domains = quotient_domain.split_domains(quotient_degree)

    air_width = air.width()
    ov = proof.opened_values
    valid_shape = (
        len(ov.trace_local) == air_width
        and len(ov.trace_next) == air_width
        and len(ov.quotient_chunks) == quotient_degree
        and all(len(qc) == 4 for qc in ov.quotient_chunks)
    )
    if not valid_shape:
        raise VerificationError("InvalidProofShape")

    challenger.observe_commitment(proof.commitments.trace)
    alpha: EF4 = challenger.sample()
    challenger.observe_commitment(proof.commitments.quotient_chunks)
    zeta: EF4 = challenger.sample()
    zeta_next = trace_domain.next_point(zeta)

    try:
        pcs.verify(
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
    except Exception as e:
        raise VerificationError(f"InvalidOpeningArgument: {e}") from e

    # zps: products of vanishing ratios of the other chunk domains
    # (verifier.rs:103-120)
    zps = []
    for i, domain in enumerate(quotient_chunks_domains):
        acc = EF4.one()
        for j, other_domain in enumerate(quotient_chunks_domains):
            if j == i:
                continue
            acc = acc * (
                other_domain.zp_at_point(zeta)
                * other_domain.zp_at_point(
                    EF4.from_base(domain.first_point())
                ).inverse()
            )
        zps.append(acc)

    quotient = EF4.zero()
    for ch_i, ch in enumerate(ov.quotient_chunks):
        for e_i, c in enumerate(ch):
            quotient = quotient + zps[ch_i] * EF4.monomial(e_i) * c

    sels = trace_domain.selectors_at_point(zeta)
    folder = VerifierConstraintFolder(
        ov.trace_local, ov.trace_next, public_values, sels, alpha
    )
    air.eval(folder)
    folded_constraints = folder.accumulator

    if folded_constraints * sels.inv_zeroifier != quotient:
        raise VerificationError("OodEvaluationMismatch")
