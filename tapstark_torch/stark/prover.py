"""uni-STARK prover (twin of `tapstark.stark.prover`; reference
uni-stark/src/prover.rs).

prove(): infer the quotient degree symbolically → commit the trace LDE →
sample alpha → evaluate the constraint quotient over the disjoint coset
(tensors, whole coset at once) → commit the quotient chunks → sample zeta →
open the trace at {zeta, zeta·g} and every chunk at zeta through the PCS.
Everything that holds field arrays runs on `pcs.device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..air.program import quotient_program
from ..air.symbolic import get_log_quotient_degree
from ..challenger import BfChallenger
from ..field.device import to_mont
from ..field.scalar import EF4, F
from ..fri.pcs import TwoAdicFriPcs
from ..utils import log2_strict
from ..utils.profiling import span
from .check import check_constraints
from .proof import Commitments, OpenedValues, Proof


def prove(
    pcs: TwoAdicFriPcs,
    air,
    challenger: BfChallenger,
    trace: np.ndarray,  # (n, width) canonical uint32
    public_values: list[F],
    debug: bool = False,
) -> Proof:
    if debug:
        check_constraints(air, trace, public_values)

    dev = pcs.device
    degree = int(trace.shape[0])
    log_degree = log2_strict(degree)
    log_quotient_degree = get_log_quotient_degree(air, len(public_values))
    quotient_degree = 1 << log_quotient_degree

    trace_domain = pcs.natural_domain_for_degree(degree)
    # canonical values are < p < 2^31: the int32 view holds the same numbers
    trace_dev = to_mont(torch.from_numpy(np.ascontiguousarray(trace, np.uint32).view(np.int32)).to(dev))

    with span("prove/commit-trace", dev):
        trace_commit, trace_data = pcs.commit([(trace_domain, trace_dev)])
    challenger.observe_commitment(trace_commit)
    alpha: EF4 = challenger.sample()

    quotient_domain = trace_domain.create_disjoint_domain(1 << (log_degree + log_quotient_degree))
    trace_on_quotient_domain = pcs.get_evaluations_on_domain(trace_data, 0, quotient_domain)

    with span("prove/quotient-values", dev):
        quotient_flat = quotient_values(
            air, public_values, trace_domain, quotient_domain, trace_on_quotient_domain, alpha
        )  # (m, 4): each extension value is a width-4 base row
    quotient_chunks = quotient_domain.split_evals(quotient_degree, quotient_flat)
    qc_domains = quotient_domain.split_domains(quotient_degree)

    with span("prove/commit-quotient", dev):
        quotient_commit, quotient_data = pcs.commit(list(zip(qc_domains, quotient_chunks)))
    challenger.observe_commitment(quotient_commit)

    zeta: EF4 = challenger.sample()
    zeta_next = trace_domain.next_point(zeta)

    with span("prove/open", dev):
        opened_values, opening_proof = pcs.open(
            [
                (trace_data, [[zeta, zeta_next]]),
                (quotient_data, [[zeta] for _ in range(quotient_degree)]),
            ],
            challenger,
        )

    return Proof(
        commitments=Commitments(trace=trace_commit, quotient_chunks=quotient_commit),
        opened_values=OpenedValues(
            trace_local=opened_values[0][0][0],
            trace_next=opened_values[0][0][1],
            quotient_chunks=[opened_values[1][i][0] for i in range(quotient_degree)],
        ),
        opening_proof=opening_proof,
        degree_bits=log_degree,
    )


def quotient_values(
    air, public_values, trace_domain, quotient_domain, trace_on_quotient_domain, alpha: EF4
) -> torch.Tensor:
    """Constraint accumulator over the whole quotient coset divided by the
    zeroifier (prover.rs:121-194), as an (m, 4) Montgomery tensor. On the
    card, the AIR's generated constraint-program kernels (`air/program.py`),
    which compute the selectors from the coset's parameters; on the CPU,
    their plain version, the eager folder over whole-coset tensors."""
    return quotient_program(air, public_values, trace_domain, quotient_domain, trace_on_quotient_domain, alpha)
