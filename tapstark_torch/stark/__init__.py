from .check import check_constraints
from .proof import Commitments, OpenedValues, Proof
from .prover import prove, quotient_values
from .verifier import VerificationError, verify

__all__ = [
    "check_constraints",
    "Commitments",
    "OpenedValues",
    "Proof",
    "prove",
    "quotient_values",
    "VerificationError",
    "verify",
]
