"""uni-STARK proof containers (twin of `tapstark.stark.proof`)."""

from __future__ import annotations

from dataclasses import dataclass

from ..field.scalar import EF4
from ..fri.proof import FriProof


@dataclass
class Commitments:
    trace: list[list[int]]
    quotient_chunks: list[list[int]]


@dataclass
class OpenedValues:
    trace_local: list[EF4]
    trace_next: list[EF4]
    quotient_chunks: list[list[EF4]]


@dataclass
class Proof:
    commitments: Commitments
    opened_values: OpenedValues
    opening_proof: FriProof
    degree_bits: int
