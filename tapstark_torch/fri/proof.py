"""FRI proof containers (twin of `tapstark.fri.proof`; fri/src/proof.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..commit.tcs import CommitedProof
from ..field.scalar import EF4


def get_leaf_index_by_query_index(query_index: int) -> tuple[int, int, int]:
    """(leaf index, pair index, sibling pair index) of a query index."""
    index_i = query_index >> 1
    return index_i >> 1, index_i, index_i ^ 1


@dataclass
class BfQueryProof:
    input_proof: Any  # list[BatchOpening] for the PCS input rounds
    # one (opened_values, commitment_proof) per commit-phase layer
    commit_phase_openings: list[tuple[list[list[EF4]], CommitedProof]]


@dataclass
class FriProof:
    commit_phase_commits: list[list[list[int]]]  # per layer: roots per query rep
    query_proofs: list[BfQueryProof]
    final_poly: EF4 | list[EF4]  # list = early-stopping coefficients (low -> high)
    pow_witness: int
