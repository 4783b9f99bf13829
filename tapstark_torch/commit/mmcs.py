"""TapTreeMmcs — batch matrix commitment over the TCS.

Behavioral port of tap-stark's basic/src/mmcs/taptree_mmcs.rs: commitment
is one taptree root PER QUERY REPETITION ([u32;8] words each); open
interprets the query index against the tallest matrix and drops LSBs for
shorter ones; verify re-signs the opened values and executes the leaf script.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field.scalar import EF4, F
from .bitcomm import BcManager
from .tcs import TCS, CommitedData, CommitedProof, FMatrix


def scalars_to_limbs(values) -> list[list[int]]:
    return [v.as_u32_vec() for v in values]


def fmatrix_row_scalars(m: FMatrix, r: int):
    if m.ext:
        return [EF4([int(x) for x in m.values[r, j]]) for j in range(m.width)]
    return [F(int(m.values[r, j])) for j in range(m.width)]


@dataclass
class TapTreeMmcs:
    """ext=False commits base-field matrices, ext=True extension-field ones
    (the reference's TapTreeMmcs<Val> vs TapTreeMmcs<Challenge>)."""

    manager: BcManager
    num_queries: int
    ext: bool

    def __post_init__(self):
        self.tcs = TCS(self.manager)

    def commit(self, inputs: list[FMatrix]):
        assert all(m.ext == self.ext for m in inputs)
        prover_data = self.tcs.commit_poly_with_query_times(inputs, self.num_queries)
        commitment = [d.root_words() for d in prover_data]
        return commitment, prover_data

    def commit_matrix(self, m: FMatrix):
        return self.commit([m])

    def commit_matrix_deferred(self, m: FMatrix):
        """The commit of a matrix that carries a tensor, its roots not
        copied (the FRI commit phase's device transcript chain): a
        tcs.DeferredDeviceCommit whose finalize(fetched) gives the
        prover_data list, or None when `m` has no tensor."""
        assert m.ext == self.ext
        return self.tcs.commit_poly_deferred([m], self.num_queries)

    def open_batch(
        self, query_times_index: int, query_index: int, prover_data: list[CommitedData]
    ):
        """Opened values are sliced from the committed leaf limbs (exactly
        what the leaf script EQUALVERIFYs) instead of re-read from the
        FMatrix host copies: the padding matrix interleaves matrices
        tallest-first with rows repeated, so leaf `query_index` holds row
        `query_index >> (log_max - log_h)` of every matrix — and reading
        the leaf row reads the commitment's own copy: its host matrix, or
        the one leaf block copied from the card (device_commit.DeviceValues)."""
        data0 = prover_data[0]
        heights = [m.height for m in data0.leaves]
        assert heights == sorted(heights, reverse=True), (
            "matrices must be passed tallest-first (padding-matrix order)"
        )
        proof, leaf_limbs = self.tcs.open_with_one_query(
            query_times_index, query_index, prover_data
        )
        openings = []
        pos = 0
        for m in data0.leaves:
            w = m.width
            row = leaf_limbs[pos : pos + w]
            pos += w
            if self.ext:
                openings.append([EF4([int(x) for x in v]) for v in row])
            else:
                openings.append([F(int(v[0])) for v in row])
        assert pos == len(leaf_limbs)
        return openings, proof

    def verify_batch(
        self,
        query_times_index: int,
        opened_values: list[list],
        proof: CommitedProof,
        roots: list[list[int]],
    ) -> bool:
        flat = [v for row in opened_values for v in row]
        limbs = scalars_to_limbs(flat)
        root_words = roots[query_times_index]
        return TCS.verify_words(root_words, proof, limbs)

    @staticmethod
    def get_matrices(prover_data: list[CommitedData]) -> list[FMatrix]:
        return prover_data[0].leaves

    @staticmethod
    def get_max_height(prover_data: list[CommitedData]) -> int:
        return prover_data[0].get_max_height()
