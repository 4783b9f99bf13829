"""FRI configuration (twin of `tapstark.fri.config`; fri/src/config.rs)."""

from __future__ import annotations

from dataclasses import dataclass

from ..commit.mmcs import TapTreeMmcs


@dataclass
class FriConfig:
    log_blowup: int
    num_queries: int
    proof_of_work_bits: int
    mmcs: TapTreeMmcs  # extension-field mmcs for the commit-phase layers
    # Early-stopping FRI: fold until the layer holds a degree < 2^L
    # polynomial instead of a constant; 0 folds to a constant, as the
    # reference does (fri/src/prover.rs:92-141).
    log_final_poly_len: int = 0

    def blowup(self) -> int:
        return 1 << self.log_blowup

    def final_poly_len(self) -> int:
        return 1 << self.log_final_poly_len
