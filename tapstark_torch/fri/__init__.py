from .config import FriConfig
from .pcs import BatchOpening, PcsProverData, TwoAdicFriPcs
from .proof import BfQueryProof, FriProof, get_leaf_index_by_query_index
from .prover import bf_prove
from .verifier import (
    FriChallenges,
    FriError,
    verify_challenges,
    verify_shape_and_sample_challenges,
)

__all__ = [
    "FriConfig",
    "BatchOpening",
    "PcsProverData",
    "TwoAdicFriPcs",
    "BfQueryProof",
    "FriProof",
    "get_leaf_index_by_query_index",
    "bf_prove",
    "FriChallenges",
    "FriError",
    "verify_challenges",
    "verify_shape_and_sample_challenges",
]
