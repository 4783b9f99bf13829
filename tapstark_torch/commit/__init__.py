from .bitcomm import (
    COMMIT_TYPE_U128,
    COMMIT_TYPE_U32,
    BcManager,
    BitCommitment,
    BitCommitmentU32,
)
from .mmcs import TapTreeMmcs, fmatrix_row_scalars, scalars_to_limbs
from .taptree import (
    CompleteTaptree,
    LeafNode,
    NodeInfo,
    build_taptree,
    combine_with_order,
    verify_inclusion,
)
from .tcs import TCS, CommitedData, CommitedProof, FMatrix, padding_matrix
from .winternitz import Winternitz, to_digits, u32_compress

__all__ = [
    "BcManager",
    "BitCommitment",
    "BitCommitmentU32",
    "COMMIT_TYPE_U32",
    "COMMIT_TYPE_U128",
    "TapTreeMmcs",
    "fmatrix_row_scalars",
    "scalars_to_limbs",
    "CompleteTaptree",
    "LeafNode",
    "NodeInfo",
    "build_taptree",
    "combine_with_order",
    "verify_inclusion",
    "TCS",
    "CommitedData",
    "CommitedProof",
    "FMatrix",
    "padding_matrix",
    "Winternitz",
    "to_digits",
    "u32_compress",
]
