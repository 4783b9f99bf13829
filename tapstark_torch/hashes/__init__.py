from .blake3 import blake3, compress_batch
from .ripemd160 import hash160, ripemd160
from .sha256 import (
    TAPSCRIPT_LEAF_VERSION,
    compact_size,
    sha256,
    tagged_hash,
    tapbranch_hash,
    tapleaf_hash,
)

__all__ = [
    "blake3",
    "compress_batch",
    "hash160",
    "ripemd160",
    "sha256",
    "tagged_hash",
    "tapbranch_hash",
    "tapleaf_hash",
    "compact_size",
    "TAPSCRIPT_LEAF_VERSION",
]
