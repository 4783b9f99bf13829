"""Native commit engine loader.

Compiles tapstark_native.cpp on first use (g++ -O3 -shared) into
tapstark_torch/_build/ and binds it via ctypes. Every commit needs the
engine: a failed build raises, there is no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tapstark_native.cpp")

_lib = None


def _build_and_load():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    build_dir = os.path.join(os.path.dirname(_HERE), "_build")
    os.makedirs(build_dir, exist_ok=True)
    so_path = os.path.join(build_dir, f"tapstark_native_{digest}.so")
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"  # concurrent builders (test workers)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    for fname in (
        "winternitz_pubkeys_batch",
        "winternitz_sign_batch",
        "sha256_batch",
        "sha256_midstates",
        "tcs_commit_sparse",
        "tcs_leaf_block",
    ):
        getattr(lib, fname).restype = None
    lib.winternitz_pubkeys_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.winternitz_sign_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.sha256_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_void_p,
    ]
    lib.sha256_midstates.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.tcs_commit_sparse.argtypes = [
        ctypes.c_char_p,  # head (constant leaf prefix: all locks, parked)
        ctypes.c_uint64,  # head_len
        ctypes.c_uint64,  # fixed_len (shard-wide padded script length)
        ctypes.c_void_p,  # values (u32*)
        ctypes.c_uint32,  # num_leaves
        ctypes.c_uint32,  # num_values
        ctypes.c_uint32,  # num_limbs
        ctypes.c_char_p,  # tapleaf_tag
        ctypes.c_char_p,  # tapbranch_tag
        ctypes.c_uint8,  # leaf_version
        ctypes.c_uint32,  # cutoff
        ctypes.c_void_p,  # root out
        ctypes.c_void_p,  # upper_levels out
    ]
    lib.tcs_leaf_block.argtypes = [
        ctypes.c_char_p,  # head
        ctypes.c_uint64,  # head_len
        ctypes.c_uint64,  # fixed_len
        ctypes.c_void_p,  # values (block slice, u32*)
        ctypes.c_uint32,  # base_index
        ctypes.c_uint32,  # block_n
        ctypes.c_uint32,  # num_values
        ctypes.c_uint32,  # num_limbs
        ctypes.c_char_p,  # tapleaf_tag
        ctypes.c_char_p,  # tapbranch_tag
        ctypes.c_uint8,  # leaf_version
        ctypes.c_void_p,  # out (2*block_n - 1 hashes)
    ]
    return lib


def get_lib():
    """The loaded native library, built on first use (raises if it cannot
    be built)."""
    global _lib
    if _lib is None:
        _lib = _build_and_load()
    return _lib


def winternitz_pubkeys_batch(
    secrets: list[bytes], num_digits: int, chain_extra: int
) -> np.ndarray:
    """(n, num_digits, 20) uint8 pubkeys via native hash160 chains."""
    lib = get_lib()
    slen = len(secrets[0])
    assert all(len(s) == slen for s in secrets)
    blob = b"".join(secrets)
    out = np.empty((len(secrets), num_digits, 20), dtype=np.uint8)
    lib.winternitz_pubkeys_batch(
        blob, len(secrets), slen, num_digits, chain_extra, out.ctypes.data
    )
    return out


def sha256_midstates_native(
    msgs: list[bytes], init_state: np.ndarray
) -> np.ndarray:
    """(n, 8) uint32 SHA-256 chaining states after compressing each
    fixed-length message's full 64-byte blocks from `init_state` (8 words,
    e.g. a BIP-341 tag midstate). Trailing partial-block bytes are the
    caller's to absorb."""
    lib = get_lib()
    mlen = len(msgs[0])
    assert all(len(m) == mlen for m in msgs)
    st = np.ascontiguousarray(init_state, dtype=np.uint32)
    assert st.shape == (8,)
    out = np.empty((len(msgs), 8), dtype=np.uint32)
    lib.sha256_midstates(
        b"".join(msgs), len(msgs), mlen, st.ctypes.data, out.ctypes.data
    )
    return out


def winternitz_sign_batch(secrets: list[bytes], digit_vals: np.ndarray) -> np.ndarray:
    """(n_msgs, num_digits, 20) uint8 digit signatures: chain (m, i) walked
    digit_vals[m, i] steps past its start hash160(secret_m || i)."""
    lib = get_lib()
    slen = len(secrets[0])
    assert all(len(s) == slen for s in secrets)
    dv = np.ascontiguousarray(digit_vals, dtype=np.uint8)
    n_msgs, num_digits = dv.shape
    assert n_msgs == len(secrets)
    out = np.empty((n_msgs, num_digits, 20), dtype=np.uint8)
    lib.winternitz_sign_batch(
        b"".join(secrets), n_msgs, slen, dv.tobytes(), num_digits, out.ctypes.data
    )
    return out


def tcs_commit_sparse_native(
    head: bytes,
    fixed_len: int,
    values: np.ndarray,  # (num_leaves, num_values, num_limbs) uint32
    tapleaf_tag_digest: bytes,
    tapbranch_tag_digest: bytes,
    cutoff: int,
    leaf_version: int = 0xC0,
):
    """Returns (root bytes, upper_levels: [L_cutoff, ..., L_{depth-1}]).

    `head` is the shard's constant leaf prefix (all Winternitz locks in
    parked form); each leaf's script is head || tail(i) || NOP pad to
    fixed_len, and only the ~2 post-midstate blocks are hashed per leaf.

    Memory-lean: leaf hashes and levels below `cutoff` live in reusable
    thread-local native scratch and are NOT returned — an opening rebuilds
    its 2^cutoff-leaf block with tcs_leaf_block_native. Level arrays are
    position-indexed (the BIP-341 lexicographic pair sort affects only each
    parent's preimage order), so leaf i's branch is L_l[(i >> l) ^ 1]."""
    lib = get_lib()
    num_leaves, num_values, num_limbs = values.shape
    depth = max((num_leaves - 1).bit_length(), 0)
    vals = np.ascontiguousarray(values, dtype=np.uint32)
    root = np.empty(32, dtype=np.uint8)
    n_upper = sum(num_leaves >> l for l in range(max(cutoff, 1), depth))
    upper_flat = np.empty((n_upper, 32), dtype=np.uint8)
    lib.tcs_commit_sparse(
        head,
        len(head),
        fixed_len,
        vals.ctypes.data,
        num_leaves,
        num_values,
        num_limbs,
        tapleaf_tag_digest,
        tapbranch_tag_digest,
        leaf_version,
        cutoff,
        root.ctypes.data,
        upper_flat.ctypes.data,
    )
    upper = []
    off = 0
    for l in range(max(cutoff, 1), depth):
        sz = num_leaves >> l
        upper.append(upper_flat[off : off + sz])
        off += sz
    return bytes(root), upper


def tcs_leaf_block_native(
    head: bytes,
    fixed_len: int,
    values_block: np.ndarray,  # (block_n, num_values, num_limbs) uint32
    base_index: int,
    tapleaf_tag_digest: bytes,
    tapbranch_tag_digest: bytes,
    leaf_version: int = 0xC0,
):
    """Rebuild one opening block: returns [S_0 (block_n,32), S_1, ..., S_k]
    — the block's leaf hashes (absolute indices base_index..+block_n) and
    every sub-level hash array up to the block root."""
    lib = get_lib()
    block_n, num_values, num_limbs = values_block.shape
    vals = np.ascontiguousarray(values_block, dtype=np.uint32)
    out = np.empty((2 * block_n - 1, 32), dtype=np.uint8)
    lib.tcs_leaf_block(
        head,
        len(head),
        fixed_len,
        vals.ctypes.data,
        base_index,
        block_n,
        num_values,
        num_limbs,
        tapleaf_tag_digest,
        tapbranch_tag_digest,
        leaf_version,
        out.ctypes.data,
    )
    levels = []
    off = 0
    sz = block_n
    while sz >= 1:
        levels.append(out[off : off + sz])
        off += sz
        if sz == 1:
            break
        sz //= 2
    return levels
