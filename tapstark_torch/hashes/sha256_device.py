"""Batched SHA-256 for the taptree commits (the port of
`tapstark.hashes.sha256_device`): wrappers of the two kernels in
`tapstark_torch/csrc/sha256.cu` and their plain versions.

- `tapleaf_subtrees` replaces `_sha_pallas_kernel` (K5): per-repetition
  head midstates (8, R), a suffix shared by every repetition (16·nb, N)
  and per-repetition remainder words (16·nb, R); lane (r, n) compresses the
  blocks suffix[:, n] | rem[:, r] (the (16·nb, R, N) block tensor is never
  built), and the first `levels` TapBranch levels above the leaves hash in
  the same launch. Out: level `levels`, (8, R, N >> levels).
- `tapbranch_levels` replaces `_tapbranch_pallas_kernel` (K6): BIP-341
  TapBranch nodes (sort the two digests by big-endian word compare,
  compress from the TapBranch tag midstate, compress the constant padding
  block, feed forward) over up to MAX_TILE_LEVELS levels of a tree level
  (8, R, n) in one launch; every level from `write_first` up is written,
  one after another along each repetition's row.
- `compress_wm` and `tapbranch_wm` are the one-step forms (one compression
  chain per lane; one TapBranch node per lane), run on the same two kernels
  with zero levels above the leaves and one level.
- The reference's batch API keeps its shapes, word-minor (`compress_batch`,
  `sha256_blocks`, `tagged_hash_fixed_batch`, `tapbranch_hash_batch`) and
  word-major (`compress_batch_wm`, `tapbranch_hash_batch_wm`,
  `tapbranch_fused_wm`): each runs all its lanes' blocks as one
  `compress_wm` (nb chained blocks a lane), and `tapbranch_fused_wm` as one
  `tapbranch_wm`; the `*_plain` twins run the same steps on the plain
  versions.

Words are stored as int32 tensors holding the uint32 bits (torch's uint32
lacks `+` and shifts); the plain versions do their math in int64. Each
wrapper runs its kernel for a CUDA tensor and its plain version for a CPU
tensor, and raises for anything else. The source note in the .cu file says
what bounds the kernels on an H100 and what the design does about it.

Tagged hashing (reference rust-bitcoin TapLeafHash/TapNodeHash semantics,
tap-stark's basic/src/tcs/builder.rs:26-64): the 64-byte
sha256(tag)||sha256(tag) prefix is exactly one block, so each tag's
midstate is a constant and only the message blocks run per item.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .sha256 import sha256

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

IV = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)


def _compress_np(state: np.ndarray, block: np.ndarray) -> np.ndarray:
    """Pure-numpy single SHA-256 compression (host constants only — e.g.
    tag midstates)."""
    M = np.uint64(0xFFFFFFFF)

    def rotr(x, n):
        return ((x >> np.uint64(n)) | (x << np.uint64(32 - n))) & M

    w = [np.uint64(x) for x in block]
    for i in range(16, 64):
        s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> np.uint64(3))
        s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> np.uint64(10))
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M)
    a, b, c, d, e, f, g, h = (np.uint64(x) for x in state)
    for i in range(64):
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g & M)
        t1 = (h + s1 + ch + np.uint64(int(_K[i])) + w[i]) & M
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & M
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M, c, b, a, (t1 + t2) & M
    out = np.array([a, b, c, d, e, f, g, h], dtype=np.uint64)
    return ((out + state.astype(np.uint64)) & M).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def tag_midstate_words(tag: bytes) -> np.ndarray:
    """(8,) uint32: SHA-256 state after the one-block tagged-hash prefix
    sha256(tag) || sha256(tag)."""
    t = sha256(tag)
    block = np.frombuffer(t + t, dtype=">u4").astype(np.uint32)
    return _compress_np(IV.copy(), block)


@functools.lru_cache(maxsize=None)
def _tag_msg_padding_words(msg_bytes: int) -> np.ndarray:
    """SHA-256 padding words appended to a word-aligned tagged-hash message
    of msg_bytes bytes (the 64-byte sha256(tag)||sha256(tag) prefix block
    counts toward the encoded bit length). Single source of truth for both
    the generic tagged hash and the constant TapBranch second block."""
    assert msg_bytes % 4 == 0
    w = msg_bytes // 4
    total = 64 + msg_bytes  # prefix block + message
    # padding for the FULL sha256 input (prefix included in the bit length)
    pad_total = msg_bytes + 1 + 8
    nblocks = -(-pad_total // 64)
    pad = np.zeros(nblocks * 16 - w, dtype=np.uint32)
    pad[0] = 0x80000000
    bitlen = total * 8
    pad[-2] = (bitlen >> 32) & 0xFFFFFFFF
    pad[-1] = bitlen & 0xFFFFFFFF
    return pad


@functools.lru_cache(maxsize=None)
def _tapbranch_block2_round_consts() -> tuple:
    """64 uint32 round constants (K[i] + w[i]) for TapBranch's SECOND
    compression block: its 16 message words are the constant padding block
    (_tag_msg_padding_words(64)), so the whole 64-word schedule — and its
    per-round K addition — folds to compile-time constants, removing the
    schedule-extension arithmetic (~18% of the rounds' ops) from the fused
    kernel."""
    m = 0xFFFFFFFF

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & m

    w = [int(x) for x in _tag_msg_padding_words(64)]
    for i in range(16, 64):
        s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & m)
    return tuple((w[i] + int(_K[i])) & m for i in range(64))


# Launches of each kernel since the last reset (one per wrapper call that
# reached the card).
launches = {"tapleaf_subtrees": 0, "tapbranch_levels": 0}

# The kernels' tiling (csrc/sha256.cu, checked by the loader): a launch of
# either hashes at most MAX_TILE_LEVELS levels (a 2048-node tile down to
# one node); the commit hashes LEAF_LEVELS levels in the leaf launch and
# BRANCH_LEVELS per TapBranch launch above the cutoff (the tile's 512
# threads all busy on the first two, half and a quarter of them on the
# last two).
LEAF_LEVELS = 4
BRANCH_LEVELS = 4
MAX_TILE_LEVELS = 11


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Plain versions (int64 math on words < 2^32)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _u(x: torch.Tensor) -> torch.Tensor:
    """int32 word bits → the uint32 value as int64."""
    return x.to(torch.int64) & _M32


def _s(x: torch.Tensor) -> torch.Tensor:
    """int64 values < 2^32 → int32 tensor of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def _round(s: list, kw) -> list:
    """One SHA-256 round; kw = K[i] + W[i] (may exceed 2^32)."""
    a, b, c, d, e, f, g, h = s
    t1 = (h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + ((e & f) ^ ((e ^ _M32) & g)) + kw) & _M32
    t2 = (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))
    return [(t1 + t2) & _M32, a, b, c, (d + t1) & _M32, e, f, g]


def _compress_words(state: list, block: list) -> list:
    """One compression of 8 state words and 16 block words (int64 tensors
    or ints that broadcast), with the 16-word schedule window the kernel
    keeps in registers."""
    w = list(block)
    s = list(state)
    for i in range(64):
        if i >= 16:
            w15, w2 = w[(i - 15) & 15], w[(i - 2) & 15]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            w[i & 15] = (w[i & 15] + s0 + w[(i - 7) & 15] + s1) & _M32
        s = _round(s, w[i & 15] + int(_K[i]))
    return [(x + y) & _M32 for x, y in zip(s, state)]


def compress_wm_plain(state: torch.Tensor, block: torch.Tensor, rem: torch.Tensor | None = None) -> torch.Tensor:
    """`compress_wm` in plain torch (same forms, same result)."""
    nb = block.shape[0] // 16
    if rem is None:
        st = [_u(state[k]) for k in range(8)]  # (M,)

        def word(row):
            return _u(block[row])

    else:
        st = [_u(state[k])[:, None] for k in range(8)]  # (R, 1)

        def word(row):
            return _u(block[row])[None, :] | _u(rem[row])[:, None]  # (R, N)

    for b in range(nb):
        st = _compress_words(st, [word(16 * b + j) for j in range(16)])
    return _s(torch.stack(torch.broadcast_tensors(*st)))


def tapbranch_wm_plain(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """`tapbranch_wm` in plain torch (same result)."""
    x = [_u(h1[k]) for k in range(8)]
    y = [_u(h2[k]) for k in range(8)]
    less = torch.zeros(x[0].shape, dtype=torch.bool, device=h1.device)
    decided = torch.zeros_like(less)
    for a, b in zip(x, y):  # lexicographic byte order = big-endian word order
        less = less | (~decided & (a < b))
        decided = decided | (a != b)
    w = [torch.where(less, a, b) for a, b in zip(x, y)]
    w += [torch.where(less, b, a) for a, b in zip(x, y)]
    mid = [int(v) for v in tag_midstate_words(b"TapBranch")]
    st1 = _compress_words(mid, w)
    s = st1
    for kw in _tapbranch_block2_round_consts():
        s = _round(s, kw)
    return _s(torch.stack([(a + b) & _M32 for a, b in zip(s, st1)]))


def _level_up_plain(level: torch.Tensor) -> torch.Tensor:
    """(8, R, n) tree level -> (8, R, n / 2): TapBranch of siblings 2i, 2i+1."""
    r, n = level.shape[1], level.shape[2]
    children = level.reshape(8, r * n // 2, 2)
    return tapbranch_wm_plain(children[:, :, 0], children[:, :, 1]).view(8, r, n // 2)


def tapleaf_subtrees_plain(mids: torch.Tensor, suffix: torch.Tensor, rem: torch.Tensor, levels: int) -> torch.Tensor:
    """`tapleaf_subtrees` in plain torch: the leaf digests (8, R, N), then
    `levels` TapBranch levels one after another."""
    level = compress_wm_plain(mids, suffix, rem)
    for _ in range(levels):
        level = _level_up_plain(level)
    return level


def tapbranch_levels_plain(level: torch.Tensor, levels: int, write_first: int = 1) -> torch.Tensor:
    """`tapbranch_levels` in plain torch: levels 1..`levels` above `level`
    (8, R, n), those from `write_first` up concatenated along the last axis."""
    kept = []
    for l in range(1, levels + 1):
        level = _level_up_plain(level)
        if l >= write_first:
            kept.append(level)
    return torch.cat(kept, dim=2)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_words(x: torch.Tensor, name: str, dim: int, device) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words, got {x.dtype}")
    if x.dim() != dim:
        raise ValueError(f"{name}: expected {dim} dimensions, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")


def _check_out(out: torch.Tensor, name: str, shape: tuple, device) -> None:
    _check_words(out, name, 3, device)
    if tuple(out.shape) != shape or out.stride(2) != 1:
        raise ValueError(f"{name}: out {tuple(out.shape)} strides {out.stride()}, expected {shape} with unit last stride")


def _log2(n: int, name: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{name}: {n} nodes per repetition is not a power of two")
    return n.bit_length() - 1


def _stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _lib():
    from .._build import load_library

    return load_library()


def _device_of(x: torch.Tensor, name: str):
    """None for a CPU tensor (the plain version runs), the device for a
    CUDA one; raises for any other."""
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no path for device {x.device}")
    return x.device


def tapleaf_subtrees(
    mids: torch.Tensor, suffix: torch.Tensor, rem: torch.Tensor, levels: int, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Tapleaf digests and the `levels` TapBranch levels above them.

    mids (8, R) head midstates, suffix (16·nb, N) shared suffix words (N a
    power of two), rem (16·nb, R) remainder words, all int32 and
    contiguous; 0 <= levels <= min(log2 N, MAX_TILE_LEVELS). Returns level
    `levels`, (8, R, N >> levels), written into `out` when given (any
    strides but a unit last one, e.g. a slice of a larger buffer)."""
    dev = _device_of(suffix, "tapleaf_subtrees")
    if dev is None:
        got = tapleaf_subtrees_plain(mids, suffix, rem, levels)
        return got if out is None else out.copy_(got)
    for x, name in ((mids, "mids"), (suffix, "suffix"), (rem, "rem")):
        _check_words(x, f"tapleaf_subtrees {name}", 2, dev)
        if not x.is_contiguous():
            raise ValueError(f"tapleaf_subtrees: {name} is not contiguous")
    rows, n = suffix.shape
    reps = mids.shape[1]
    nb = rows // 16
    log_n = _log2(n, "tapleaf_subtrees")
    if nb < 1 or rows != 16 * nb or mids.shape[0] != 8 or rem.shape != (rows, reps):
        raise ValueError(f"tapleaf_subtrees: mids {tuple(mids.shape)}, suffix {tuple(suffix.shape)}, rem {tuple(rem.shape)}")
    if not 0 <= levels <= min(log_n, MAX_TILE_LEVELS):
        raise ValueError(f"tapleaf_subtrees: {levels} levels above {n} leaves")
    if reps * n >= 1 << 31:
        raise ValueError(f"tapleaf_subtrees: {reps} x {n} lanes, at most 2^31 - 1 a launch")
    shape = (8, reps, n >> levels)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=dev)
    _check_out(out, "tapleaf_subtrees", shape, dev)
    with torch.cuda.device(dev):
        err = _lib().tapstark_tapleaf_subtrees(
            mids.data_ptr(), suffix.data_ptr(), rem.data_ptr(), reps, log_n, nb, levels,
            out.data_ptr(), out.stride(0), out.stride(1), _stream_ptr(dev),
        )
    if err != 0:
        raise RuntimeError(f"tapleaf_subtrees: CUDA error {err}")
    launches["tapleaf_subtrees"] += 1
    return out


def tapbranch_levels(
    level: torch.Tensor, levels: int, write_first: int = 1, out: torch.Tensor | None = None
) -> torch.Tensor:
    """TapBranch levels 1..`levels` above a tree level (8, R, n) int32 (n a
    power of two, any strides but a unit last one), each node over its
    children 2i and 2i+1 of the same repetition; 1 <= write_first <= levels
    <= min(log2 n, MAX_TILE_LEVELS). Returns levels write_first..levels
    concatenated along the last axis, (8, R, sum of n >> l), written into
    `out` when given (any strides but a unit last one)."""
    dev = _device_of(level, "tapbranch_levels")
    if dev is None:
        got = tapbranch_levels_plain(level, levels, write_first)
        return got if out is None else out.copy_(got)
    _check_words(level, "tapbranch_levels level", 3, dev)
    _, reps, n = level.shape
    log_n = _log2(n, "tapbranch_levels")
    if level.shape[0] != 8 or level.stride(2) != 1:
        raise ValueError(f"tapbranch_levels: level {tuple(level.shape)} strides {level.stride()}")
    if not 1 <= write_first <= levels <= min(log_n, MAX_TILE_LEVELS):
        raise ValueError(f"tapbranch_levels: levels {write_first}..{levels} above {n} nodes")
    if reps * n >= 1 << 31:
        raise ValueError(f"tapbranch_levels: {reps} x {n} nodes, at most 2^31 - 1 a launch")
    shape = (8, reps, sum(n >> l for l in range(write_first, levels + 1)))
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=dev)
    _check_out(out, "tapbranch_levels", shape, dev)
    with torch.cuda.device(dev):
        err = _lib().tapstark_tapbranch_levels(
            level.data_ptr(), level.stride(0), level.stride(1), reps, log_n, levels, write_first,
            out.data_ptr(), out.stride(0), out.stride(1), _stream_ptr(dev),
        )
    if err != 0:
        raise RuntimeError(f"tapbranch_levels: CUDA error {err}")
    launches["tapbranch_levels"] += 1
    return out


def compress_wm(state: torch.Tensor, block: torch.Tensor, rem: torch.Tensor | None = None) -> torch.Tensor:
    """SHA-256 compressions, word-major, int32 words, on `tapleaf_subtrees`
    with no level above the leaves.

    Plain form: state (8, M), block (16·nb, M) → (8, M), nb chained
    compressions per lane (each lane a repetition of one leaf). Leaf form
    (rem given): state (8, R) per repetition, block (16·nb, N) shared (on
    the card, N a power of two), rem (16·nb, R) per repetition →
    (8, R, N)."""
    if _device_of(block, "compress_wm") is None:
        return compress_wm_plain(state, block, rem)
    if rem is not None:
        return tapleaf_subtrees(state, block, rem, 0)
    if block.dim() != 2 or state.dim() != 2 or state.shape[1] != block.shape[1]:
        raise ValueError(f"compress_wm: state {tuple(state.shape)}, block {tuple(block.shape)}")
    zero = torch.zeros((block.shape[0], 1), dtype=block.dtype, device=block.device)
    return tapleaf_subtrees(state.contiguous(), zero, block.contiguous(), 0).view(8, -1)


def tapbranch_wm(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """TapBranch of each lane's two child digests, on `tapbranch_levels`
    with one level: h1, h2 (8, M) int32 words (any strides) → (8, M)
    contiguous."""
    if _device_of(h1, "tapbranch_wm") is None:
        return tapbranch_wm_plain(h1, h2)
    if h1.dim() != 2 or h1.shape != h2.shape or h1.shape[0] != 8:
        raise ValueError(f"tapbranch_wm: shapes {tuple(h1.shape)}, {tuple(h2.shape)}")
    # each lane a repetition of one two-node level
    return tapbranch_levels(torch.stack([h1, h2], dim=2), 1).view(8, -1)


# ---------------------------------------------------------------------------
# The reference's batch API: its shapes, int32 words
# ---------------------------------------------------------------------------


def _words_on(words: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words → int32 tensor of the same bits on `device`."""
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)).to(device)


def _lanes_wm(state_wm: torch.Tensor, blocks_wm: torch.Tensor, compress) -> torch.Tensor:
    """state (8, ...) (broadcast to the lanes), blocks (16·nb, ...) → (8,
    ...): nb chained compressions a lane, one `compress` call."""
    lanes = tuple(blocks_wm.shape[1:])
    m = math.prod(lanes)
    out = compress(state_wm.expand((8,) + lanes).reshape(8, m), blocks_wm.reshape(blocks_wm.shape[0], m))
    return out.reshape((8,) + lanes)


def _lanes(state: torch.Tensor, blocks: torch.Tensor, compress) -> torch.Tensor:
    """state (..., 8) (broadcast to the lanes), blocks (..., 16·nb) → (...,
    8): `_lanes_wm` on the transposed words."""
    lead = tuple(blocks.shape[:-1])
    m = math.prod(lead)
    out = compress(state.expand(lead + (8,)).reshape(m, 8).T, blocks.reshape(m, blocks.shape[-1]).T)
    return out.T.reshape(lead + (8,))


def compress_batch_wm(state_wm: torch.Tensor, block_wm: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression a lane, word-major: state (8, ...), block
    (16, ...) big-endian words → (8, ...)."""
    return _lanes_wm(state_wm, block_wm, compress_wm)


def compress_batch(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression a lane: state (..., 8), block (..., 16)
    big-endian words → new state (..., 8)."""
    return _lanes(state, block, compress_wm)


def _sha256_blocks(blocks: torch.Tensor, compress) -> torch.Tensor:
    n, nb, _ = blocks.shape
    return _lanes(_words_on(IV, blocks.device), blocks.reshape(n, 16 * nb), compress)


def sha256_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """SHA-256 of pre-padded messages: blocks (N, nb, 16) big-endian words
    → digests (N, 8), the nb compressions of a lane chained from the IV."""
    return _sha256_blocks(blocks, compress_wm)


def sha256_blocks_plain(blocks: torch.Tensor) -> torch.Tensor:
    return _sha256_blocks(blocks, compress_wm_plain)


def _tagged_hash(tag: bytes, msg_words: torch.Tensor, msg_bytes: int, compress) -> torch.Tensor:
    w = msg_words.shape[-1]
    if msg_bytes != 4 * w:
        raise ValueError(f"tagged_hash_fixed_batch: {msg_bytes} bytes in {w} words")
    dev = msg_words.device
    pad = _words_on(_tag_msg_padding_words(msg_bytes), dev)
    padded = torch.cat([msg_words, pad.expand(tuple(msg_words.shape[:-1]) + pad.shape)], dim=-1)
    return _lanes(_words_on(tag_midstate_words(tag), dev), padded, compress)


def tagged_hash_fixed_batch(tag: bytes, msg_words: torch.Tensor, msg_bytes: int) -> torch.Tensor:
    """BIP-340 tagged hash of fixed-length messages of whole words:
    msg_words (..., W) big-endian, msg_bytes = 4·W → (..., 8). The lanes
    start from the tag's midstate and hash the message and the padding
    words (whose bit length counts the 64-byte prefix)."""
    return _tagged_hash(tag, msg_words, msg_bytes, compress_wm)


def tagged_hash_fixed_batch_plain(tag: bytes, msg_words: torch.Tensor, msg_bytes: int) -> torch.Tensor:
    return _tagged_hash(tag, msg_words, msg_bytes, compress_wm_plain)


def _lex_sort_pair(h1: torch.Tensor, h2: torch.Tensor, word_axis: int) -> tuple:
    """(lo, hi) of two batched 8-word digests by lexicographic byte order,
    which is big-endian word order; `word_axis` holds the 8 words."""
    less = decided = None
    for i in range(8):
        a, b = _u(h1.select(word_axis, i)), _u(h2.select(word_axis, i))
        if less is None:
            less, decided = a < b, a != b
        else:
            less = less | (~decided & (a < b))
            decided = decided | (a != b)
    m = less.unsqueeze(word_axis)
    return torch.where(m, h1, h2), torch.where(m, h2, h1)


def _tapbranch(h1: torch.Tensor, h2: torch.Tensor, compress) -> torch.Tensor:
    lo, hi = _lex_sort_pair(h1, h2, -1)
    return _tagged_hash(b"TapBranch", torch.cat([lo, hi], dim=-1), 64, compress)


def tapbranch_hash_batch(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """BIP-341 TapBranch of each lane's pair: h1, h2 (N, 8) big-endian
    digest words → (N, 8); the pair sorts lexicographically, then the
    tagged hash of lo || hi."""
    return _tapbranch(h1, h2, compress_wm)


def tapbranch_hash_batch_plain(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    return _tapbranch(h1, h2, compress_wm_plain)


def tapbranch_hash_batch_wm(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """`tapbranch_hash_batch` word-major: h1, h2 (8, ...) → (8, ...); the
    message block and the constant padding block chained a lane."""
    lo, hi = _lex_sort_pair(h1, h2, 0)
    ones = (1,) * (h1.dim() - 1)
    mid = _words_on(tag_midstate_words(b"TapBranch"), h1.device).view((8,) + ones)
    pad = _words_on(_tag_msg_padding_words(64), h1.device).view((16,) + ones)
    return _lanes_wm(mid, torch.cat([lo, hi, pad.expand((16,) + tuple(h1.shape[1:]))]), compress_wm)


def tapbranch_fused_wm(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """TapBranch word-major on `tapbranch_wm` (K6's kernel on the card): h1,
    h2 (8, ...) → (8, ...), equal to `tapbranch_hash_batch_wm`."""
    lanes = tuple(h1.shape[1:])
    m = math.prod(lanes)
    return tapbranch_wm(h1.reshape(8, m), h2.reshape(8, m)).reshape((8,) + lanes)
