"""Batched SHA-256 for the taptree commits (the port of
`tapstark.hashes.sha256_device`): wrappers of the two kernels in
`tapstark_torch/csrc/sha256.cu` and their plain versions.

- `compress_wm` replaces `_sha_pallas_kernel` (K5): SHA-256 compressions in
  word-major layout, one lane per message. Plain form: state (8, M) and
  nb blocks (16·nb, M) give (8, M). Leaf form (with `rem`): per-repetition
  head midstates (8, R), a suffix shared by every repetition (16·nb, N)
  and per-repetition remainder words (16·nb, R) give (8, R, N); lane
  (r, n) compresses the blocks suffix[:, n] | rem[:, r]. The (16·nb, R, N)
  block tensor is never built.
- `tapbranch_wm` replaces `_tapbranch_pallas_kernel` (K6): one whole BIP-341
  TapBranch node per lane, h1 and h2 (8, M) → (8, M): sort the two digests
  (big-endian word compare), compress from the TapBranch tag midstate,
  compress the constant padding block, feed forward. h1 and h2 may be
  strided views (a tree level passes its even and odd children).

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
launches = {"sha256_compress": 0, "tapbranch": 0}


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


def _stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def compress_wm(state: torch.Tensor, block: torch.Tensor, rem: torch.Tensor | None = None) -> torch.Tensor:
    """SHA-256 compressions, word-major, int32 words.

    Plain form: state (8, M), block (16·nb, M) → (8, M), nb chained
    compressions per lane. Leaf form (rem given): state (8, R) per
    repetition, block (16·nb, N) shared, rem (16·nb, R) per repetition →
    (8, R, N)."""
    if block.device.type == "cpu":
        return compress_wm_plain(state, block, rem)
    if block.device.type != "cuda":
        raise ValueError(f"compress_wm: no path for device {block.device}")
    dev = block.device
    _check_words(block, "compress_wm block", 2, dev)
    _check_words(state, "compress_wm state", 2, dev)
    rows, n_lanes = block.shape
    nb = rows // 16
    if nb < 1 or rows != 16 * nb or not block.is_contiguous() or state.shape[0] != 8:
        raise ValueError(f"compress_wm: block {tuple(block.shape)}, state {tuple(state.shape)} unsupported")
    if rem is None:
        reps = 1
        if state.shape[1] != n_lanes:
            raise ValueError(f"compress_wm: state {tuple(state.shape)} for {n_lanes} lanes")
        st_strides = (state.stride(0), 0, state.stride(1))
        rem_ptr = None
    else:
        _check_words(rem, "compress_wm rem", 2, dev)
        reps = state.shape[1]
        if rem.shape != (rows, reps) or not rem.is_contiguous() or not 1 <= reps <= 65535:
            raise ValueError(f"compress_wm: rem {tuple(rem.shape)} for state {tuple(state.shape)}")
        st_strides = (state.stride(0), state.stride(1), 0)
        rem_ptr = rem.data_ptr()
    out = torch.empty((8, reps, n_lanes), dtype=torch.int32, device=dev)
    from .._build import load_library

    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.tapstark_sha256_compress(
            state.data_ptr(), *st_strides, block.data_ptr(), n_lanes, rem_ptr, reps, nb,
            out.data_ptr(), _stream_ptr(dev),
        )
    if err != 0:
        raise RuntimeError(f"compress_wm: CUDA error {err}")
    launches["sha256_compress"] += 1
    return out if rem is not None else out.view(8, n_lanes)


def tapbranch_wm(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """TapBranch of each lane's two child digests: h1, h2 (8, M) int32
    words (any strides) → (8, M) contiguous."""
    if h1.device.type == "cpu":
        return tapbranch_wm_plain(h1, h2)
    if h1.device.type != "cuda":
        raise ValueError(f"tapbranch_wm: no path for device {h1.device}")
    dev = h1.device
    _check_words(h1, "tapbranch_wm h1", 2, dev)
    _check_words(h2, "tapbranch_wm h2", 2, dev)
    if h1.shape != h2.shape or h1.shape[0] != 8:
        raise ValueError(f"tapbranch_wm: shapes {tuple(h1.shape)}, {tuple(h2.shape)}")
    m = h1.shape[1]
    out = torch.empty((8, m), dtype=torch.int32, device=dev)
    from .._build import load_library

    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.tapstark_tapbranch(
            h1.data_ptr(), h1.stride(0), h1.stride(1), h2.data_ptr(), h2.stride(0), h2.stride(1),
            m, out.data_ptr(), _stream_ptr(dev),
        )
    if err != 0:
        raise RuntimeError(f"tapbranch_wm: CUDA error {err}")
    launches["tapbranch"] += 1
    return out
