"""BLAKE3 hash — scalar spec implementation + batched uint32 compression.

The Fiat-Shamir challenger permutes its 64-byte sponge state with a single
blake3 hash (reference basic/src/challenger/mod.rs:34-48), and the PoW grind
brute-forces that hash; the batched compression here runs the grind as one
vectorized batch over candidate witnesses (numpy, or torch tensors on a device).

No blake3 package is available in this environment; this is a from-spec
implementation validated against the official test vectors.
"""

from __future__ import annotations


IV = (
    0x6A09E667,
    0xBB67AE85,
    0x3C6EF372,
    0xA54FF53A,
    0x510E527F,
    0x9B05688C,
    0x1F83D9AB,
    0x5BE0CD19,
)
MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

_M32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def _g(st, a, b, c, d, mx, my):
    st[a] = (st[a] + st[b] + mx) & _M32
    st[d] = _rotr(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & _M32
    st[b] = _rotr(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b] + my) & _M32
    st[d] = _rotr(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & _M32
    st[b] = _rotr(st[b] ^ st[c], 7)


def _rounds(st, block_words) -> None:
    """The seven rounds, in place on the 16-word state. Words are ints, or
    arrays/tensors of ints (every add and shift in `_g` is masked to 32
    bits, a no-op on uint32)."""
    m = list(block_words)
    for r in range(7):
        _g(st, 0, 4, 8, 12, m[0], m[1])
        _g(st, 1, 5, 9, 13, m[2], m[3])
        _g(st, 2, 6, 10, 14, m[4], m[5])
        _g(st, 3, 7, 11, 15, m[6], m[7])
        _g(st, 0, 5, 10, 15, m[8], m[9])
        _g(st, 1, 6, 11, 12, m[10], m[11])
        _g(st, 2, 7, 8, 13, m[12], m[13])
        _g(st, 3, 4, 9, 14, m[14], m[15])
        if r != 6:
            m = [m[p] for p in MSG_PERMUTATION]


def compress(
    chaining_value, block_words, counter: int, block_len: int, flags: int
) -> list[int]:
    """One compression; returns the full 16-word output state."""
    st = [
        *chaining_value[:8],
        *IV[:4],
        counter & _M32,
        (counter >> 32) & _M32,
        block_len,
        flags,
    ]
    _rounds(st, block_words)
    out = [st[i] ^ st[i + 8] for i in range(8)]
    out += [st[i + 8] ^ chaining_value[i] for i in range(8)]
    return out


def _words_of(block: bytes) -> list[int]:
    block = block.ljust(64, b"\x00")
    return [int.from_bytes(block[i : i + 4], "little") for i in range(0, 64, 4)]


def _chunk_cv(chunk: bytes, chunk_counter: int, is_root: bool) -> list[int]:
    """Chaining value (or root output words) for one ≤1024-byte chunk."""
    blocks = [chunk[i : i + 64] for i in range(0, max(len(chunk), 1), 64)]
    cv = list(IV)
    for bi, block in enumerate(blocks):
        flags = 0
        if bi == 0:
            flags |= CHUNK_START
        if bi == len(blocks) - 1:
            flags |= CHUNK_END
            if is_root:
                flags |= ROOT
        cv = compress(cv, _words_of(block), chunk_counter, len(block), flags)[:8]
    return cv


def _subtree_cv(data: bytes, chunk_counter: int, is_root: bool) -> list[int]:
    if len(data) <= 1024:
        return _chunk_cv(data, chunk_counter, is_root)
    # left subtree takes the largest power-of-two number of chunks strictly
    # less than the total
    num_chunks = (len(data) + 1023) // 1024
    left_chunks = 1 << ((num_chunks - 1).bit_length() - 1)
    split = left_chunks * 1024
    left = _subtree_cv(data[:split], chunk_counter, False)
    right = _subtree_cv(data[split:], chunk_counter + left_chunks, False)
    flags = PARENT | (ROOT if is_root else 0)
    return compress(list(IV), left + right, 0, 64, flags)[:8]


def blake3(data: bytes) -> bytes:
    """32-byte blake3 digest."""
    cv = _subtree_cv(data, 0, True)
    return b"".join(w.to_bytes(4, "little") for w in cv)


# ---------------------------------------------------------------------------
# Batched compression — PoW grind kernel
# ---------------------------------------------------------------------------


def compress_batch(block_words, counter=0, block_len=64, flags=CHUNK_START | CHUNK_END | ROOT, cv=IV):
    """Vectorized single-block compression.

    block_words: 16 numpy uint32 arrays, or 16 int64 torch tensors with
    words in [0, 2^32) (torch has no unsigned 32-bit arithmetic), of a
    common shape and device. cv: 8 chaining-value words, ints or tensors
    that broadcast to the block words (defaults to the blake3 IV). Returns the 8 digest words h_i = v_i ^ v_{i+8}, of the
    block words' type."""
    zero = block_words[0] * 0
    st = [zero + (v & _M32) for v in (*cv, *IV[:4], counter, counter >> 32, block_len, flags)]
    _rounds(st, block_words)
    return [st[i] ^ st[i + 8] for i in range(8)]


def compress_scan(cv, block, counter: int, block_len, flags: int):
    """The reference's compression on vector state (`compress_scan`, its
    argument order): cv (..., 8) and block (..., 16) torch tensors of
    32-bit words (int32 bits or int64 values) → (..., 8) digest words as
    int32 bits, on `compress_batch`. block_len may be a tensor that
    broadcasts to the lanes."""
    import torch

    cv, block = (x.to(torch.int64) & _M32 for x in (cv, block))
    out = compress_batch([block[..., i] for i in range(16)], counter, block_len, flags,
                         cv=[cv[..., i] for i in range(8)])
    out = torch.stack(torch.broadcast_tensors(*out), dim=-1)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)
