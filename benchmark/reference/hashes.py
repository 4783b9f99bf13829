"""SHA-256, RIPEMD-160 and BLAKE3 for the reference, from their
specifications: lane-parallel compressions on int64 tensors (each lane
one message, words in [0, 2^32)), and scalar forms on Python ints for the
few hashes the transcript and the midstates need.
"""

from __future__ import annotations

import struct

import torch

M32 = 0xFFFFFFFF

# -- SHA-256 (FIPS 180-4) ----------------------------------------------------

SHA_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
SHA_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _sha_rounds(state, w):
    """One compression; state: 8 words, w: 16 words (ints or tensors)."""
    w = list(w)
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = (h + s1 + ch + SHA_K[t] + w[t]) & M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + t2) & M32
    return [(x + y) & M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """(N, 8) states and (N, 16) big-endian block words -> (N, 8)."""
    out = _sha_rounds(list(state.unbind(-1)), list(block.unbind(-1)))
    return torch.stack(out, dim=-1)


def sha256_compress_int(state, block_bytes: bytes) -> list[int]:
    return _sha_rounds(list(state), struct.unpack(">16I", block_bytes))


def sha256_midstate(data: bytes, state=SHA_IV) -> list[int]:
    """The state after the whole 64-byte blocks of data (the rest is the
    caller's)."""
    st = list(state)
    for i in range(0, len(data) - len(data) % 64, 64):
        st = sha256_compress_int(st, data[i : i + 64])
    return st


def sha256_pad(message_len: int, tail: bytes) -> bytes:
    """tail (the message's last len(tail) bytes, after whole blocks) with
    SHA-256 padding for a message of message_len bytes."""
    pad = b"\x80" + b"\x00" * ((55 - message_len) % 64) + struct.pack(">Q", 8 * message_len)
    return tail + pad


def words_to_bytes(words) -> bytes:
    return b"".join(int(w).to_bytes(4, "big") for w in words)


# -- RIPEMD-160 (Dobbertin, Bosselaers, Preneel) ------------------------------

_RL = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13,
)
_RR = (
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11,
)
_SL = (
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6,
)
_SR = (
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11,
)
_KL = (0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E)
_KR = (0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000)
RMD_IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)


def _rotl(x, n):
    return ((x << n) | (x >> (32 - n))) & M32


def _rmd_f(j, x, y, z):
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | ((x ^ M32) & z)
    if j < 48:
        return (x | (y ^ M32)) ^ z
    if j < 64:
        return (x & z) | (y & (z ^ M32))
    return x ^ (y | (z ^ M32))


def ripemd160_compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """(N, 5) states and (N, 16) little-endian block words -> (N, 5)."""
    h = list(state.unbind(-1))
    x = list(block.unbind(-1))
    al, bl, cl, dl, el = h
    ar, br, cr, dr, er = h
    for j in range(80):
        r = j // 16
        t = _rotl((al + _rmd_f(j, bl, cl, dl) + x[_RL[j]] + _KL[r]) & M32, _SL[j])
        t = (t + el) & M32
        al, el, dl, cl, bl = el, dl, _rotl(cl, 10), bl, t
        t = _rotl((ar + _rmd_f(79 - j, br, cr, dr) + x[_RR[j]] + _KR[r]) & M32, _SR[j])
        t = (t + er) & M32
        ar, er, dr, cr, br = er, dr, _rotl(cr, 10), br, t
    t = (h[1] + cl + dr) & M32
    out = [
        t,
        (h[2] + dl + er) & M32,
        (h[3] + el + ar) & M32,
        (h[4] + al + br) & M32,
        (h[0] + bl + cr) & M32,
    ]
    return torch.stack(out, dim=-1)


# -- byte <-> word helpers for lanes -----------------------------------------


def be_words(b: torch.Tensor) -> torch.Tensor:
    """(N, 4k) uint8-valued int64 -> (N, k) big-endian words."""
    b = b.view(b.shape[0], -1, 4)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def le_words(b: torch.Tensor) -> torch.Tensor:
    b = b.view(b.shape[0], -1, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def be_bytes(w: torch.Tensor) -> torch.Tensor:
    """(N, k) words -> (N, 4k) big-endian bytes."""
    return torch.stack([(w >> s) & 0xFF for s in (24, 16, 8, 0)], dim=-1).view(w.shape[0], -1)


def le_bytes(w: torch.Tensor) -> torch.Tensor:
    return torch.stack([(w >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1).view(w.shape[0], -1)


def hash160_lanes(msg: torch.Tensor) -> torch.Tensor:
    """(N, L) bytes, L <= 55 -> (N, 20) bytes of ripemd160(sha256(msg))."""
    n, length = msg.shape
    block = torch.zeros((n, 64), dtype=torch.int64, device=msg.device)
    block[:, :length] = msg
    block[:, length] = 0x80
    block[:, 56:] = torch.tensor(list(struct.pack(">Q", 8 * length)), dtype=torch.int64, device=msg.device)
    iv = torch.tensor(SHA_IV, dtype=torch.int64, device=msg.device).expand(n, 8)
    digest = be_bytes(sha256_compress(iv, be_words(block)))  # (N, 32)
    block = torch.zeros((n, 64), dtype=torch.int64, device=msg.device)
    block[:, :32] = digest
    block[:, 32] = 0x80
    block[:, 56:] = torch.tensor(list(struct.pack("<Q", 8 * 32)), dtype=torch.int64, device=msg.device)
    rmd_iv = torch.tensor(RMD_IV, dtype=torch.int64, device=msg.device).expand(n, 5)
    return le_bytes(ripemd160_compress(rmd_iv, le_words(block)))


# -- BLAKE3 (scalar) ------------------------------------------------------------

B3_IV = SHA_IV
_B3_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8


def _g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & M32
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & M32
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & M32
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & M32
    v[b] = _rotr(v[b] ^ v[c], 7)


def blake3_compress(cv, m, counter: int, block_len: int, flags: int) -> list[int]:
    """The 16 output words of one compression."""
    v = [*cv, *B3_IV[:4], counter & M32, (counter >> 32) & M32, block_len, flags]
    m = list(m)
    for r in range(7):
        _g(v, 0, 4, 8, 12, m[0], m[1])
        _g(v, 1, 5, 9, 13, m[2], m[3])
        _g(v, 2, 6, 10, 14, m[4], m[5])
        _g(v, 3, 7, 11, 15, m[6], m[7])
        _g(v, 0, 5, 10, 15, m[8], m[9])
        _g(v, 1, 6, 11, 12, m[10], m[11])
        _g(v, 2, 7, 8, 13, m[12], m[13])
        _g(v, 3, 4, 9, 14, m[14], m[15])
        m = [m[i] for i in _B3_PERM]
    return [v[i] ^ v[i + 8] for i in range(8)] + [v[i + 8] ^ cv[i] for i in range(8)]


def _b3_words(block: bytes) -> list[int]:
    return list(struct.unpack("<16I", block.ljust(64, b"\x00")))


def _b3_chunk(chunk: bytes, counter: int, root: bool) -> list[int]:
    blocks = [chunk[i : i + 64] for i in range(0, max(len(chunk), 1), 64)]
    cv = list(B3_IV)
    for i, block in enumerate(blocks):
        flags = (CHUNK_START if i == 0 else 0) | (CHUNK_END if i == len(blocks) - 1 else 0)
        if root and i == len(blocks) - 1:
            flags |= ROOT
        cv = blake3_compress(cv, _b3_words(block), counter, len(block), flags)[:8]
    return cv


def _b3_tree(data: bytes, counter: int, root: bool) -> list[int]:
    if len(data) <= 1024:
        return _b3_chunk(data, counter, root)
    chunks = (len(data) + 1023) // 1024
    left = 1 << ((chunks - 1).bit_length() - 1)
    lcv = _b3_tree(data[: 1024 * left], counter, False)
    rcv = _b3_tree(data[1024 * left :], counter + left, False)
    return blake3_compress(list(B3_IV), lcv + rcv, 0, 64, PARENT | (ROOT if root else 0))[:8]


def blake3(data: bytes) -> bytes:
    return struct.pack("<8I", *_b3_tree(data, 0, True))
