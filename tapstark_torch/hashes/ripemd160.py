"""RIPEMD-160 and Bitcoin hash160 (= ripemd160(sha256(x))).

Used by the Winternitz hash chains
(reference scripts/src/bit_comm/winternitz.rs:96-113 uses bitcoin hash160).
Prefers the OpenSSL-backed hashlib implementation; a pure-Python fallback
keeps the framework functional where OpenSSL drops the algorithm.
"""

from __future__ import annotations

import hashlib

try:
    hashlib.new("ripemd160")
    _HAVE_NATIVE = True
except Exception:  # pragma: no cover - environment dependent
    _HAVE_NATIVE = False


def _ripemd160_py(data: bytes) -> bytes:
    # Pure-python RIPEMD-160 (from the public specification).
    K1 = (0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E)
    K2 = (0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000)
    R1 = (
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
        [7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8],
        [3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12],
        [1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2],
        [4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13],
    )
    R2 = (
        [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12],
        [6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2],
        [15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13],
        [8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14],
        [12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11],
    )
    S1 = (
        [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8],
        [7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12],
        [11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5],
        [11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12],
        [9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6],
    )
    S2 = (
        [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6],
        [9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11],
        [9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5],
        [15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8],
        [8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11],
    )

    def rol(x, n):
        return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF

    fns = (
        lambda x, y, z: x ^ y ^ z,
        lambda x, y, z: (x & y) | (~x & z),
        lambda x, y, z: (x | ~y) ^ z,
        lambda x, y, z: (x & z) | (y & ~z),
        lambda x, y, z: x ^ (y | ~z),
    )

    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    ml = len(data)
    data = data + b"\x80"
    data += b"\x00" * ((56 - len(data) % 64) % 64)
    data += (ml * 8).to_bytes(8, "little")
    for off in range(0, len(data), 64):
        x = [int.from_bytes(data[off + 4 * i : off + 4 * i + 4], "little") for i in range(16)]
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for rnd in range(5):
            f1 = fns[rnd]
            f2 = fns[4 - rnd]
            for j in range(16):
                t = (al + f1(bl, cl, dl) + x[R1[rnd][j]] + K1[rnd]) & 0xFFFFFFFF
                t = (rol(t, S1[rnd][j]) + el) & 0xFFFFFFFF
                al, bl, cl, dl, el = el, t, bl, rol(cl, 10), dl
                t = (ar + f2(br, cr, dr) + x[R2[rnd][j]] + K2[rnd]) & 0xFFFFFFFF
                t = (rol(t, S2[rnd][j]) + er) & 0xFFFFFFFF
                ar, br, cr, dr, er = er, t, br, rol(cr, 10), dr
        t = (h[1] + cl + dr) & 0xFFFFFFFF
        h[1] = (h[2] + dl + er) & 0xFFFFFFFF
        h[2] = (h[3] + el + ar) & 0xFFFFFFFF
        h[3] = (h[4] + al + br) & 0xFFFFFFFF
        h[4] = (h[0] + bl + cr) & 0xFFFFFFFF
        h[0] = t
    return b"".join(v.to_bytes(4, "little") for v in h)


def ripemd160(data: bytes) -> bytes:
    if _HAVE_NATIVE:
        h = hashlib.new("ripemd160")
        h.update(data)
        return h.digest()
    return _ripemd160_py(data)


def hash160(data: bytes) -> bytes:
    return ripemd160(hashlib.sha256(data).digest())
