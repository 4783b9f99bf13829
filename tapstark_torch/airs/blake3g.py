"""Blake3 G-function chain AIR — a wide, bit-decomposed hash trace.

The BASELINE "Blake3-permutation AIR" config class: every row applies one
full Blake3 G quarter-round to a 4-word state (a, b, c, d) with two
witnessed message words, all values bit-decomposed so XORs are degree-2
(x + y - 2xy) and 32-bit additions are 16-bit-limb sums with witnessed
carry bits. The next row's state is this row's G output (chained
permutation). 460 columns, all constraints degree <= 2 (single quotient
chunk).

Column layout (all bits):
  a, b, c, d          4 x 32   input state of the row
  mx, my              2 x 32   message words (witness-chosen, bit-constrained)
  a1 (=a+b+mx)        32 + 4 carry bits (2 per 16-bit limb)
  d1 (=rrot16(d^a1))  32
  c1 (=c+d1)          32 + 2 carry bits
  b1 (=rrot12(b^c1))  32
  a2 (=a1+b1+my)      32 + 4
  d2 (=rrot8(d1^a2))  32
  c2 (=c1+d2)         32 + 2
  b2 (=rrot7(b1^c2))  32
G output state = (a2, b2, c2, d2); transition pins next row's (a,b,c,d).
First row's state is pinned to the first 4 public-value words (bits derived
in-circuit from nothing — the words enter as public values, compared limb
by limb against the bit recompositions).
"""

from __future__ import annotations

import numpy as np

from ..air import Air
from ..field.constants import P

_ROTS = {"d1": 16, "b1": 12, "d2": 8, "b2": 7}

_SECTIONS = [
    ("a", 32), ("b", 32), ("c", 32), ("d", 32),
    ("mx", 32), ("my", 32),
    ("a1", 32), ("ca1", 4),
    ("d1", 32),
    ("c1", 32), ("cc1", 2),
    ("b1", 32),
    ("a2", 32), ("ca2", 4),
    ("d2", 32),
    ("c2", 32), ("cc2", 2),
    ("b2", 32),
]

_OFFSETS = {}
_off = 0
for _name, _n in _SECTIONS:
    _OFFSETS[_name] = _off
    _off += _n
NUM_COLS = _off  # 460


def _bits(row, name):
    o = _OFFSETS[name]
    n = dict(_SECTIONS)[name]
    return [row[o + i] for i in range(n)]


def _limb(bits, lo, n=16):
    acc = bits[lo] * 1
    for i in range(1, n):
        acc = acc + bits[lo + i] * (1 << i)
    return acc


class Blake3GAir(Air):
    """Chained Blake3 G quarter-rounds; public values = the 4 initial state
    words (as field elements < 2^32 split into two 16-bit halves each:
    8 public values lo0, hi0, lo1, hi1, ...)."""

    def width(self) -> int:
        return NUM_COLS

    def eval(self, builder) -> None:
        main = builder.main()
        local = main.row(0)
        nxt = main.row(1)
        pis = builder.public_values()

        # bitness for every column
        for i in range(NUM_COLS):
            x = local[i]
            builder.assert_zero(x * x - x)

        def xor(xb, yb):
            return [x + y - x * y * 2 for x, y in zip(xb, yb)]

        def rrot(bits, n):
            return [bits[(i + n) % 32] for i in range(32)]

        def add_constraints(out_name, carry_name, terms, max_carry_bits):
            """sum of term bit-lists == out bits + carries, per 16-bit limb."""
            out = _bits(local, out_name)
            carries = _bits(local, carry_name)
            ncar = len(carries) // 2
            for limb_i in range(2):
                lo = 16 * limb_i
                s = None
                for t in terms:
                    part = _limb(t, lo)
                    s = part if s is None else s + part
                # carry-in from the low limb
                if limb_i == 1:
                    cin = carries[0] * 1
                    for j in range(1, ncar):
                        cin = cin + carries[j] * (1 << j)
                    s = s + cin
                rhs = _limb(out, lo)
                cout = carries[ncar * limb_i] * 1
                for j in range(1, ncar):
                    cout = cout + carries[ncar * limb_i + j] * (1 << j)
                rhs = rhs + cout * (1 << 16)
                builder.assert_zero(s - rhs)

        a = _bits(local, "a")
        b = _bits(local, "b")
        c = _bits(local, "c")
        d = _bits(local, "d")
        mx = _bits(local, "mx")
        my = _bits(local, "my")
        a1 = _bits(local, "a1")
        d1 = _bits(local, "d1")
        c1 = _bits(local, "c1")
        b1 = _bits(local, "b1")
        a2 = _bits(local, "a2")
        d2 = _bits(local, "d2")
        c2 = _bits(local, "c2")
        b2 = _bits(local, "b2")

        # a1 = a + b + mx
        add_constraints("a1", "ca1", [a, b, mx], 2)
        # d1 = rrot16(d ^ a1)
        want_d1 = rrot(xor(d, a1), 16)
        for i in range(32):
            builder.assert_zero(d1[i] - want_d1[i])
        # c1 = c + d1
        add_constraints("c1", "cc1", [c, d1], 1)
        # b1 = rrot12(b ^ c1)
        want_b1 = rrot(xor(b, c1), 12)
        for i in range(32):
            builder.assert_zero(b1[i] - want_b1[i])
        # a2 = a1 + b1 + my
        add_constraints("a2", "ca2", [a1, b1, my], 2)
        # d2 = rrot8(d1 ^ a2)
        want_d2 = rrot(xor(d1, a2), 8)
        for i in range(32):
            builder.assert_zero(d2[i] - want_d2[i])
        # c2 = c1 + d2
        add_constraints("c2", "cc2", [c1, d2], 1)
        # b2 = rrot7(b1 ^ c2)
        want_b2 = rrot(xor(b1, c2), 7)
        for i in range(32):
            builder.assert_zero(b2[i] - want_b2[i])

        # chaining: next state = G output
        transition = builder.when_transition()
        for src, dst in (("a2", "a"), ("b2", "b"), ("c2", "c"), ("d2", "d")):
            sb = _bits(local, src)
            db = _bits(nxt, dst)
            for i in range(32):
                transition.assert_eq(db[i], sb[i])

        # first row pinned to the public initial state (two 16-bit halves
        # per word)
        first = builder.when_first_row()
        for wi, name in enumerate(("a", "b", "c", "d")):
            wb = _bits(local, name)
            first.assert_eq(_limb(wb, 0), pis[2 * wi])
            first.assert_eq(_limb(wb, 16), pis[2 * wi + 1])


def generate_blake3g_trace(
    state: tuple[int, int, int, int], n: int, seed: int = 0
) -> tuple[np.ndarray, list[int]]:
    """(n, NUM_COLS) canonical u32 trace + the 8 public half-words."""
    assert n > 0 and (n & (n - 1)) == 0
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, NUM_COLS), dtype=np.uint32)
    a, b, c, d = (int(x) & 0xFFFFFFFF for x in state)
    pis = []
    for w in (a, b, c, d):
        pis += [w & 0xFFFF, w >> 16]

    M = 0xFFFFFFFF

    def put_bits(r, name, v, width=32):
        o = _OFFSETS[name]
        for i in range(width):
            rows[r, o + i] = (v >> i) & 1

    def rr(v, n_):
        return ((v >> n_) | (v << (32 - n_))) & M

    for r in range(n):
        mx = int(rng.integers(0, 1 << 32))
        my = int(rng.integers(0, 1 << 32))
        put_bits(r, "a", a)
        put_bits(r, "b", b)
        put_bits(r, "c", c)
        put_bits(r, "d", d)
        put_bits(r, "mx", mx)
        put_bits(r, "my", my)

        def carries_of(total_lo, total_hi_with_cin, bits):
            return total_lo >> 16, total_hi_with_cin >> 16

        # a1 = a + b + mx
        s_lo = (a & 0xFFFF) + (b & 0xFFFF) + (mx & 0xFFFF)
        car_lo = s_lo >> 16
        s_hi = (a >> 16) + (b >> 16) + (mx >> 16) + car_lo
        car_hi = s_hi >> 16
        a1 = (a + b + mx) & M
        put_bits(r, "a1", a1)
        put_bits(r, "ca1", car_lo | (car_hi << 2), 4)
        d1 = rr(d ^ a1, 16)
        put_bits(r, "d1", d1)
        s_lo = (c & 0xFFFF) + (d1 & 0xFFFF)
        car_lo = s_lo >> 16
        s_hi = (c >> 16) + (d1 >> 16) + car_lo
        car_hi = s_hi >> 16
        c1 = (c + d1) & M
        put_bits(r, "c1", c1)
        put_bits(r, "cc1", car_lo | (car_hi << 1), 2)
        b1 = rr(b ^ c1, 12)
        put_bits(r, "b1", b1)
        s_lo = (a1 & 0xFFFF) + (b1 & 0xFFFF) + (my & 0xFFFF)
        car_lo = s_lo >> 16
        s_hi = (a1 >> 16) + (b1 >> 16) + (my >> 16) + car_lo
        car_hi = s_hi >> 16
        a2 = (a1 + b1 + my) & M
        put_bits(r, "a2", a2)
        put_bits(r, "ca2", car_lo | (car_hi << 2), 4)
        d2 = rr(d1 ^ a2, 8)
        put_bits(r, "d2", d2)
        s_lo = (c1 & 0xFFFF) + (d2 & 0xFFFF)
        car_lo = s_lo >> 16
        s_hi = (c1 >> 16) + (d2 >> 16) + car_lo
        car_hi = s_hi >> 16
        c2 = (c1 + d2) & M
        put_bits(r, "c2", c2)
        put_bits(r, "cc2", car_lo | (car_hi << 1), 2)
        b2 = rr(b1 ^ c2, 7)
        put_bits(r, "b2", b2)

        a, b, c, d = a2, b2, c2, d2

    return rows, [int(x) for x in pis]
