"""RecursionAir — a circuit-real 163-column recursion-shaped AIR.

The reference's wide-table row models a *recursive RISC0 verifier program*
(2^18 rows x 163 cols, tap-stark's README.md:101). Its constraint set is
unavailable (the row is an estimate that cannot execute), so this AIR
reproduces the constraint PROFILE of a recursive STARK verifier circuit with
real, verifiable semantics rather than a synthetic degree-2 coupling:

- a **hash lane** (143 cols): one ARX mixing step per row on two 32-bit
  words, fully bit-decomposed — booleanity on every witness bit, xor via
  x + y - 2xy, a fixed rotation, and a 32-bit add through 16-bit limbs with
  witnessed carry bits. This is the dominant constraint shape of any
  recursive verifier (Merkle-path and transcript hashing): RISC0's recursion
  circuit spends most of its cycles in SHA-256/Poseidon rounds with exactly
  this bit/carry structure.
- a **field lane** (20 cols): a running FRI-fold accumulator over the
  quartic extension — facc' = facc + bacc*(e1 - e0) with bacc' = bacc*beta —
  the other half of a recursive verifier's work (folding opened values by
  verifier challenges). The EF4 products expand to the full 16-term
  binomial-extension component constraints (x^4 = 11), degree 2 in the
  trace.

Column layout (163 = 4*32 + 4 + 11 + 5*4):
  x     32 bits   state word A
  y     32 bits   state word B
  z     32 bits   z = rrot12(x ^ y)
  a     32 bits   a = (x + z + m) mod 2^32
  ca     4 bits   add carries (2 per 16-bit limb)
  m     11 bits   witness injection word (m < 2^11)
  e0     4        EF4 opened value (witness)
  e1     4        EF4 opened value (witness)
  beta   4        EF4 fold challenge (public, copied down the trace)
  bacc   4        running challenge power: bacc' = bacc * beta
  facc   4        fold accumulator: facc' = facc + bacc * (e1 - e0)

Transitions chain the hash state (x' = a, y' = z) and the field lane; the
first row pins (x, y) and beta to public values, the last row pins the
final fold accumulator. Max constraint degree 2 (same quotient chunking as
the reference's shape). ~240 constraints.
"""

from __future__ import annotations

import numpy as np

from ..air import Air
from ..field.constants import EXT_W, P
from ..field.scalar import EF4

_ROT = 12

_SECTIONS = [
    ("x", 32),
    ("y", 32),
    ("z", 32),
    ("a", 32),
    ("ca", 4),
    ("m", 11),
    ("e0", 4),
    ("e1", 4),
    ("beta", 4),
    ("bacc", 4),
    ("facc", 4),
]

_OFFSETS = {}
_off = 0
for _name, _n in _SECTIONS:
    _OFFSETS[_name] = _off
    _off += _n
NUM_COLS = _off  # 163


def _cols(row, name):
    o = _OFFSETS[name]
    n = dict(_SECTIONS)[name]
    return [row[o + i] for i in range(n)]


def _limb(bits, lo, n=16):
    acc = bits[lo] * 1
    for i in range(1, n):
        acc = acc + bits[lo + i] * (1 << i)
    return acc


def _ext_mul(a, b):
    """Component expressions of the EF4 product (x^4 = EXT_W binomial)."""
    w = EXT_W
    return [
        a[0] * b[0] + (a[1] * b[3] + a[2] * b[2] + a[3] * b[1]) * w,
        a[0] * b[1] + a[1] * b[0] + (a[2] * b[3] + a[3] * b[2]) * w,
        a[0] * b[2] + a[1] * b[1] + a[2] * b[0] + (a[3] * b[3]) * w,
        a[0] * b[3] + a[1] * b[2] + a[2] * b[1] + a[3] * b[0],
    ]


class RecursionAir(Air):
    """Public values (12): x0_lo, x0_hi, y0_lo, y0_hi, beta[0..4),
    facc_final[0..4)."""

    def width(self) -> int:
        return NUM_COLS

    def eval(self, builder) -> None:
        main = builder.main()
        local = main.row(0)
        nxt = main.row(1)
        pis = builder.public_values()

        x = _cols(local, "x")
        y = _cols(local, "y")
        z = _cols(local, "z")
        a = _cols(local, "a")
        ca = _cols(local, "ca")
        m = _cols(local, "m")
        e0 = _cols(local, "e0")
        e1 = _cols(local, "e1")
        beta = _cols(local, "beta")
        bacc = _cols(local, "bacc")
        facc = _cols(local, "facc")

        # booleanity on every witness bit column (z's is implied by its xor
        # constraint once x and y are bits)
        for col in x + y + a + ca + m:
            builder.assert_zero(col * col - col)

        # z = rrot12(x ^ y): z[(i + 32 - ROT) % 32] == x[i] + y[i] - 2 x[i] y[i]
        for i in range(32):
            want = x[i] + y[i] - x[i] * y[i] * 2
            builder.assert_zero(z[(i + 32 - _ROT) % 32] - want)

        # a = (x + z + m) mod 2^32 through 16-bit limbs, 2 carry bits each
        for limb_i in range(2):
            lo = 16 * limb_i
            s = _limb(x, lo) + _limb(z, lo)
            if limb_i == 0:
                s = s + _limb(m, 0, 11)  # m < 2^11 lives in the low limb
            else:
                s = s + ca[0] * 1 + ca[1] * 2  # carry-in from the low limb
            cout = ca[2 * limb_i] * 1 + ca[2 * limb_i + 1] * 2
            builder.assert_zero(s - _limb(a, lo) - cout * (1 << 16))

        # field lane: bacc' = bacc * beta, facc' = facc + bacc * (e1 - e0),
        # beta copied down the trace
        transition = builder.when_transition()
        diff = [h - l for h, l in zip(e1, e0)]
        bacc_next = _ext_mul(bacc, beta)
        facc_step = _ext_mul(bacc, diff)
        nxt_beta = _cols(nxt, "beta")
        nxt_bacc = _cols(nxt, "bacc")
        nxt_facc = _cols(nxt, "facc")
        for k in range(4):
            transition.assert_eq(nxt_beta[k], beta[k])
            transition.assert_eq(nxt_bacc[k], bacc_next[k])
            transition.assert_eq(nxt_facc[k], facc[k] + facc_step[k])

        # hash-state chaining: x' = a, y' = z
        nxt_x = _cols(nxt, "x")
        nxt_y = _cols(nxt, "y")
        for i in range(32):
            transition.assert_eq(nxt_x[i], a[i])
            transition.assert_eq(nxt_y[i], z[i])

        # first row: pin (x, y) to the public half-words, beta to the public
        # challenge, bacc = beta, facc = 0
        first = builder.when_first_row()
        first.assert_eq(_limb(x, 0), pis[0])
        first.assert_eq(_limb(x, 16), pis[1])
        first.assert_eq(_limb(y, 0), pis[2])
        first.assert_eq(_limb(y, 16), pis[3])
        for k in range(4):
            first.assert_eq(beta[k], pis[4 + k])
            first.assert_eq(bacc[k], pis[4 + k])
            first.assert_zero(facc[k])

        # last row: the accumulated fold value is the circuit's output
        last = builder.when_last_row()
        for k in range(4):
            last.assert_eq(facc[k], pis[8 + k])


def generate_recursion_trace(
    n: int, seed: int = 0, x0: int = 0x6A09E667, y0: int = 0xBB67AE85
) -> tuple[np.ndarray, list[int]]:
    """(n, NUM_COLS) canonical trace + the 12 public values."""
    assert n > 0 and (n & (n - 1)) == 0
    rng = np.random.default_rng(seed)
    M = 0xFFFFFFFF

    def rr(v, k):
        return ((v >> k) | (v << (32 - k))) & M

    # word chain (cheap python-int loop), bit expansion vectorized below
    xs = np.empty(n, np.uint64)
    ys = np.empty(n, np.uint64)
    zs = np.empty(n, np.uint64)
    as_ = np.empty(n, np.uint64)
    cas = np.empty(n, np.uint64)
    ms = rng.integers(0, 1 << 11, n).astype(np.uint64)
    x, y = int(x0) & M, int(y0) & M
    for r in range(n):
        z = rr(x ^ y, _ROT)
        m = int(ms[r])
        full = x + z + m
        a = full & M
        c_lo = ((x & 0xFFFF) + (z & 0xFFFF) + m) >> 16
        c_hi = ((x >> 16) + (z >> 16) + c_lo) >> 16
        xs[r], ys[r], zs[r], as_[r] = x, y, z, a
        cas[r] = (c_lo & 3) | ((c_hi & 3) << 2)
        x, y = a, z

    beta = EF4(tuple(int(v) for v in rng.integers(1, P, 4)))
    e0s = rng.integers(0, P, (n, 4))
    e1s = rng.integers(0, P, (n, 4))
    baccs = np.empty((n, 4), np.uint32)
    faccs = np.empty((n, 4), np.uint32)
    bacc, facc = beta, EF4.zero()
    for r in range(n):
        baccs[r] = bacc.c
        faccs[r] = facc.c
        d = EF4(tuple(int(v) for v in e1s[r])) - EF4(tuple(int(v) for v in e0s[r]))
        facc = facc + bacc * d
        bacc = bacc * beta

    rows = np.zeros((n, NUM_COLS), dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint64)
    for name, words in (("x", xs), ("y", ys), ("z", zs), ("a", as_)):
        o = _OFFSETS[name]
        rows[:, o : o + 32] = ((words[:, None] >> shifts) & 1).astype(np.uint32)
    rows[:, _OFFSETS["ca"] : _OFFSETS["ca"] + 4] = (
        (cas[:, None] >> shifts[:4]) & 1
    ).astype(np.uint32)
    rows[:, _OFFSETS["m"] : _OFFSETS["m"] + 11] = (
        (ms[:, None] >> shifts[:11]) & 1
    ).astype(np.uint32)
    rows[:, _OFFSETS["e0"] : _OFFSETS["e0"] + 4] = e0s.astype(np.uint32)
    rows[:, _OFFSETS["e1"] : _OFFSETS["e1"] + 4] = e1s.astype(np.uint32)
    rows[:, _OFFSETS["beta"] : _OFFSETS["beta"] + 4] = np.array(beta.c, np.uint32)[None, :]
    rows[:, _OFFSETS["bacc"] : _OFFSETS["bacc"] + 4] = baccs
    rows[:, _OFFSETS["facc"] : _OFFSETS["facc"] + 4] = faccs

    pis = [int(xs[0]) & 0xFFFF, int(xs[0]) >> 16, int(ys[0]) & 0xFFFF, int(ys[0]) >> 16]
    pis += list(beta.c)
    pis += [int(v) for v in faccs[-1]]
    return rows, pis
