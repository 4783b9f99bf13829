"""RecursionAir (163 columns): the constraint profile of a recursive
verifier. A hash lane of one ARX step a row on bit-decomposed words
(x, y, z = rotr12(x ^ y), a = x + z + m through 16-bit limbs with carry
bits ca, and an 11-bit injection m) and a field lane over the quartic
extension (beta copied down, bacc' = bacc * beta, facc' = facc + bacc *
(e1 - e0)). Public values: x0 and y0 as 16-bit halves, beta, the last
facc. 241 constraints of degree 2."""

from __future__ import annotations

from ..field import P, W

SECTIONS = [("x", 32), ("y", 32), ("z", 32), ("a", 32), ("ca", 4), ("m", 11),
            ("e0", 4), ("e1", 4), ("beta", 4), ("bacc", 4), ("facc", 4)]
OFFSETS = {}
_o = 0
for _name, _n in SECTIONS:
    OFFSETS[_name] = _o
    _o += _n
WIDTH = _o
NUM_PUBLIC = 12
DEGREE = 2
ROT = 12


def _cols(row, name):
    o = OFFSETS[name]
    return row[o : o + dict(SECTIONS)[name]]


def _limb(bits, lo, n=16):
    acc = 0
    for i in range(n):
        acc = acc + bits[lo + i] * (1 << i)
    return acc % P


def _ext_mul(a, b):
    def m(i, j):
        return a[i] * b[j] % P

    return [
        (m(0, 0) + W * ((m(1, 3) + m(2, 2) + m(3, 1)) % P)) % P,
        (m(0, 1) + m(1, 0) + W * ((m(2, 3) + m(3, 2)) % P)) % P,
        (m(0, 2) + m(1, 1) + m(2, 0) + W * m(3, 3)) % P,
        (m(0, 3) + m(1, 2) + m(2, 1) + m(3, 0)) % P,
    ]


def constraints(local, nxt, pis, sel):
    x, y, z, a = (_cols(local, s) for s in ("x", "y", "z", "a"))
    ca, m, e0, e1 = (_cols(local, s) for s in ("ca", "m", "e0", "e1"))
    beta, bacc, facc = (_cols(local, s) for s in ("beta", "bacc", "facc"))
    for col in x + y + a + ca + m:
        yield (col * col - col) % P
    for i in range(32):
        want = (x[i] + y[i] - 2 * (x[i] * y[i] % P)) % P
        yield (z[(i + 32 - ROT) % 32] - want) % P
    for limb in range(2):
        lo = 16 * limb
        s = _limb(x, lo) + _limb(z, lo)
        s = s + (_limb(m, 0, 11) if limb == 0 else ca[0] + 2 * ca[1])
        cout = ca[2 * limb] + 2 * ca[2 * limb + 1]
        yield (s - _limb(a, lo) - cout * (1 << 16)) % P
    diff = [(h - l) % P for h, l in zip(e1, e0)]
    bacc_next = _ext_mul(bacc, beta)
    facc_step = _ext_mul(bacc, diff)
    nb, nba, nf = (_cols(nxt, s) for s in ("beta", "bacc", "facc"))
    for k in range(4):
        yield sel.transition * ((nb[k] - beta[k]) % P) % P
        yield sel.transition * ((nba[k] - bacc_next[k]) % P) % P
        yield sel.transition * ((nf[k] - facc[k] - facc_step[k]) % P) % P
    nx, ny = _cols(nxt, "x"), _cols(nxt, "y")
    for i in range(32):
        yield sel.transition * ((nx[i] - a[i]) % P) % P
        yield sel.transition * ((ny[i] - z[i]) % P) % P
    for v, p in ((_limb(x, 0), pis[0]), (_limb(x, 16), pis[1]), (_limb(y, 0), pis[2]), (_limb(y, 16), pis[3])):
        yield sel.first * ((v - p) % P) % P
    for k in range(4):
        yield sel.first * ((beta[k] - pis[4 + k]) % P) % P
        yield sel.first * ((bacc[k] - pis[4 + k]) % P) % P
        yield sel.first * facc[k] % P
    for k in range(4):
        yield sel.last * ((facc[k] - pis[8 + k]) % P) % P
