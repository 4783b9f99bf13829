"""In-script BabyBear field arithmetic gadgets.

Own designs filling the role of the external rust-bitcoin-u31-or-u30 crate
(u31_add/sub/neg/mul, u31ext_* — reference scripts/src/lib.rs:24-72 re-exports
them; the in-tree double-and-add mul at scripts/src/u31/mod.rs:17-129 is the
documented shape). All values are canonical BabyBear limbs (< p < 2^31), so
every intermediate fits a 4-byte script number: a+b mod p is computed as
a + (b - p) with a conditional +p fixup, keeping magnitudes below 2^31.

Extension elements occupy 4 stack slots with the HIGH coefficient deepest and
coefficient 0 on top ([a3 a2 a1 a0(top)]), matching the reference's push
order (e.g. bit_comm.rs:212-215 pushes a[3] a[2] a[1] a[0]).
"""

from __future__ import annotations

import functools

from ..field.constants import EXT_W, P
from ..script import opcodes as op
from ..script.builder import ScriptBuilder


def _sb() -> ScriptBuilder:
    return ScriptBuilder()


# ---------------------------------------------------------------------------
# base field (1 limb)
# ---------------------------------------------------------------------------


def u31_add() -> ScriptBuilder:
    """[a b] -> [(a+b) mod p]"""
    sb = _sb()
    sb.num(P).emit(op.OP_SUB)  # b - p (negative)
    sb.emit(op.OP_ADD)  # a + b - p in (-p, p)
    sb.emit(op.OP_DUP).num(0).emit(op.OP_LESSTHAN)
    sb.emit(op.OP_IF).num(P).emit(op.OP_ADD).emit(op.OP_ENDIF)
    return sb


def u31_sub() -> ScriptBuilder:
    """[a b] -> [(a-b) mod p]"""
    sb = _sb()
    sb.emit(op.OP_SUB)
    sb.emit(op.OP_DUP).num(0).emit(op.OP_LESSTHAN)
    sb.emit(op.OP_IF).num(P).emit(op.OP_ADD).emit(op.OP_ENDIF)
    return sb


def u31_neg() -> ScriptBuilder:
    """[a] -> [(-a) mod p]"""
    sb = _sb()
    sb.emit(op.OP_DUP, op.OP_0NOTEQUAL)
    sb.emit(op.OP_IF).num(P).emit(op.OP_SWAP, op.OP_SUB).emit(op.OP_ENDIF)
    return sb


def u31_double() -> ScriptBuilder:
    """[a] -> [2a mod p]"""
    sb = _sb()
    sb.emit(op.OP_DUP)
    sb.extend(u31_add())
    return sb


def u31_to_bits(bits: int = 31) -> ScriptBuilder:
    """[a] -> altstack gets a's bits LSB-pushed-last? No: pushes bit b_{bits-1}
    first ... b_0 last, leaving nothing on the main stack. (Each bit extracted
    high-to-low by threshold comparison.)"""
    sb = _sb()
    for j in range(bits - 1, -1, -1):
        sb.emit(op.OP_DUP).num(1 << j).emit(op.OP_GREATERTHANOREQUAL)
        sb.emit(op.OP_IF).num(1 << j).emit(op.OP_SUB).num(1)
        sb.emit(op.OP_ELSE).num(0).emit(op.OP_ENDIF)
        sb.emit(op.OP_TOALTSTACK)
    sb.emit(op.OP_DROP)  # the remaining 0
    return sb


@functools.lru_cache(maxsize=None)
def _u31_mul_bytes() -> bytes:
    """[a b] -> [a*b mod p] via add-and-double over b's 31 bits
    (the documented in-tree shape, scripts/src/u31/mod.rs)."""
    sb = _sb()
    # decompose b: altstack = [b30 ... b0(top)] — pops LSB-first below
    sb.extend(u31_to_bits())
    sb.num(0)  # stack: [a, acc]
    for j in range(31):
        sb.emit(op.OP_FROMALTSTACK)  # bit j (LSB first)
        sb.emit(op.OP_IF)
        sb.emit(op.OP_OVER)  # copy a*2^j
        sb.extend(u31_add())
        sb.emit(op.OP_ENDIF)
        if j != 30:
            sb.emit(op.OP_SWAP)
            sb.extend(u31_double())
            sb.emit(op.OP_SWAP)
    sb.emit(op.OP_NIP)  # drop the doubled a, keep acc
    return sb.build()


def u31_mul() -> ScriptBuilder:
    return ScriptBuilder(_u31_mul_bytes())


def u31_square() -> ScriptBuilder:
    sb = _sb()
    sb.emit(op.OP_DUP)
    sb.extend(u31_mul())
    return sb


def _naf_digits(c: int) -> list[int]:
    """Non-adjacent form, LSB first (digits in {-1, 0, 1}; leading digit 1)."""
    out = []
    while c:
        if c & 1:
            d = 2 - (c & 3)
            out.append(d)
            c -= d
        else:
            out.append(0)
        c >>= 1
    return out


@functools.lru_cache(maxsize=None)
def _u31_mul_by_constant_bytes(c: int) -> bytes:
    """[a] -> [a*c mod p] — fixed chain over the constant. Emits both the
    binary double-and-add chain and the NAF double-and-add/sub chain
    (~2/3 the nonzero digits) and keeps whichever is shorter."""
    c %= P
    sb = _sb()
    if c == 0:
        sb.emit(op.OP_DROP).num(0)
        return sb.build()

    def chain(digits_msb_to_lsb) -> bytes:
        s = _sb()
        s.emit(op.OP_DUP)  # [a, acc=a] (leading digit is 1)
        for d in digits_msb_to_lsb:
            s.extend(u31_double())
            if d == 1:
                s.emit(op.OP_OVER)
                s.extend(u31_add())
            elif d == -1:
                s.emit(op.OP_OVER)
                s.extend(u31_sub())
        s.emit(op.OP_NIP)
        return s.build()

    binary = chain([int(b) for b in bin(c)[3:]])
    naf = _naf_digits(c)
    nafc = chain(list(reversed(naf[:-1])))
    return binary if len(binary) <= len(nafc) else nafc


def u31_mul_by_constant(c: int) -> ScriptBuilder:
    return ScriptBuilder(_u31_mul_by_constant_bytes(int(c)))


def u31_equalverify() -> ScriptBuilder:
    return _sb().emit(op.OP_EQUALVERIFY)


# ---------------------------------------------------------------------------
# quartic extension (4 limbs, stack [a3 a2 a1 a0(top)])
# ---------------------------------------------------------------------------


def u31ext_push(limbs: list[int]) -> ScriptBuilder:
    """Push an extension constant [c0..c3] as [c3 c2 c1 c0(top)]."""
    sb = _sb()
    for v in reversed(limbs):
        sb.num(v % P)
    return sb


def u31ext_equalverify() -> ScriptBuilder:
    """[a3..a0 b3..b0] -> () verifying a == b."""
    sb = _sb()
    for i in range(4):
        # (4-i) remaining b-limbs sit above a_i
        sb.num(4 - i).emit(op.OP_ROLL)
        sb.emit(op.OP_EQUALVERIFY)
    return sb


def u31ext_add() -> ScriptBuilder:
    """[a3..a0 b3..b0] -> [(a+b)3..0]"""
    sb = _sb()
    for i in range(4):
        # stack holds (4-i) a-limbs then (4-i) b-limbs; a_i is at depth 4-i
        sb.num(4 - i).emit(op.OP_ROLL)
        sb.extend(u31_add())
        sb.emit(op.OP_TOALTSTACK)
    for _ in range(4):
        sb.emit(op.OP_FROMALTSTACK)
    return sb


def u31ext_sub() -> ScriptBuilder:
    """[a3..a0 b3..b0] -> [(a-b)3..0]"""
    sb = _sb()
    for i in range(4):
        sb.num(4 - i).emit(op.OP_ROLL)  # a_i to top (above b_i)
        sb.emit(op.OP_SWAP)  # [.., a_i, b_i(top)]
        sb.extend(u31_sub())
        sb.emit(op.OP_TOALTSTACK)
    for _ in range(4):
        sb.emit(op.OP_FROMALTSTACK)
    return sb


def u31ext_neg() -> ScriptBuilder:
    sb = _sb()
    for i in range(4):
        sb.extend(u31_neg())
        sb.emit(op.OP_TOALTSTACK)
    for _ in range(4):
        sb.emit(op.OP_FROMALTSTACK)
    return sb


def u31ext_double() -> ScriptBuilder:
    sb = _sb()
    for i in range(4):
        sb.extend(u31_double())
        sb.emit(op.OP_TOALTSTACK)
    for _ in range(4):
        sb.emit(op.OP_FROMALTSTACK)
    return sb


@functools.lru_cache(maxsize=None)
def _u31ext_mul_bytes() -> bytes:
    """[a3..a0 b3..b0] -> [(a*b)3..0]: schoolbook product with x^4 = W
    reduction. c_k = sum_{i+j=k} a_i b_j + W * sum_{i+j=k+4} a_i b_j."""
    sb = _sb()
    # stack layout (from top): b0=0 b1=1 b2=2 b3=3 a0=4 a1=5 a2=6 a3=7
    depth = {("b", 0): 0, ("b", 1): 1, ("b", 2): 2, ("b", 3): 3,
             ("a", 0): 4, ("a", 1): 5, ("a", 2): 6, ("a", 3): 7}

    def pick_pair(i: int, j: int, extra: int) -> None:
        # copy a_i and b_j to the top (extra = items already pushed above)
        sb.num(depth[("a", i)] + extra).emit(op.OP_PICK)
        sb.num(depth[("b", j)] + extra + 1).emit(op.OP_PICK)

    # compute c0..c3, parking each on the altstack (c0 first, so the final
    # unload leaves [c3 c2 c1 c0(top)])
    for k in (0, 1, 2, 3):
        lo_terms = [(i, k - i) for i in range(4) if 0 <= k - i < 4]
        hi_terms = [(i, k + 4 - i) for i in range(4) if 0 <= k + 4 - i < 4]
        first = True
        for i, j in lo_terms:
            pick_pair(i, j, 0 if first else 1)
            sb.extend(u31_mul())
            if not first:
                sb.extend(u31_add())
            first = False
        if hi_terms:
            hfirst = True
            for i, j in hi_terms:
                pick_pair(i, j, 1 if hfirst else 2)
                sb.extend(u31_mul())
                if not hfirst:
                    sb.extend(u31_add())
                hfirst = False
            sb.extend(u31_mul_by_constant(EXT_W))
            sb.extend(u31_add())
        sb.emit(op.OP_TOALTSTACK)
    # drop a and b (8 items)
    for _ in range(4):
        sb.emit(op.OP_2DROP)
    sb.emit(op.OP_FROMALTSTACK, op.OP_FROMALTSTACK, op.OP_FROMALTSTACK, op.OP_FROMALTSTACK)
    return sb.build()


def u31ext_mul() -> ScriptBuilder:
    return ScriptBuilder(_u31ext_mul_bytes())


def u31ext_mul_u31() -> ScriptBuilder:
    """[a3..a0 b] -> [(a*b)3..0] with base b."""
    sb = _sb()
    for i in range(4):
        if i < 3:
            # [.., a_i, b] -> [.., b, b, a_i] -> r_i to altstack, keep one b
            sb.emit(op.OP_DUP, op.OP_ROT)
            sb.extend(u31_mul())
            sb.emit(op.OP_TOALTSTACK)
        else:
            sb.extend(u31_mul())
            sb.emit(op.OP_TOALTSTACK)
    for _ in range(4):
        sb.emit(op.OP_FROMALTSTACK)
    return sb


def u31_to_u31ext() -> ScriptBuilder:
    """[a] -> [0 0 0 a(top)] (embed base into the extension)."""
    sb = _sb()
    sb.num(0).num(0).num(0)
    # stack [a 0 0 0] -> rearrange to [0 0 0 a]
    sb.num(3).emit(op.OP_ROLL)
    return sb


def u31_shr_const(k: int, width: int = 31) -> ScriptBuilder:
    """[n] -> [n >> k] for a script number 0 <= n < 2^width (bitwise
    threshold extraction; used by the challenger's sample_bits which shifts
    the mod-p REDUCED sample value)."""
    assert 0 <= k <= width
    sb = _sb()
    sb.num(0)  # [rem, acc]
    for j in range(width - 1, k - 1, -1):
        sb.emit(op.OP_SWAP)  # [acc, rem]
        sb.emit(op.OP_DUP).num(1 << j).emit(op.OP_GREATERTHANOREQUAL)
        sb.emit(op.OP_IF)
        sb.num(1 << j).emit(op.OP_SUB)
        sb.emit(op.OP_SWAP)
        sb.num(1 << (j - k)).emit(op.OP_ADD)
        sb.emit(op.OP_SWAP)
        sb.emit(op.OP_ENDIF)
        sb.emit(op.OP_SWAP)  # [rem, acc]
    sb.emit(op.OP_NIP)  # drop the remainder
    return sb


class _LimbEnv:
    """Single-limb stack environment for straight-line gadget emission."""

    def __init__(self, sb: ScriptBuilder, order: list[str]):
        self.sb = sb
        self.order = order

    def pick(self, name: str) -> None:
        self.sb.num(len(self.order) - 1 - self.order.index(name)).emit(op.OP_PICK)
        self.order.append("_t")

    def op2(self, gadget: ScriptBuilder, result: str) -> None:
        self.sb.extend(gadget)
        self.order.pop()
        self.order.pop()
        self.order.append(result)

    def to_alt(self) -> None:
        self.sb.emit(op.OP_TOALTSTACK)
        self.order.pop()


@functools.lru_cache(maxsize=None)
def _u31ext_mul_karatsuba_bytes() -> bytes:
    """[a3..a0 b3..b0] -> [(a*b)3..0] with 9 base muls (two-level Karatsuba
    over x^4 = W; the reference's external u31ext_mul is also Karatsuba)."""
    sb = _sb()
    env = _LimbEnv(sb, ["a3", "a2", "a1", "a0", "b3", "b2", "b1", "b0"])

    def add_named(x, y, result):
        env.pick(x)
        env.pick(y)
        env.op2(u31_add(), result)

    def mul_named(x, y, result):
        env.pick(x)
        env.pick(y)
        env.op2(u31_mul(), result)

    def sub2(x, y, z, result):
        # result = x - y - z
        env.pick(x)
        env.pick(y)
        env.op2(u31_sub(), "_d")
        env.pick(z)
        env.op2(u31_sub(), result)

    for x, y, r in (
        ("a0", "a1", "s0"), ("a2", "a3", "s1"), ("b0", "b1", "s2"),
        ("b2", "b3", "s3"), ("a0", "a2", "u0"), ("a1", "a3", "u1"),
        ("b0", "b2", "v0"), ("b1", "b3", "v1"),
    ):
        add_named(x, y, r)
    add_named("u0", "u1", "t0")
    add_named("v0", "v1", "t1")

    for x, y, r in (
        ("a0", "b0", "m1"), ("a1", "b1", "m2"), ("s0", "s2", "m3"),
        ("a2", "b2", "m4"), ("a3", "b3", "m5"), ("s1", "s3", "m6"),
        ("u0", "v0", "m7"), ("u1", "v1", "m8"), ("t0", "t1", "m9"),
    ):
        mul_named(x, y, r)

    sub2("m3", "m1", "m2", "p01")  # a0b1+a1b0
    sub2("m6", "m4", "m5", "p21")  # a2b3+a3b2
    sub2("m7", "m1", "m4", "p10")  # a0b2+a2b0
    sub2("m8", "m2", "m5", "p12")  # a1b3+a3b1
    sub2("m9", "m7", "m8", "_M1")  # middle coeff of (A0+A1)(B0+B1)
    sub2("_M1", "p01", "p21", "p11")  # c3 = M1 - p01 - p21

    # c0 = m1 + W*(m4 + p12)
    add_named("m4", "p12", "_w0")
    sb.extend(u31_mul_by_constant(EXT_W))
    env.pick("m1")
    env.op2(u31_add(), "c0")
    env.to_alt()
    # c1 = p01 + W*p21
    env.pick("p21")
    sb.extend(u31_mul_by_constant(EXT_W))
    env.order[-1] = "_w1"
    env.pick("p01")
    env.op2(u31_add(), "c1")
    env.to_alt()
    # c2 = m2 + p10 + W*m5
    env.pick("m5")
    sb.extend(u31_mul_by_constant(EXT_W))
    env.order[-1] = "_w2"
    env.pick("m2")
    env.op2(u31_add(), "_c2a")
    env.pick("p10")
    env.op2(u31_add(), "c2")
    env.to_alt()
    # c3 = p11
    env.pick("p11")
    env.to_alt()
    # drop everything left on the main stack
    remaining = len(env.order)
    for _ in range(remaining // 2):
        sb.emit(op.OP_2DROP)
    if remaining % 2:
        sb.emit(op.OP_DROP)
    # altstack: c0, c1, c2, c3(top) -> main [c3 c2 c1 c0(top)]
    for _ in range(4):
        sb.emit(op.OP_FROMALTSTACK)
    return sb.build()


@functools.lru_cache(maxsize=None)
def _u31ext_mul_by_constant_bytes(limbs: tuple) -> bytes:
    """[a3..a0] -> [(a*c)3..0] for a COMPILE-TIME extension constant
    c = (c0, c1, c2, c3). All b-side Karatsuba sums fold natively, so the 9
    dynamic base muls of u31ext_mul_karatsuba become 9 fixed double-and-add
    chains (~3x smaller). Single-nonzero-limb constants (monomials m*x^k)
    take a dedicated 4-mul path."""
    c = [v % P for v in limbs]
    sb = _sb()
    nz = [i for i, v in enumerate(c) if v]
    if not nz:
        sb.emit(op.OP_2DROP, op.OP_2DROP)
        sb.num(0).num(0).num(0).num(0)
        return sb.build()
    if nz == [0] and c[0] == 1:
        return sb.build()  # multiply by one: nop
    if len(nz) == 1:
        k = nz[0]
        m = c[k]
        # (a * m*x^k)_j = a_{(j-k)%4} * m * (W if j < k else 1)
        for j in range(4):
            i = (j - k) % 4
            sb.num(i).emit(op.OP_PICK)
            sb.extend(u31_mul_by_constant(m * EXT_W % P if j < k else m))
            sb.emit(op.OP_TOALTSTACK)
        sb.emit(op.OP_2DROP, op.OP_2DROP)
        for _ in range(4):
            sb.emit(op.OP_FROMALTSTACK)
        return sb.build()

    env = _LimbEnv(sb, ["a3", "a2", "a1", "a0"])

    def add_named(x, y, result):
        env.pick(x)
        env.pick(y)
        env.op2(u31_add(), result)

    def cmul_named(x, const, result):
        env.pick(x)
        sb.extend(u31_mul_by_constant(const))
        env.order[-1] = result

    def sub2(x, y, z, result):
        env.pick(x)
        env.pick(y)
        env.op2(u31_sub(), "_d")
        env.pick(z)
        env.op2(u31_sub(), result)

    for x, y, r in (
        ("a0", "a1", "s0"), ("a2", "a3", "s1"),
        ("a0", "a2", "u0"), ("a1", "a3", "u1"),
    ):
        add_named(x, y, r)
    add_named("u0", "u1", "t0")

    s2, s3 = (c[0] + c[1]) % P, (c[2] + c[3]) % P
    v0, v1 = (c[0] + c[2]) % P, (c[1] + c[3]) % P
    t1 = (v0 + v1) % P
    for x, k, r in (
        ("a0", c[0], "m1"), ("a1", c[1], "m2"), ("s0", s2, "m3"),
        ("a2", c[2], "m4"), ("a3", c[3], "m5"), ("s1", s3, "m6"),
        ("u0", v0, "m7"), ("u1", v1, "m8"), ("t0", t1, "m9"),
    ):
        cmul_named(x, k, r)

    sub2("m3", "m1", "m2", "p01")  # a0c1+a1c0
    sub2("m6", "m4", "m5", "p21")  # a2c3+a3c2
    sub2("m7", "m1", "m4", "p10")  # a0c2+a2c0
    sub2("m8", "m2", "m5", "p12")  # a1c3+a3c1
    sub2("m9", "m7", "m8", "_M1")
    sub2("_M1", "p01", "p21", "p11")

    # c0 = m1 + W*(m4 + p12)
    add_named("m4", "p12", "_w0")
    sb.extend(u31_mul_by_constant(EXT_W))
    env.pick("m1")
    env.op2(u31_add(), "c0")
    env.to_alt()
    # c1 = p01 + W*p21
    env.pick("p21")
    sb.extend(u31_mul_by_constant(EXT_W))
    env.order[-1] = "_w1"
    env.pick("p01")
    env.op2(u31_add(), "c1")
    env.to_alt()
    # c2 = m2 + p10 + W*m5
    env.pick("m5")
    sb.extend(u31_mul_by_constant(EXT_W))
    env.order[-1] = "_w2"
    env.pick("m2")
    env.op2(u31_add(), "_c2a")
    env.pick("p10")
    env.op2(u31_add(), "c2")
    env.to_alt()
    env.pick("p11")
    env.to_alt()
    remaining = len(env.order)
    for _ in range(remaining // 2):
        sb.emit(op.OP_2DROP)
    if remaining % 2:
        sb.emit(op.OP_DROP)
    for _ in range(4):
        sb.emit(op.OP_FROMALTSTACK)
    return sb.build()


def u31ext_mul_by_constant(limbs) -> ScriptBuilder:
    return ScriptBuilder(_u31ext_mul_by_constant_bytes(tuple(int(v) for v in limbs)))


def u31_mul_by_ext_constant(limbs) -> ScriptBuilder:
    """[a] -> [(a*c)3..0] for base a and an extension constant c: four fixed
    chains a*c_j (no cross terms, no W reduction)."""
    c = [int(v) % P for v in limbs]
    sb = _sb()
    for j in range(4):
        if j < 3:
            sb.emit(op.OP_DUP)
        sb.extend(u31_mul_by_constant(c[j]))
        sb.emit(op.OP_TOALTSTACK)
    for _ in range(4):
        sb.emit(op.OP_FROMALTSTACK)
    return sb


def u31ext_mul_karatsuba() -> ScriptBuilder:
    return ScriptBuilder(_u31ext_mul_karatsuba_bytes())
