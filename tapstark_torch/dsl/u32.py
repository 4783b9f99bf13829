"""In-script u32 byte-quad arithmetic (BitVM style).

Reference parity: scripts/src/u32/* — a u32 occupies 4 stack items (bytes),
LSB on top: value v -> [b3 b2 b1 b0(top)]. Operations:
  - u32_add: byte-wise addition with carry chains (u32_add.rs);
  - u32_xor: via the u8 half-bit table f(x) = (x & 0b10101010) >> 1, the
    BitVM even/odd-bit decomposition (u32_xor.rs);
  - u32_rrot16/8/24: byte shuffles; general u32_rrot(n): per-byte split into
    (hi, lo) halves recombined across byte boundaries (u32_rrot.rs role).

The XOR table (256 entries, T[x] at depth x + junk) must be pushed below the
working area with `push_xor_table` and removed with `drop_xor_table`.
"""

from __future__ import annotations

from ..script import opcodes as op
from ..script.builder import ScriptBuilder

XOR_TABLE_SIZE = 256


def u32_push(v: int) -> ScriptBuilder:
    sb = ScriptBuilder()
    sb.num((v >> 24) & 0xFF).num((v >> 16) & 0xFF).num((v >> 8) & 0xFF).num(v & 0xFF)
    return sb


def push_xor_table() -> ScriptBuilder:
    """T[x] = (x & 0b10101010) >> 1, pushed T[255] first so that T[x] sits at
    depth x when the table top is the stack top."""
    sb = ScriptBuilder()
    for x in range(255, -1, -1):
        sb.num((x & 0b10101010) >> 1)
    return sb


def drop_xor_table() -> ScriptBuilder:
    sb = ScriptBuilder()
    for _ in range(XOR_TABLE_SIZE // 2):
        sb.emit(op.OP_2DROP)
    return sb


def _u8_add_carry(sb: ScriptBuilder) -> None:
    """[.., s] -> [.., s mod 256, carry] for s in [0, 511]."""
    sb.num(256).emit(op.OP_2DUP, op.OP_GREATERTHANOREQUAL)
    sb.emit(op.OP_IF, op.OP_SUB).num(1)
    sb.emit(op.OP_ELSE, op.OP_DROP).num(0)
    sb.emit(op.OP_ENDIF)


def _u8_drop_carry(sb: ScriptBuilder) -> None:
    """[.., s] -> [.., s mod 256] for s in [0, 511]."""
    sb.num(256).emit(op.OP_2DUP, op.OP_GREATERTHANOREQUAL)
    sb.emit(op.OP_IF, op.OP_SUB, op.OP_ELSE, op.OP_DROP, op.OP_ENDIF)


def u32_add() -> ScriptBuilder:
    """[a3 a2 a1 a0 b3 b2 b1 b0] -> [(a+b mod 2^32) quad]."""
    sb = ScriptBuilder()
    # byte 0
    sb.num(4).emit(op.OP_ROLL)  # a0 to top
    sb.emit(op.OP_ADD)
    _u8_add_carry(sb)
    sb.emit(op.OP_SWAP, op.OP_TOALTSTACK)  # byte0 -> alt, carry stays
    # bytes 1, 2
    for depth_a, depth_b in ((4, 2), (3, 1)):
        sb.num(depth_a).emit(op.OP_ROLL)  # a_i
        sb.num(depth_b).emit(op.OP_ROLL)  # b_i
        sb.emit(op.OP_ADD)
        sb.emit(op.OP_SWAP)  # carry under the sum
        sb.emit(op.OP_ADD)
        _u8_add_carry(sb)
        sb.emit(op.OP_SWAP, op.OP_TOALTSTACK)
    # byte 3 (final carry dropped: mod 2^32)
    sb.num(2).emit(op.OP_ROLL)
    sb.emit(op.OP_ADD, op.OP_ADD)
    _u8_drop_carry(sb)
    sb.emit(op.OP_TOALTSTACK)
    for _ in range(4):
        sb.emit(op.OP_FROMALTSTACK)
    return sb


def u8_xor(sb: ScriptBuilder, table_junk: int) -> None:
    """[.., A, B(top)] -> [.., A^B]; table_junk = items above the table top
    before A and B were pushed.

    BitVM even/odd decomposition with f(x) = (x & 0xAA) >> 1:
      2*f(x) = odd-position bits, x - 2*f(x) = even-position bits; sums
      within one parity class carry into the other class's positions, and
      xor = s - 2*f(s) recovers the carry-free bits."""
    i = table_junk

    def pick_f(junk_now: int) -> None:
        # [.., x] -> [.., x, f(x)]; junk_now counts items above the table
        # INCLUDING x itself
        sb.emit(op.OP_DUP)
        sb.num(junk_now).emit(op.OP_ADD, op.OP_PICK)

    # stack: [A, B]; items above table: i + 2
    pick_f(i + 2)  # [A, B, f_B]   (pick index = B + (i+2): B at depth i+2... )
    sb.emit(op.OP_DUP, op.OP_DUP, op.OP_ADD)  # [A, B, f_B, 2f_B]
    sb.emit(op.OP_ROT, op.OP_SWAP, op.OP_SUB)  # [A, f_B, B_even]
    sb.emit(op.OP_ROT)  # [f_B, B_even, A]
    pick_f(i + 3)  # [f_B, B_even, A, f_A]
    sb.emit(op.OP_DUP, op.OP_DUP, op.OP_ADD)  # [f_B, B_even, A, f_A, 2f_A]
    sb.emit(op.OP_ROT, op.OP_SWAP, op.OP_SUB)  # [f_B, B_even, f_A, A_even]
    sb.emit(op.OP_SWAP)  # [f_B, B_even, A_even, f_A]
    sb.num(3).emit(op.OP_ROLL, op.OP_ADD)  # [B_even, A_even, f_A+f_B]
    pick_f(i + 3)  # f(s_odd)
    sb.emit(op.OP_DUP, op.OP_ADD, op.OP_SUB)  # [B_even, A_even, odd_xor]
    sb.emit(op.OP_ROT, op.OP_ROT, op.OP_ADD)  # [odd_xor, A_even+B_even]
    pick_f(i + 2)
    sb.emit(op.OP_DUP, op.OP_ADD, op.OP_SUB)  # [odd_xor, even_xor]
    sb.emit(op.OP_SWAP, op.OP_DUP, op.OP_ADD, op.OP_ADD)  # even + 2*odd


def u32_xor(table_junk: int) -> ScriptBuilder:
    """[a quad, b quad] -> [(a^b) quad]; table_junk = items above the table
    top before the two quads were pushed."""
    sb = ScriptBuilder()
    for i in range(4):
        # remaining on main: (4-i) a-bytes then (4-i) b-bytes
        sb.num(4 - i).emit(op.OP_ROLL)  # a_i above b_i
        u8_xor(sb, table_junk + 2 * (4 - i) - 2)
        sb.emit(op.OP_TOALTSTACK)
    for _ in range(4):
        sb.emit(op.OP_FROMALTSTACK)
    return sb


def u32_rrot16() -> ScriptBuilder:
    return ScriptBuilder().emit(op.OP_2SWAP)


def u32_rrot8() -> ScriptBuilder:
    sb = ScriptBuilder().emit(op.OP_2SWAP)
    sb.num(3).emit(op.OP_ROLL)
    return sb


def u32_rrot24() -> ScriptBuilder:
    # [b3 b2 b1 b0] -> [b2 b1 b0 b3]
    return ScriptBuilder().num(3).emit(op.OP_ROLL)


def _u8_split(sb: ScriptBuilder, nbits: int) -> None:
    """[.., x] -> [.., hi, lo] with hi = x >> nbits, lo = x & (2^nbits-1)."""
    sb.num(0)  # [rem=x, hi=0]
    for j in range(7, nbits - 1, -1):
        sb.emit(op.OP_SWAP)  # [hi, rem]
        sb.emit(op.OP_DUP).num(1 << j).emit(op.OP_GREATERTHANOREQUAL)
        sb.emit(op.OP_IF)
        sb.num(1 << j).emit(op.OP_SUB)
        sb.emit(op.OP_SWAP)
        sb.num(1 << (j - nbits)).emit(op.OP_ADD)
        sb.emit(op.OP_SWAP)
        sb.emit(op.OP_ENDIF)
        sb.emit(op.OP_SWAP)  # [rem, hi]
    sb.emit(op.OP_SWAP)  # [hi, lo]


def _u8_extract_hbit(sb: ScriptBuilder, hbit: int) -> None:
    """[.., x] -> [.., lo_shifted, hi] with hi = x >> (8-hbit) and
    lo_shifted = (x & (2^(8-hbit)-1)) << hbit — the low part comes out
    PRE-SHIFTED so recombining across a byte boundary is a single OP_ADD
    (reference u32_rrot.rs:107-138 discipline; no doubling chain needed)."""
    assert 0 < hbit < 8
    sb.num(0).emit(op.OP_TOALTSTACK)
    for i in range(hbit):
        sb.emit(op.OP_DUP).num(127).emit(op.OP_GREATERTHAN)
        sb.emit(op.OP_IF)
        sb.num(128).emit(op.OP_SUB)
        sb.emit(op.OP_FROMALTSTACK)
        sb.num(1 << (hbit - 1 - i)).emit(op.OP_ADD)
        sb.emit(op.OP_TOALTSTACK)
        sb.emit(op.OP_ENDIF)
        sb.emit(op.OP_DUP, op.OP_ADD)
    sb.emit(op.OP_FROMALTSTACK)


def u32_rrot(n: int) -> ScriptBuilder:
    """General right-rotation by n of a u32 quad."""
    n %= 32
    q, r = divmod(n, 8)
    if r == 0:
        return {0: ScriptBuilder, 1: u32_rrot8, 2: u32_rrot16, 3: u32_rrot24}[q]()
    if r == 7:
        # rrot by 8q+7 = the 1-bit-boundary rotation, then byte-rotate by q
        return _u32_rrot7_core(q)
    hbit = 8 - r
    sb = ScriptBuilder()
    # [b3 b2 b1 b0(top)]: extract each byte into (lo << hbit, hi); the
    # pre-shifted lo of byte k combines with hi of byte (k+1) mod 4 by ADD
    _u8_extract_hbit(sb, hbit)  # b0 -> l0s, h0
    sb.emit(op.OP_ROT)
    _u8_extract_hbit(sb, hbit)  # b1
    sb.num(4).emit(op.OP_ROLL)
    _u8_extract_hbit(sb, hbit)  # b2
    sb.num(6).emit(op.OP_ROLL)
    _u8_extract_hbit(sb, hbit)  # b3
    # stack: l0s h0 l1s h1 l2s h2 l3s h3(top)
    # byte'_k(before byte-rot) = h_k + l_{(k+1)%4}s
    sb.num(7).emit(op.OP_ROLL, op.OP_ADD, op.OP_TOALTSTACK)  # h3 + l0s
    sb.emit(op.OP_ADD, op.OP_TOALTSTACK)  # h2 + l3s
    sb.emit(op.OP_ADD, op.OP_TOALTSTACK)  # h1 + l2s
    sb.emit(op.OP_ADD, op.OP_TOALTSTACK)  # h0 + l1s
    for _ in range(4):
        sb.emit(op.OP_FROMALTSTACK)
    # alt pops O0 first: stack is [O0 O1 O2 O3(top)] — reverse to the quad
    # convention [O3 O2 O1 O0(top)], then byte-rotate by q
    sb.emit(op.OP_SWAP, op.OP_2SWAP, op.OP_SWAP)
    _emit_byte_rot(sb, q)
    return sb


def _emit_byte_rot(sb: ScriptBuilder, q: int) -> None:
    if q == 1:
        sb.emit(op.OP_2SWAP)
        sb.num(3).emit(op.OP_ROLL)
    elif q == 2:
        sb.emit(op.OP_2SWAP)
    elif q == 3:
        sb.num(3).emit(op.OP_ROLL)


def _u32_rrot7_core(q: int) -> ScriptBuilder:
    """rrot by 8q+7: out byte O_k = msb(b_k) + 2*(b_{k+1 mod 4} & 127),
    then byte-rotate by q (reference u32_rrot7, u32_rrot.rs:46-88)."""
    sb = ScriptBuilder()

    def msb_split():
        # [.., x] -> [.., lo, msb]
        sb.num(128).emit(op.OP_2DUP, op.OP_GREATERTHANOREQUAL)
        sb.emit(op.OP_IF, op.OP_SUB).num(1)
        sb.emit(op.OP_ELSE, op.OP_DROP).num(0)
        sb.emit(op.OP_ENDIF)

    # [b3 b2 b1 b0(top)]
    msb_split()  # [b3 b2 b1 l0 m0]
    sb.emit(op.OP_ROT)  # [b3 b2 l0 m0 b1]
    msb_split()  # [b3 b2 l0 m0 l1 m1]
    sb.emit(op.OP_TOALTSTACK)  # [b3 b2 l0 m0 l1]  alt:[m1]
    sb.emit(op.OP_DUP, op.OP_ADD, op.OP_ADD)  # O0 = m0 + 2*l1
    sb.emit(op.OP_FROMALTSTACK)  # [b3 b2 l0 O0 m1]
    sb.num(3).emit(op.OP_ROLL)  # [b3 l0 O0 m1 b2]
    msb_split()  # [b3 l0 O0 m1 l2 m2]
    sb.emit(op.OP_TOALTSTACK)
    sb.emit(op.OP_DUP, op.OP_ADD, op.OP_ADD)  # O1 = m1 + 2*l2
    sb.emit(op.OP_FROMALTSTACK)  # [b3 l0 O0 O1 m2]
    sb.num(4).emit(op.OP_ROLL)  # [l0 O0 O1 m2 b3]
    msb_split()  # [l0 O0 O1 m2 l3 m3]
    sb.emit(op.OP_TOALTSTACK)
    sb.emit(op.OP_DUP, op.OP_ADD, op.OP_ADD)  # O2 = m2 + 2*l3
    sb.emit(op.OP_FROMALTSTACK)  # [l0 O0 O1 O2 m3]
    sb.num(4).emit(op.OP_ROLL)  # [O0 O1 O2 m3 l0]
    sb.emit(op.OP_DUP, op.OP_ADD, op.OP_ADD)  # O3 = m3 + 2*l0
    # [O0 O1 O2 O3(top)] -> [O3 O2 O1 O0(top)]
    sb.emit(op.OP_SWAP, op.OP_2SWAP, op.OP_SWAP)
    _emit_byte_rot(sb, q)
    return sb


def u32_rrot12() -> ScriptBuilder:
    return u32_rrot(12)


def u32_rrot7() -> ScriptBuilder:
    return u32_rrot(7)


def u32_roll(quads_deep: int) -> ScriptBuilder:
    """Move the u32 quad that is `quads_deep` quads below the top to the top."""
    sb = ScriptBuilder()
    d = 4 * quads_deep + 3
    for _ in range(4):
        sb.num(d).emit(op.OP_ROLL)
    return sb


def u32_pick(quads_deep: int) -> ScriptBuilder:
    """Copy the u32 quad that is `quads_deep` quads below the top to the top."""
    sb = ScriptBuilder()
    d = 4 * quads_deep + 3
    for _ in range(4):
        sb.num(d).emit(op.OP_PICK)
    return sb


def u32_drop() -> ScriptBuilder:
    return ScriptBuilder().emit(op.OP_2DROP, op.OP_2DROP)


def u32_equalverify() -> ScriptBuilder:
    """[a quad, b quad] -> () verifying equality."""
    sb = ScriptBuilder()
    for i in range(4):
        sb.num(4 - i).emit(op.OP_ROLL)
        sb.emit(op.OP_EQUALVERIFY)
    return sb


def u32_to_u31_f() -> ScriptBuilder:
    """[quad] -> [(word mod p) as a script number]: the challenger's
    byte-to-field sample conversion (value = LE word reduced mod BabyBear)."""
    from ..field.constants import P  # noqa: F401  (documentation)
    from .gadgets import u31_add, u31_mul_by_constant

    sb = ScriptBuilder()
    sb.emit(op.OP_TOALTSTACK, op.OP_TOALTSTACK)  # park b0, b1
    sb.emit(op.OP_SWAP)  # [b2, b3]
    for _ in range(8):
        sb.emit(op.OP_DUP, op.OP_ADD)  # b3 * 256
    sb.emit(op.OP_ADD)  # A = b3*256 + b2  (< 2^16)
    sb.extend(u31_mul_by_constant(1 << 16))  # A * 2^16 mod p
    sb.emit(op.OP_FROMALTSTACK)  # b1
    for _ in range(8):
        sb.emit(op.OP_DUP, op.OP_ADD)  # b1 * 256
    sb.emit(op.OP_FROMALTSTACK, op.OP_ADD)  # B = b1*256 + b0 (< 2^16 + 255)
    sb.extend(u31_add())
    return sb


def u32_extract_high_bits(bits: int) -> ScriptBuilder:
    """[quad] -> [word >> (32 - bits)]: the challenger's sample_bits
    (reference ExtractHighBits opcode role)."""
    assert 0 < bits < 32
    k = 32 - bits
    q, r = divmod(k, 8)
    sb = ScriptBuilder()
    for _ in range(q):
        sb.emit(op.OP_DROP)  # low bytes
    # acc = b_q >> r
    if r:
        _u8_split(sb, r)  # [hi, lo]
        sb.emit(op.OP_DROP)  # drop lo, keep hi as acc
    # add b_i << (8*(i-q) - r) for i in q+1..3
    for i in range(q + 1, 4):
        sb.emit(op.OP_SWAP)  # [.., acc, b_i]
        for _ in range(8 * (i - q) - r):
            sb.emit(op.OP_DUP, op.OP_ADD)
        sb.emit(op.OP_ADD)
    return sb
