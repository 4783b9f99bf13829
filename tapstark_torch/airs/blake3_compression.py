"""Full Blake3 compression AIR — one complete compression per 64-row block.

The BASELINE "Blake3-permutation AIR" config, completing what Blake3GAir
(airs/blake3g.py) demonstrates per quarter-round: all 7 rounds x 8 G
applications with the real message schedule, initial-state constants and the
output xor, over a 1548-column bit-decomposed trace.

Row p (p = row index, the trace is one 64-row compression) applies G #p for
p < 56 (round p//8, position p%8) and copies state for p in 56..63. The
G-to-state wiring is STATIC per position (state indices and message-schedule
indices are compile-time tables shared by the trace generator and the
constraints), selected in-circuit by a rotating one-hot position register:

  sel[0..63]            rotating one-hot (is_first pins sel[0])
  v0..v15 (16 x 32)     state bits entering the row
  m0..m15 (16 x 32)     message words (copied down the trace; first row
                        pinned to the public values)
  op_{a,b,c,d,mx,my}    this row's G operands: op = sum_p sel[p]*source(p)
  G internals           as in Blake3GAir (a1/ca1/d1/c1/cc1/b1/a2/ca2/d2/c2/
                        cc2/b2: additions with witnessed carries, xor+rot
                        as degree-2 bit relations)
  transition            next.v_i = v_i unless G #p writes it, in which case
                        the corresponding G output slot (selector-gated)
  output (is_last)      public values = half-words of v_i ^ v_{i+8}
                        (the 32-byte compression digest)

Public values (48): 32 half-words of m0..m15 then 16 half-words of the
digest words h0..h7. Constraint degree <= 3 (is_last x xor) -> two quotient
chunks. Blake3SpongeChainAir below chains k permutations (the challenger's
duplex sponge) in one trace of 64k rows.
"""

from __future__ import annotations

import numpy as np

from ..air import Air
from ..field.constants import P
from ..hashes.blake3 import CHUNK_END, CHUNK_START, IV, MSG_PERMUTATION, ROOT

ROWS = 64
N_G = 56

# -- static schedule tables --------------------------------------------------

_COLUMN_GS = [(0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15)]
_DIAGONAL_GS = [(0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)]


def _schedule():
    """Per G-position: (state indices (a,b,c,d), message indices (mx,my))."""
    out = []
    perm = list(range(16))
    for _r in range(7):
        gs = _COLUMN_GS + _DIAGONAL_GS
        for g, abcd in enumerate(gs):
            out.append((abcd, (perm[2 * g], perm[2 * g + 1])))
        perm = [perm[p] for p in MSG_PERMUTATION]
    return out


SCHEDULE = _schedule()

_INIT_STATE = list(IV[:8]) + list(IV[:4]) + [0, 0, 64, CHUNK_START | CHUNK_END | ROOT]

# -- column layout -----------------------------------------------------------

_SECTIONS = [("sel", ROWS)]
_SECTIONS += [(f"v{i}", 32) for i in range(16)]
_SECTIONS += [(f"m{i}", 32) for i in range(16)]
_SECTIONS += [(f"op_{n}", 32) for n in ("a", "b", "c", "d", "mx", "my")]
_SECTIONS += [
    ("a1", 32), ("ca1", 4), ("d1", 32), ("c1", 32), ("cc1", 2), ("b1", 32),
    ("a2", 32), ("ca2", 4), ("d2", 32), ("c2", 32), ("cc2", 2), ("b2", 32),
]

OFFSETS = {}
_off = 0
for _name, _n in _SECTIONS:
    OFFSETS[_name] = _off
    _off += _n
NUM_COLS = _off
_SIZES = dict(_SECTIONS)

# which G-output column feeds each touched state slot
_OUT_OF = {"a": "a2", "b": "b2", "c": "c2", "d": "d2"}
NUM_PUBLIC = 48


def _bits(row, name):
    o = OFFSETS[name]
    return [row[o + i] for i in range(_SIZES[name])]


def _limb(bits, lo, n=16):
    acc = bits[lo] * 1
    for i in range(1, n):
        acc = acc + bits[lo + i] * (1 << i)
    return acc


class Blake3CompressionAir(Air):
    def width(self) -> int:
        return NUM_COLS

    def eval(self, builder) -> None:
        main = builder.main()
        local = main.row(0)
        nxt = main.row(1)
        pis = builder.public_values()

        # 1. bitness everywhere
        for i in range(NUM_COLS):
            x = local[i]
            builder.assert_zero(x * x - x)

        sel = _bits(local, "sel")
        sel_next = _bits(nxt, "sel")

        # 2. selector register: one-hot sum, rotation, first-row pin
        s = sel[0] * 1
        for p in range(1, ROWS):
            s = s + sel[p]
        builder.assert_zero(s - 1)
        transition = builder.when_transition()
        for p in range(ROWS):
            transition.assert_eq(sel_next[(p + 1) % ROWS], sel[p])
        builder.when_first_row().assert_eq(sel[0], 1)

        state = [_bits(local, f"v{i}") for i in range(16)]
        state_next = [_bits(nxt, f"v{i}") for i in range(16)]
        msg = [_bits(local, f"m{i}") for i in range(16)]
        msg_next = [_bits(nxt, f"m{i}") for i in range(16)]

        # 3. operand wiring: op_w = sum_{p<56} sel[p] * source_w(p)
        ops = {n: _bits(local, f"op_{n}") for n in ("a", "b", "c", "d", "mx", "my")}
        for slot_i, slot in enumerate(("a", "b", "c", "d")):
            for bit in range(32):
                acc = None
                for p in range(N_G):
                    src = state[SCHEDULE[p][0][slot_i]][bit]
                    term = sel[p] * src
                    acc = term if acc is None else acc + term
                builder.assert_zero(ops[slot][bit] - acc)
        for slot_i, slot in enumerate(("mx", "my")):
            for bit in range(32):
                acc = None
                for p in range(N_G):
                    src = msg[SCHEDULE[p][1][slot_i]][bit]
                    term = sel[p] * src
                    acc = term if acc is None else acc + term
                builder.assert_zero(ops[slot][bit] - acc)

        # 4. G internals (identical relations to Blake3GAir, on op_* inputs)
        def xor(xb, yb):
            return [x + y - x * y * 2 for x, y in zip(xb, yb)]

        def rrot(bits, n):
            return [bits[(i + n) % 32] for i in range(32)]

        def add_constraints(out_name, carry_name, terms):
            out = _bits(local, out_name)
            carries = _bits(local, carry_name)
            ncar = len(carries) // 2
            for limb_i in range(2):
                lo = 16 * limb_i
                ssum = None
                for t in terms:
                    part = _limb(t, lo)
                    ssum = part if ssum is None else ssum + part
                if limb_i == 1:
                    cin = carries[0] * 1
                    for j in range(1, ncar):
                        cin = cin + carries[j] * (1 << j)
                    ssum = ssum + cin
                rhs = _limb(out, lo)
                cout = carries[ncar * limb_i] * 1
                for j in range(1, ncar):
                    cout = cout + carries[ncar * limb_i + j] * (1 << j)
                builder.assert_zero(ssum - (rhs + cout * (1 << 16)))

        a1 = _bits(local, "a1")
        d1 = _bits(local, "d1")
        c1 = _bits(local, "c1")
        b1 = _bits(local, "b1")
        a2 = _bits(local, "a2")
        d2 = _bits(local, "d2")
        c2 = _bits(local, "c2")
        b2 = _bits(local, "b2")

        add_constraints("a1", "ca1", [ops["a"], ops["b"], ops["mx"]])
        for i, want in enumerate(rrot(xor(ops["d"], a1), 16)):
            builder.assert_zero(d1[i] - want)
        add_constraints("c1", "cc1", [ops["c"], d1])
        for i, want in enumerate(rrot(xor(ops["b"], c1), 12)):
            builder.assert_zero(b1[i] - want)
        add_constraints("a2", "ca2", [a1, b1, ops["my"]])
        for i, want in enumerate(rrot(xor(d1, a2), 8)):
            builder.assert_zero(d2[i] - want)
        add_constraints("c2", "cc2", [c1, d2])
        for i, want in enumerate(rrot(xor(b1, c2), 7)):
            builder.assert_zero(b2[i] - want)

        g_out = {"a": a2, "b": b2, "c": c2, "d": d2}

        # 5. state transition: copied unless written by this row's G
        writers: dict[int, list] = {i: [] for i in range(16)}
        for p in range(N_G):
            abcd = SCHEDULE[p][0]
            for slot_i, slot in enumerate(("a", "b", "c", "d")):
                writers[abcd[slot_i]].append((p, slot))
        for i in range(16):
            for bit in range(32):
                delta = None
                for p, slot in writers[i]:
                    term = sel[p] * (g_out[slot][bit] - state[i][bit])
                    delta = term if delta is None else delta + term
                expected = state[i][bit] + delta
                transition.assert_eq(state_next[i][bit], expected)

        # 6. message copied down the trace; first row pinned to publics
        for i in range(16):
            for bit in range(32):
                transition.assert_eq(msg_next[i][bit], msg[i][bit])
        first = builder.when_first_row()
        for i in range(16):
            first.assert_eq(_limb(msg[i], 0), pis[2 * i])
            first.assert_eq(_limb(msg[i], 16), pis[2 * i + 1])

        # 7. initial state constants on the first row
        for i in range(16):
            for bit in range(32):
                first.assert_eq(state[i][bit], (_INIT_STATE[i] >> bit) & 1)

        # 8. output digest on the last row: h_i = v_i ^ v_{i+8}
        last = builder.when_last_row()
        for i in range(8):
            h = xor(state[i], state[i + 8])
            last.assert_eq(_limb(h, 0), pis[32 + 2 * i])
            last.assert_eq(_limb(h, 16), pis[32 + 2 * i + 1])


def generate_blake3_compression_trace(message: bytes):
    """Trace + public values for blake3 of one 64-byte message (the
    challenger-permutation shape: single block, CHUNK_START|CHUNK_END|ROOT)."""
    assert len(message) == 64
    m_words = [int.from_bytes(message[4 * i : 4 * i + 4], "little") for i in range(16)]
    rows = np.zeros((ROWS, NUM_COLS), dtype=np.uint32)
    M32 = 0xFFFFFFFF

    def put_bits(r, name, v, width=32):
        o = OFFSETS[name]
        for i in range(width):
            rows[r, o + i] = (v >> i) & 1

    def rr(v, n):
        return ((v >> n) | (v << (32 - n))) & M32

    state = list(_INIT_STATE)
    for r in range(ROWS):
        rows[r, OFFSETS["sel"] + r] = 1
        for i in range(16):
            put_bits(r, f"v{i}", state[i])
            put_bits(r, f"m{i}", m_words[i])
        if r < N_G:
            (ia, ib, ic, idd), (imx, imy) = SCHEDULE[r]
            a, b, c, d = state[ia], state[ib], state[ic], state[idd]
            mx, my = m_words[imx], m_words[imy]
            put_bits(r, "op_a", a)
            put_bits(r, "op_b", b)
            put_bits(r, "op_c", c)
            put_bits(r, "op_d", d)
            put_bits(r, "op_mx", mx)
            put_bits(r, "op_my", my)

            def add3(x, y, z, out_name, carry_name):
                s_lo = (x & 0xFFFF) + (y & 0xFFFF) + (z & 0xFFFF)
                car_lo = s_lo >> 16
                s_hi = (x >> 16) + (y >> 16) + (z >> 16) + car_lo
                car_hi = s_hi >> 16
                res = (x + y + z) & M32
                put_bits(r, out_name, res)
                ncar = _SIZES[carry_name] // 2
                put_bits(r, carry_name, car_lo | (car_hi << ncar), _SIZES[carry_name])
                return res

            a1 = add3(a, b, mx, "a1", "ca1")
            d1v = rr(d ^ a1, 16)
            put_bits(r, "d1", d1v)
            c1 = add3(c, d1v, 0, "c1", "cc1")
            b1v = rr(b ^ c1, 12)
            put_bits(r, "b1", b1v)
            a2 = add3(a1, b1v, my, "a2", "ca2")
            d2v = rr(d1v ^ a2, 8)
            put_bits(r, "d2", d2v)
            c2 = add3(c1, d2v, 0, "c2", "cc2")
            b2v = rr(b1v ^ c2, 7)
            put_bits(r, "b2", b2v)

            state[ia], state[ib], state[ic], state[idd] = a2, b2v, c2, d2v

    digest_words = [state[i] ^ state[i + 8] for i in range(8)]
    pis = []
    for w in m_words:
        pis += [w & 0xFFFF, w >> 16]
    for w in digest_words:
        pis += [w & 0xFFFF, w >> 16]
    digest = b"".join(w.to_bytes(4, "little") for w in digest_words)
    return rows, [int(x) for x in pis], digest


class Blake3SpongeChainAir(Blake3CompressionAir):
    """Chained Blake3 compressions — the challenger's v2 duplex as an AIR.

    The v2 duplex step (tapstark_torch/challenger; fills the role of the reference
    sponge, basic/src/challenger/mod.rs:34-48) is the blake3 compression
    function with a carried chaining value: cv' = f(cv, block, 0, 64,
    CHUNK_START|CHUNK_END|ROOT)[:8]. The trace is k 64-row blocks:

      - block start (sel[0] rows): v0..v7 = the chaining value (IV for the
        first block, the previous block's digest h after — the carry is a
        boundary constraint); v8..v15 = the fixed tail constants
        (IV[:4], t=0,0, b=64, flags); message words = this block's 16
        absorbed words (free witness, bitness-constrained, bound into the
        chain through the digest);
      - within a block: the inherited compression constraints;
      - public values (16): half-words of the FINAL digest h_i = v_i^v_{i+8}.
    """

    def eval(self, builder) -> None:
        main = builder.main()
        local = main.row(0)
        nxt = main.row(1)
        pis = builder.public_values()

        for i in range(NUM_COLS):
            x = local[i]
            builder.assert_zero(x * x - x)

        sel = _bits(local, "sel")
        sel_next = _bits(nxt, "sel")
        s = sel[0] * 1
        for p in range(1, ROWS):
            s = s + sel[p]
        builder.assert_zero(s - 1)
        transition = builder.when_transition()
        for p in range(ROWS):
            transition.assert_eq(sel_next[(p + 1) % ROWS], sel[p])
        first = builder.when_first_row()
        first.assert_eq(sel[0], 1)

        state = [_bits(local, f"v{i}") for i in range(16)]
        state_next = [_bits(nxt, f"v{i}") for i in range(16)]
        msg = [_bits(local, f"m{i}") for i in range(16)]
        msg_next = [_bits(nxt, f"m{i}") for i in range(16)]

        ops = {n: _bits(local, f"op_{n}") for n in ("a", "b", "c", "d", "mx", "my")}
        for slot_i, slot in enumerate(("a", "b", "c", "d")):
            for bit in range(32):
                acc = None
                for p in range(N_G):
                    term = sel[p] * state[SCHEDULE[p][0][slot_i]][bit]
                    acc = term if acc is None else acc + term
                builder.assert_zero(ops[slot][bit] - acc)
        for slot_i, slot in enumerate(("mx", "my")):
            for bit in range(32):
                acc = None
                for p in range(N_G):
                    term = sel[p] * msg[SCHEDULE[p][1][slot_i]][bit]
                    acc = term if acc is None else acc + term
                builder.assert_zero(ops[slot][bit] - acc)

        def xor(xb, yb):
            return [x + y - x * y * 2 for x, y in zip(xb, yb)]

        def rrot(bits, n):
            return [bits[(i + n) % 32] for i in range(32)]

        def add_constraints(out_name, carry_name, terms):
            out = _bits(local, out_name)
            carries = _bits(local, carry_name)
            ncar = len(carries) // 2
            for limb_i in range(2):
                lo = 16 * limb_i
                ssum = None
                for t in terms:
                    part = _limb(t, lo)
                    ssum = part if ssum is None else ssum + part
                if limb_i == 1:
                    cin = carries[0] * 1
                    for j in range(1, ncar):
                        cin = cin + carries[j] * (1 << j)
                    ssum = ssum + cin
                rhs = _limb(out, lo)
                cout = carries[ncar * limb_i] * 1
                for j in range(1, ncar):
                    cout = cout + carries[ncar * limb_i + j] * (1 << j)
                builder.assert_zero(ssum - (rhs + cout * (1 << 16)))

        a1 = _bits(local, "a1")
        d1 = _bits(local, "d1")
        c1 = _bits(local, "c1")
        b1 = _bits(local, "b1")
        a2 = _bits(local, "a2")
        d2 = _bits(local, "d2")
        c2 = _bits(local, "c2")
        b2 = _bits(local, "b2")

        add_constraints("a1", "ca1", [ops["a"], ops["b"], ops["mx"]])
        for i, want in enumerate(rrot(xor(ops["d"], a1), 16)):
            builder.assert_zero(d1[i] - want)
        add_constraints("c1", "cc1", [ops["c"], d1])
        for i, want in enumerate(rrot(xor(ops["b"], c1), 12)):
            builder.assert_zero(b1[i] - want)
        add_constraints("a2", "ca2", [a1, b1, ops["my"]])
        for i, want in enumerate(rrot(xor(d1, a2), 8)):
            builder.assert_zero(d2[i] - want)
        add_constraints("c2", "cc2", [c1, d2])
        for i, want in enumerate(rrot(xor(b1, c2), 7)):
            builder.assert_zero(b2[i] - want)

        g_out = {"a": a2, "b": b2, "c": c2, "d": d2}
        boundary = sel[63]

        # v transition: G writes within a block; at block boundaries the cv
        # half carries this block's digest h_i = v_i ^ v_{i+8} and the tail
        # half resets to the fixed constants
        writers = {i: [] for i in range(16)}
        for p in range(N_G):
            abcd = SCHEDULE[p][0]
            for slot_i, slot in enumerate(("a", "b", "c", "d")):
                writers[abcd[slot_i]].append((p, slot))
        for i in range(16):
            for bit in range(32):
                delta = None
                for p, slot in writers[i]:
                    term = sel[p] * (g_out[slot][bit] - state[i][bit])
                    delta = term if delta is None else delta + term
                expected = state[i][bit] + delta
                if i < 8:
                    h_bit = (
                        state[i][bit]
                        + state[i + 8][bit]
                        - state[i][bit] * state[i + 8][bit] * 2
                    )
                    transition.assert_zero(
                        (1 - boundary) * (state_next[i][bit] - expected)
                        + boundary * (state_next[i][bit] - h_bit)
                    )
                else:
                    init_bit = (_INIT_STATE[i] >> bit) & 1
                    transition.assert_zero(
                        (1 - boundary) * (state_next[i][bit] - expected)
                        + boundary * (state_next[i][bit] - init_bit)
                    )

        # message: copied within a block; fresh witness at each boundary
        for i in range(16):
            for bit in range(32):
                transition.assert_zero(
                    (1 - boundary) * (msg_next[i][bit] - msg[i][bit])
                )

        # first row: v = init state (cv = IV, fixed tail)
        for i in range(16):
            for bit in range(32):
                first.assert_eq(state[i][bit], (_INIT_STATE[i] >> bit) & 1)

        # final digest binding
        last = builder.when_last_row()
        for i in range(8):
            h = xor(state[i], state[i + 8])
            last.assert_eq(_limb(h, 0), pis[2 * i])
            last.assert_eq(_limb(h, 16), pis[2 * i + 1])


def generate_blake3_sponge_trace(observed_blocks: list[list[int]]):
    """Trace for a chain of v2 duplex compressions.

    observed_blocks[b] = up to 16 u32 words absorbed by compression b
    (zero-padded to a full 64-byte block; v0..v7 carry the previous
    compression's digest as the chaining value — exactly BfChallenger's
    full-block absorb step). Returns (trace, pis, final_digest_words)."""
    k = len(observed_blocks)
    rows = np.zeros((ROWS * k, NUM_COLS), dtype=np.uint32)
    M32 = 0xFFFFFFFF

    def put_bits(r, name, v, width=32):
        o = OFFSETS[name]
        for i in range(width):
            rows[r, o + i] = (v >> i) & 1

    def rr(v, n):
        return ((v >> n) | (v << (32 - n))) & M32

    cv = list(_INIT_STATE[:8])
    digest = None
    for blk, observed in enumerate(observed_blocks):
        m_words = [w & M32 for w in observed] + [0] * (16 - len(observed))
        state = list(cv) + list(_INIT_STATE[8:])
        base = blk * ROWS
        for rr_i in range(ROWS):
            r = base + rr_i
            rows[r, OFFSETS["sel"] + rr_i] = 1
            for i in range(16):
                put_bits(r, f"v{i}", state[i])
                put_bits(r, f"m{i}", m_words[i])
            if rr_i < N_G:
                (ia, ib, ic, idd), (imx, imy) = SCHEDULE[rr_i]
                a, b, c, d = state[ia], state[ib], state[ic], state[idd]
                mx, my = m_words[imx], m_words[imy]
                put_bits(r, "op_a", a)
                put_bits(r, "op_b", b)
                put_bits(r, "op_c", c)
                put_bits(r, "op_d", d)
                put_bits(r, "op_mx", mx)
                put_bits(r, "op_my", my)

                def add3(x, y, z, out_name, carry_name):
                    s_lo = (x & 0xFFFF) + (y & 0xFFFF) + (z & 0xFFFF)
                    car_lo = s_lo >> 16
                    s_hi = (x >> 16) + (y >> 16) + (z >> 16) + car_lo
                    car_hi = s_hi >> 16
                    res = (x + y + z) & M32
                    put_bits(r, out_name, res)
                    ncar = _SIZES[carry_name] // 2
                    put_bits(
                        r, carry_name, car_lo | (car_hi << ncar), _SIZES[carry_name]
                    )
                    return res

                a1 = add3(a, b, mx, "a1", "ca1")
                d1v = rr(d ^ a1, 16)
                put_bits(r, "d1", d1v)
                c1 = add3(c, d1v, 0, "c1", "cc1")
                b1v = rr(b ^ c1, 12)
                put_bits(r, "b1", b1v)
                a2 = add3(a1, b1v, my, "a2", "ca2")
                d2v = rr(d1v ^ a2, 8)
                put_bits(r, "d2", d2v)
                c2 = add3(c1, d2v, 0, "c2", "cc2")
                b2v = rr(b1v ^ c2, 7)
                put_bits(r, "b2", b2v)
                state[ia], state[ib], state[ic], state[idd] = a2, b2v, c2, d2v

        digest = [state[i] ^ state[i + 8] for i in range(8)]
        cv = list(digest)

    pis = []
    for w in digest:
        pis += [w & 0xFFFF, w >> 16]
    return rows, [int(x) for x in pis], digest
