"""Blake3 compression in Bitcoin Script.

Reference parity: scripts/src/hashes/blake3.rs (BitVM-style: state and
message words as u32 byte-quads, XOR via the half-bit table, G function with
rrot16/12/8/7). Used by the challenger-consistency scripts: the Fiat-Shamir
permutation is blake3 over the 64-byte sponge state, single block with
CHUNK_START|CHUNK_END|ROOT flags.

Gadget contract (single 64-byte block):
  stack in : [xor_table, m0..m15 quads (m15's LSB on top)]
  stack out: [xor_table, h0..h7 quads (h7's LSB on top)]
where h0..h7 are the first 8 output words (the 32-byte digest).
"""

from __future__ import annotations

from ..hashes.blake3 import CHUNK_END, CHUNK_START, IV, MSG_PERMUTATION, ROOT
from ..script import opcodes as op
from ..script.builder import ScriptBuilder
from .u32 import u32_add, u32_drop, u32_pick, u32_push, u32_roll, u32_rrot, u32_xor

_ROTS = (16, 12, 8, 7)


class _Env:
    """Tracks the order of u32 quads above the xor table (bottom first)."""

    def __init__(self, sb: ScriptBuilder, order: list[str]):
        self.sb = sb
        self.order = order

    def _qdepth(self, name: str) -> int:
        idx = self.order.index(name)
        return len(self.order) - 1 - idx

    def roll(self, name: str) -> None:
        self.sb.extend(u32_roll(self._qdepth(name)))
        self.order.remove(name)
        self.order.append(name)

    def pick(self, name: str, as_name: str = "_tmp") -> None:
        self.sb.extend(u32_pick(self._qdepth(name)))
        self.order.append(as_name)

    def add_top2(self, result: str) -> None:
        """[.., x, y] -> [.., x+y]"""
        self.sb.extend(u32_add())
        self.order.pop()
        self.order.pop()
        self.order.append(result)

    def xor_top2(self, result: str) -> None:
        junk = 4 * (len(self.order) - 2)
        self.sb.extend(u32_xor(table_junk=junk))
        self.order.pop()
        self.order.pop()
        self.order.append(result)

    def rrot_top(self, n: int) -> None:
        self.sb.extend(u32_rrot(n))


def _run_rounds(env: _Env, msg: list[str]) -> None:
    """The 7-round Blake3 core over state quads v0..v15 and the 16 message
    quads named in `msg` (round r addresses msg[perm^r])."""

    def g(a: str, b: str, c: str, d: str, mx: str, my: str) -> None:
        # va = va + vb + mx
        env.roll(a)
        env.pick(b)
        env.add_top2("_t")
        env.pick(mx)
        env.add_top2(a)
        # vd = rrot16(vd ^ va)
        env.roll(d)
        env.pick(a)
        env.xor_top2("_t")
        env.rrot_top(16)
        env.order[-1] = d
        # vc = vc + vd
        env.roll(c)
        env.pick(d)
        env.add_top2(c)
        # vb = rrot12(vb ^ vc)
        env.roll(b)
        env.pick(c)
        env.xor_top2("_t")
        env.rrot_top(12)
        env.order[-1] = b
        # va = va + vb + my
        env.roll(a)
        env.pick(b)
        env.add_top2("_t")
        env.pick(my)
        env.add_top2(a)
        # vd = rrot8(vd ^ va)
        env.roll(d)
        env.pick(a)
        env.xor_top2("_t")
        env.rrot_top(8)
        env.order[-1] = d
        # vc = vc + vd
        env.roll(c)
        env.pick(d)
        env.add_top2(c)
        # vb = rrot7(vb ^ vc)
        env.roll(b)
        env.pick(c)
        env.xor_top2("_t")
        env.rrot_top(7)
        env.order[-1] = b

    msg = list(msg)
    for rnd in range(7):
        g("v0", "v4", "v8", "v12", msg[0], msg[1])
        g("v1", "v5", "v9", "v13", msg[2], msg[3])
        g("v2", "v6", "v10", "v14", msg[4], msg[5])
        g("v3", "v7", "v11", "v15", msg[6], msg[7])
        g("v0", "v5", "v10", "v15", msg[8], msg[9])
        g("v1", "v6", "v11", "v12", msg[10], msg[11])
        g("v2", "v7", "v8", "v13", msg[12], msg[13])
        g("v3", "v4", "v9", "v14", msg[14], msg[15])
        if rnd != 6:
            msg = [msg[p] for p in MSG_PERMUTATION]


def blake3_compress_gadget(
    counter: int = 0,
    block_len: int = 64,
    flags: int = CHUNK_START | CHUNK_END | ROOT,
) -> ScriptBuilder:
    sb = ScriptBuilder()
    env = _Env(sb, [f"m{i}" for i in range(16)])

    # push the initial state v0..v15
    init = list(IV[:8]) + list(IV[:4]) + [
        counter & 0xFFFFFFFF,
        (counter >> 32) & 0xFFFFFFFF,
        block_len,
        flags,
    ]
    for i, w in enumerate(init):
        sb.extend(u32_push(w))
        env.order.append(f"v{i}")

    _run_rounds(env, [f"m{i}" for i in range(16)])

    # outputs: h_i = v_i ^ v_{i+8}, parked on the altstack h7-first so the
    # final restore leaves [h0 .. h7(top)] (capacity-carry friendly order)
    for i in range(7, -1, -1):
        env.roll(f"v{i}")
        env.roll(f"v{i + 8}")
        env.xor_top2("_out")
        env.order.pop()
        for _ in range(4):
            sb.emit(op.OP_TOALTSTACK)
    # drop the 16 message quads (64 bytes)
    for _ in range(32):
        sb.emit(op.OP_2DROP)
    # restore outputs: [h0 .. h7(top)]
    for _ in range(32):
        sb.emit(op.OP_FROMALTSTACK)
    return sb


def blake3_compress_chained_gadget(block_len: int = 64) -> ScriptBuilder:
    """One blake3 compression with a DYNAMIC chaining value — the challenger
    v2 duplex step f(cv, block, 0, block_len, CHUNK_START|CHUNK_END|ROOT)
    (see tapstark_torch/challenger).

    stack in : [xor_table, cv0..cv7 quads (cv7's LSB on top — exactly the
               output layout of a previous compress), m0..m15 quads
               (m15's LSB on top)]
    stack out: [xor_table, h0..h7 quads (h7's LSB on top)]
    """
    sb = ScriptBuilder()
    env = _Env(sb, [f"v{i}" for i in range(8)] + [f"m{i}" for i in range(16)])
    tail = list(IV[:4]) + [0, 0, block_len, CHUNK_START | CHUNK_END | ROOT]
    for i, w in enumerate(tail):
        sb.extend(u32_push(w))
        env.order.append(f"v{i + 8}")
    _run_rounds(env, [f"m{i}" for i in range(16)])
    # outputs h_i = v_i ^ v_{i+8}, parked h7-first so the restore leaves
    # [h0 .. h7(top)] — ready to chain into the next compression
    for i in range(7, -1, -1):
        env.roll(f"v{i}")
        env.roll(f"v{i + 8}")
        env.xor_top2("_out")
        env.order.pop()
        for _ in range(4):
            sb.emit(op.OP_TOALTSTACK)
    # drop the 16 message quads
    for _ in range(32):
        sb.emit(op.OP_2DROP)
    for _ in range(32):
        sb.emit(op.OP_FROMALTSTACK)
    return sb


def blake3_var_length_gadget(num_bytes: int) -> ScriptBuilder:
    """True blake3 of an arbitrary <=512-byte message, in script.

    Reference parity: blake3_var_length (scripts/src/hashes/blake3.rs:272) —
    single-chunk hashing with chained compressions: block 0 carries
    CHUNK_START, the final block CHUNK_END|ROOT, the chaining value h0..h7
    of block i becomes v0..v7 of block i+1; zero padding to a block multiple
    with block_len = true bytes per block.

    Own stack convention (the reference's ptr-machine layout is not copied):
      stack in : [xor_table, msg byte (n-1) ... msg byte 1, msg byte 0 (top)]
      stack out: [xor_table, h0..h7 quads (h7's LSB on top)]
    """
    assert 1 <= num_bytes <= 512, "single-chunk gadget: 512-byte limit"
    num_blocks = (num_bytes + 63) // 64
    pad = num_blocks * 64 - num_bytes

    sb = ScriptBuilder()
    # zero-pad the END of the message (deep side of the stack)
    if pad:
        for _ in range(pad):
            sb.num(0)
        for _ in range(num_bytes):
            sb.num(num_bytes + pad - 1).emit(op.OP_ROLL)

    # the padded byte stream IS quad-formatted: the top 4 bytes are block 0's
    # m0 as [b3 b2 b1 b0(top)], the next 4 are m1, ... so bottom->top the
    # quads read B_{k-1}m15 ... B0m15 .. B0m0(top)
    order: list[str] = []
    for j in range(num_blocks - 1, -1, -1):
        for i in range(15, -1, -1):
            order.append(f"B{j}m{i}")
    env = _Env(sb, order)

    remaining = num_bytes
    for j in range(num_blocks):
        last = j == num_blocks - 1
        block_len = min(remaining, 64)
        if num_blocks == 1:
            flags = CHUNK_START | CHUNK_END | ROOT
        elif j == 0:
            flags = CHUNK_START
        elif last:
            flags = CHUNK_END | ROOT
        else:
            flags = 0

        if j == 0:
            # fresh state: v0..v7 = IV
            for i, w in enumerate(IV[:8]):
                sb.extend(u32_push(w))
                env.order.append(f"v{i}")
        # v8..v15 = IV[0..4], counter=0, block_len, flags
        tail = list(IV[:4]) + [0, 0, block_len, flags]
        for i, w in enumerate(tail):
            sb.extend(u32_push(w))
            env.order.append(f"v{i + 8}")

        _run_rounds(env, [f"B{j}m{i}" for i in range(16)])

        if last:
            # digest: h_i = v_i ^ v_{i+8}, park on altstack h7-first
            for i in range(7, -1, -1):
                env.roll(f"v{i}")
                env.roll(f"v{i + 8}")
                env.xor_top2("_out")
                env.order.pop()
                for _ in range(4):
                    sb.emit(op.OP_TOALTSTACK)
            # drop this block's message quads
            for _ in range(16):
                sb.extend(u32_drop())
                env.order.pop()
            for _ in range(32):
                sb.emit(op.OP_FROMALTSTACK)
        else:
            # chaining value becomes v0..v7 of the next block
            for i in range(8):
                env.roll(f"v{i}")
                env.roll(f"v{i + 8}")
                env.xor_top2(f"v{i}")
            # drop this block's message quads
            for i in range(16):
                env.roll(f"B{j}m{i}")
                sb.extend(u32_drop())
                env.order.pop()
        remaining -= block_len
    return sb


def blake3_160_gadget() -> ScriptBuilder:
    """Blake3 of a 40-byte message truncated to a 20-byte digest
    (reference blake3_160, scripts/src/hashes/blake3.rs:415).

      stack in : [xor_table, msg byte 39 ... msg byte 0 (top)]
      stack out: [xor_table, h0..h4 quads (h4's LSB on top)]
    """
    sb = ScriptBuilder()
    # zero-pad bytes 40..63 (deep side)
    for _ in range(24):
        sb.num(0)
    for _ in range(40):
        sb.num(63).emit(op.OP_ROLL)

    order = [f"m{i}" for i in range(15, -1, -1)]
    env = _Env(sb, order)

    init = list(IV[:8]) + list(IV[:4]) + [0, 0, 40, CHUNK_START | CHUNK_END | ROOT]
    for i, w in enumerate(init):
        sb.extend(u32_push(w))
        env.order.append(f"v{i}")

    _run_rounds(env, [f"m{i}" for i in range(16)])

    # first 5 output words only
    for i in range(4, -1, -1):
        env.roll(f"v{i}")
        env.roll(f"v{i + 8}")
        env.xor_top2("_out")
        env.order.pop()
        for _ in range(4):
            sb.emit(op.OP_TOALTSTACK)
    # drop leftover state words (v5..v7, v13..v15) and the 16 message quads
    while env.order:
        sb.extend(u32_drop())
        env.order.pop()
    for _ in range(20):
        sb.emit(op.OP_FROMALTSTACK)
    return sb


def blake3_hash_equalverify() -> ScriptBuilder:
    """Verify a computed digest against an expected one
    (reference blake3_hash_equalverify, scripts/src/hashes/blake3.rs:485).

    stack in: [h0..h7 quads (computed, h7 on top), e7..e0 quads (expected,
    REVERSED quad order, e0 on top)] -> () on success; aborts on mismatch."""
    return _quads_equalverify(8)


def blake3_160_hash_equalverify() -> ScriptBuilder:
    """20-byte variant: [h0..h4, e4..e0 (reversed)] -> ()."""
    return _quads_equalverify(5)


def _quads_equalverify(n_quads: int) -> ScriptBuilder:
    from .u32 import u32_equalverify

    sb = ScriptBuilder()
    # park all but the top quad of b
    for _ in range(4 * (n_quads - 1)):
        sb.emit(op.OP_TOALTSTACK)
    sb.extend(u32_equalverify())  # compares a_{n-1} with b_{n-1}
    for _ in range(n_quads - 1):
        for _ in range(4):
            sb.emit(op.OP_FROMALTSTACK)
        sb.extend(u32_equalverify())
    return sb
