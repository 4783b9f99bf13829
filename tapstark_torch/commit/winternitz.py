"""Winternitz one-time signatures over u32 messages (BitVM scheme).

Behavioral port of the reference gadget
(tap-stark's scripts/src/bit_comm/winternitz.rs): LOG_D=4 (hex digits),
N0=8 message digits per u32, N1=2 checksum digits, hash160 chains of length
16. checksig_verify leaves the 4 message bytes on the stack, LSB on top.
"""

from __future__ import annotations

import functools

from ..hashes.ripemd160 import hash160
from ..script import opcodes as op
from ..script.builder import ScriptBuilder

LOG_D = 4
DIGITS = (1 << LOG_D) - 1  # 15
N0 = 8
N1 = 2
N = N0 + N1


def to_digits(number: int, digit_count: int) -> list[int]:
    """Base-16 little-endian digits."""
    return [(number >> (LOG_D * i)) & DIGITS for i in range(digit_count)]


def checksum(message_digits: list[int]) -> int:
    assert len(message_digits) == N0
    return DIGITS * N0 - sum(message_digits)


@functools.lru_cache(maxsize=None)
def _checksig_segments() -> tuple[bytes, ...]:
    """The N+1 static byte segments of checksig_verify around the N pubkey
    pushes (segment i+1 starts right after digit i's pubkey)."""
    segs = []
    sb = ScriptBuilder()
    for _digit in range(N):
        sb.num(DIGITS).emit(op.OP_MIN)
        sb.emit(op.OP_DUP, op.OP_TOALTSTACK, op.OP_TOALTSTACK)
        for _ in range(DIGITS):
            sb.emit(op.OP_DUP, op.OP_HASH160)
        sb.emit(op.OP_FROMALTSTACK, op.OP_PICK)
        segs.append(sb.build())  # pubkey push splices here
        sb = ScriptBuilder()
        sb.emit(op.OP_EQUALVERIFY)
        for _ in range((DIGITS + 1) // 2):
            sb.emit(op.OP_2DROP)
    # checksum of the message digits
    sb.emit(op.OP_FROMALTSTACK, op.OP_DUP, op.OP_NEGATE)
    for _ in range(1, N0):
        sb.emit(op.OP_FROMALTSTACK, op.OP_TUCK, op.OP_SUB)
    sb.num(DIGITS * N0).emit(op.OP_ADD)
    # sum the signed checksum digits
    sb.emit(op.OP_FROMALTSTACK)
    for _ in range(N1 - 1):
        for _ in range(LOG_D):
            sb.emit(op.OP_DUP, op.OP_ADD)
        sb.emit(op.OP_FROMALTSTACK, op.OP_ADD)
    sb.emit(op.OP_EQUALVERIFY)
    # pack digit pairs into bytes; leave [b3, b2, b1, b0(top)]
    for i in range(N0 // 2):
        sb.emit(op.OP_SWAP)
        for _ in range(LOG_D):
            sb.emit(op.OP_DUP, op.OP_ADD)
        sb.emit(op.OP_ADD)
        if i != N0 // 2 - 1:
            sb.emit(op.OP_TOALTSTACK)
    for _ in range(N0 // 2 - 1):
        sb.emit(op.OP_FROMALTSTACK)
    segs.append(sb.build())
    return tuple(segs)


class Winternitz:
    """Keypair for one u32 (N hash160 chains, one per digit)."""

    __slots__ = ("secret_key", "pub_key")

    def __init__(self, secret_key: bytes, pub_key: list[bytes] | None = None):
        self.secret_key = secret_key
        if pub_key is not None:
            self.pub_key = pub_key
            return
        from .. import native

        pk = native.winternitz_pubkeys_batch([secret_key], N, DIGITS)
        self.pub_key = [bytes(pk[0, i]) for i in range(N)]

    def _chain_start(self, digit_index: int) -> bytes:
        return hash160(self.secret_key + bytes([digit_index]))

    def digit_signature(self, digit_index: int, message_digit: int) -> bytes:
        h = self._chain_start(digit_index)
        for _ in range(message_digit):
            h = hash160(h)
        return h

    def sign(self, message_digits: list[int]) -> list[bytes]:
        """Witness items (bottom→top of initial stack). Digit i's chain signs
        checksum_digits[N-1-i] so a forger can only decrease the checksum while
        increasing digits (domination-free, winternitz.rs:139-153)."""
        all_digits = to_digits(checksum(message_digits), N1) + list(message_digits)
        out: list[bytes] = []
        for i in range(N):
            d = all_digits[N - 1 - i]
            out.append(self.digit_signature(i, d))
            # minimal script-number encoding: zero digit is the empty item
            out.append(bytes([d]) if d else b"")
        return out

    def sign_digit_plan(self, message_digits: list[int]) -> list[int]:
        """Chain-walk steps per digit index (the value digit i's chain signs:
        all_digits[N-1-i]) — the batched-native twin of sign()."""
        all_digits = to_digits(checksum(message_digits), N1) + list(message_digits)
        return all_digits[::-1]

    def checksig_verify(self) -> ScriptBuilder:
        """Verify N digit signatures (witness on stack), recompute+check the
        checksum, and leave the 4 message bytes on the stack (LSB on top).

        Only the N pubkey pushes vary between keypairs; the surrounding
        opcode stream is built once (_checksig_segments) and spliced —
        this runs per value-slot per query repetition in every commit."""
        segs = _checksig_segments()
        parts = [segs[0]]
        for i in range(N):
            pk = self.pub_key[N - 1 - i]
            parts.append(bytes([len(pk)]) + pk)
            parts.append(segs[i + 1])
        return ScriptBuilder(b"".join(parts))


def sign_many(wins: list["Winternitz"], messages: list[list[int]]) -> list[list[bytes]]:
    """Witness item lists for many keypairs — identical items to
    [w.sign(m) for w, m in zip(wins, messages)] but all hash160 chains run
    in ONE native 8-lane batch (the open path signs every committed u32 of
    every opened leaf; per-digit Python chains were the bottleneck)."""
    from .. import native

    if len(wins) * N < 16:
        return [w.sign(list(m)) for w, m in zip(wins, messages)]
    import numpy as np

    dv = np.empty((len(wins), N), np.uint8)
    for r, (w, m) in enumerate(zip(wins, messages)):
        dv[r] = w.sign_digit_plan(list(m))
    sigs = native.winternitz_sign_batch([w.secret_key for w in wins], dv)
    out: list[list[bytes]] = []
    for r in range(len(wins)):
        items: list[bytes] = []
        for i in range(N):
            d = int(dv[r, i])
            items.append(sigs[r, i].tobytes())
            items.append(bytes([d]) if d else b"")
        out.append(items)
    return out


def u32_compress() -> ScriptBuilder:
    """Combine the 4 bytes left by checksig_verify ([b3,b2,b1,b0(top)]) into
    one script number b0 + 256*b1 + 65536*b2 + 16777216*b3.

    Own convention (the reference's equivalent lives in the unavailable
    external crate rust-bitcoin-u31-or-u30 / bitcoin-verifier): committed
    values are indices or canonical BabyBear limbs, both < 2^31, so the
    result always fits a positive 4-byte script number."""
    sb = ScriptBuilder()
    sb.num(3).emit(op.OP_ROLL)  # b3 to top
    for k in range(3):
        for _ in range(8):
            sb.emit(op.OP_DUP, op.OP_ADD)  # acc *= 256
        if k < 2:
            sb.num(3 - k).emit(op.OP_ROLL, op.OP_ADD)  # + next byte (b2 then b1)
        else:
            sb.emit(op.OP_ADD)  # + b0
    return sb
