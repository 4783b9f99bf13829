"""Challenger-consistency script: replays the Fiat-Shamir transcript
on-chain.

Reference parity: script_expr/src/challenger_expr.rs (BfChallengerExpr) — the
byte-level DSL twin of BfChallenger. This builder consumes the op_log of a
natively-run challenger and emits ONE script that:

  - recomputes every duplex compression with the in-script blake3 gadget,
    carrying the 8-word chaining value forward on the stack so successive
    compressions are genuinely chained (challenger v2: 16-word absorb rate,
    see tapstark_torch/challenger);
  - converts sampled output words to field limbs mod p in-script and
    OP_EQUALVERIFYs them against the claimed challenge values
    (alpha, zeta, FRI betas, ...);
  - checks sample_bits extractions (query indices, PoW) via high-bit
    extraction on ONE raw squeezed word.

Observed words (commitment roots, the PoW witness) enter as script constants
— on-chain these become the bit-committed values of the BitVM2 flow.
"""

from __future__ import annotations

from ..challenger import FLAGS, RATE
from ..field.scalar import EF4, F
from ..hashes.blake3 import IV, compress
from ..script import opcodes as op
from ..script.builder import ScriptBuilder
from .blake3_gadget import blake3_compress_chained_gadget
from .u32 import (
    drop_xor_table,
    push_xor_table,
    u32_extract_high_bits,
    u32_pick,
    u32_push,
    u32_to_u31_f,
)


class ChallengerScriptBuilder:
    def __init__(self):
        self.sb = ScriptBuilder()
        self.num_compressions = 0
        self.pending: list[int] = []
        self.have_cv = False  # cv quads live on the stack?
        self.buffer_len = 0  # unread output words (buffer = h_0..h_{len-1})
        self.cv: list[int] = list(IV)  # host mirror of the chaining value
        self.buffer_words: list[int] = []

    # -- script plumbing ---------------------------------------------------
    def _compress(self) -> None:
        sb = self.sb
        block = [self.pending[i] if i < len(self.pending) else 0 for i in range(RATE)]
        block_len = 4 * len(self.pending)
        if not self.have_cv:
            for w in IV:
                sb.extend(u32_push(w))
        for w in block:
            sb.extend(u32_push(w))
        sb.extend(blake3_compress_chained_gadget(block_len))
        self.num_compressions += 1
        # host mirror
        self.cv = compress(self.cv, block, 0, block_len, FLAGS)[:8]
        self.buffer_words = list(self.cv)
        self.buffer_len = 8
        self.have_cv = True
        self.pending = []

    # -- transcript ops ----------------------------------------------------
    def observe(self, word: int) -> None:
        self.buffer_len = 0
        self.pending.append(word)
        if len(self.pending) == RATE:
            self._compress()

    def _pop_setup(self) -> int:
        """Squeeze if needed; returns j such that the popped word is h_j
        (quad depth 7-j on the stack)."""
        if self.pending or self.buffer_len == 0:
            self._compress()
        j = self.buffer_len - 1
        self.buffer_len -= 1
        return j

    def sample(self, kind: str, words: list[int], value) -> None:
        limbs = value.as_u32_vec() if isinstance(value, (F, EF4)) else [value]
        n = 1 if kind == "base" else 4
        assert len(limbs) == n
        for l in range(n):
            j = self._pop_setup()
            assert self.buffer_words[j] == words[l], "op_log/sponge divergence"
            self.sb.extend(u32_pick(7 - j))
            self.sb.extend(u32_to_u31_f())
            self.sb.num(limbs[l]).emit(op.OP_EQUALVERIFY)

    def sample_bits(self, bits: int, word: int, result: int) -> None:
        """Pop one raw word; verify its top `bits` bits equal `result`."""
        j = self._pop_setup()
        assert self.buffer_words[j] == word, "op_log/sponge divergence"
        self.sb.extend(u32_pick(7 - j))
        self.sb.extend(u32_extract_high_bits(bits))
        self.sb.num(result).emit(op.OP_EQUALVERIFY)

    # -- assembly ----------------------------------------------------------
    def finish(self) -> bytes:
        sb = ScriptBuilder()
        sb.extend(push_xor_table())
        sb.extend(self.sb)
        if self.have_cv:
            for _ in range(16):
                sb.emit(op.OP_2DROP)
        sb.extend(drop_xor_table())
        sb.emit(op.OP_1)
        return sb.build()


def build_challenger_script(op_log: list[tuple], stats: dict | None = None) -> bytes:
    """Compile a challenger op_log into the consistency script. If `stats`
    is a dict, records {"compressions": N} (script size scales with it)."""
    b = ChallengerScriptBuilder()
    for entry in op_log:
        if entry[0] == "observe":
            b.observe(entry[1])
        elif entry[0] == "sample":
            b.sample(entry[1], entry[2], entry[3])
        elif entry[0] == "sample_bits":
            b.sample_bits(entry[1], entry[2], entry[3])
        else:
            raise AssertionError(entry[0])
    out = b.finish()
    if stats is not None:
        stats["compressions"] = b.num_compressions
    return out
