"""Tapscript interpreter — the simulator backend for every emitted script.

Fills the role bitcoin-scriptexec plays in the reference
(tap-stark's scripts/src/lib.rs:97-164): every verifier/commitment script
is actually executed in tests. Implements the Tapscript rules the framework's
scripts rely on: minimal data/number encodings, MINIMALIF, 4-byte numeric
operands, the 1000-element combined stack limit and 520-byte element limit.

The script is precompiled once into an instruction list (pushes decoded,
IF/ELSE/ENDIF jump targets resolved) and executed in a tight loop — emitted
verifier scripts run to tens of megabytes, so interpreter throughput matters
for the test suite.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass

from ..hashes.ripemd160 import hash160, ripemd160
from . import opcodes as op
from .builder import decode_num, encode_num

MAX_STACK = 1000
MAX_ELEMENT = 520


class ScriptError(Exception):
    pass


@dataclass
class ExecutionResult:
    success: bool
    final_stack: list[bytes]
    error: str | None = None
    op_count: int = 0
    max_stack: int = 0
    error_offset: int = -1  # byte offset of the failing opcode (-1 = n/a)


def _truthy(b: bytes) -> bool:
    for i, v in enumerate(b):
        if v != 0:
            return not (i == len(b) - 1 and v == 0x80)
    return False


_PUSH = 0x100  # pseudo-opcode for decoded pushes


@functools.lru_cache(maxsize=512)
def _compile(script: bytes):
    """Decode to [(opcode, arg)] with IF/ELSE/ENDIF jump targets resolved.

    For OP_IF/OP_NOTIF arg = (else_or_end_target, end_target); for OP_ELSE
    arg = end_target (instruction index just past the matching OP_ENDIF is
    NOT needed — targets point at the instruction AFTER the jump point)."""
    ins: list[tuple] = []
    offsets: list[int] = []  # byte offset of each instruction (for debug maps)
    pc = 0
    n = len(script)
    while pc < n:
        offsets.append(pc)
        opcode = script[pc]
        pc += 1
        if opcode <= op.OP_PUSHDATA4:
            if opcode == op.OP_0:
                ins.append((_PUSH, b""))
                continue
            if opcode <= 0x4B:
                ln = opcode
            elif opcode == op.OP_PUSHDATA1:
                ln = script[pc]
                pc += 1
            elif opcode == op.OP_PUSHDATA2:
                ln = int.from_bytes(script[pc : pc + 2], "little")
                pc += 2
            else:
                ln = int.from_bytes(script[pc : pc + 4], "little")
                pc += 4
            if pc + ln > n:
                raise ScriptError("push past end of script")
            data = script[pc : pc + ln]
            # MINIMALDATA / CheckMinimalPush (interpreter.cpp): every push
            # must use the smallest possible form
            if ln == 0:
                raise ScriptError("non-minimal push: empty via pushdata")
            if ln == 1 and 1 <= data[0] <= 16:
                raise ScriptError("non-minimal push: use OP_1..OP_16")
            if ln == 1 and data[0] == 0x81:
                raise ScriptError("non-minimal push: use OP_1NEGATE")
            if opcode == op.OP_PUSHDATA1 and ln <= 0x4B:
                raise ScriptError("non-minimal push: direct length fits")
            if opcode == op.OP_PUSHDATA2 and ln <= 0xFF:
                raise ScriptError("non-minimal push: PUSHDATA1 fits")
            if opcode == op.OP_PUSHDATA4 and ln <= 0xFFFF:
                raise ScriptError("non-minimal push: PUSHDATA2 fits")
            ins.append((_PUSH, data))
            pc += ln
        else:
            ins.append([opcode, None])
    # resolve branch targets
    stack = []
    for i, item in enumerate(ins):
        code = item[0]
        if code in (op.OP_IF, op.OP_NOTIF):
            stack.append(i)
        elif code == op.OP_ELSE:
            if not stack:
                raise ScriptError("OP_ELSE without OP_IF")
            j = stack[-1]
            if ins[j][0] in (op.OP_IF, op.OP_NOTIF):
                ins[j][1] = i + 1  # false branch starts after ELSE
                stack[-1] = i  # now waiting for ENDIF to fix ELSE target
            else:
                raise ScriptError("duplicate OP_ELSE")
        elif code == op.OP_ENDIF:
            if not stack:
                raise ScriptError("OP_ENDIF without OP_IF")
            j = stack.pop()
            if ins[j][0] == op.OP_ELSE:
                ins[j][1] = i + 1  # taken-branch jumps past ENDIF
            else:
                ins[j][1] = i + 1  # no ELSE: false branch goes past ENDIF
    if stack:
        raise ScriptError("unbalanced conditional")
    return [tuple(x) if isinstance(x, list) else x for x in ins], offsets


def execute_script(
    script: bytes,
    witness: list[bytes] | None = None,
    stack_limit: int = MAX_STACK,
) -> ExecutionResult:
    """Run a script with an optional witness (initial stack; last item on top).

    success == ran to completion AND the final stack is exactly one truthy
    element (Tapscript spend semantics, matching scriptexec's notion used by
    the reference tests).

    stack_limit defaults to the 1000-element consensus limit; callers
    committing wide traces (whose leaf witnesses structurally exceed Bitcoin's
    limit — also true of the reference's wide-table "estimate" rows) may
    relax it for simulation."""
    st: list[bytes] = list(witness or [])
    alt: list[bytes] = []
    max_stack = len(st)
    op_count = 0
    if max_stack > stack_limit:
        return ExecutionResult(False, st, "stack size limit exceeded", 0, max_stack)
    for w in st:
        # BIP342: MAX_SCRIPT_ELEMENT_SIZE applies to initial witness
        # elements exactly as to pushed ones
        if len(w) > MAX_ELEMENT:
            return ExecutionResult(
                False, st, "witness element too large", 0, max_stack
            )

    try:
        ins, offsets = _compile(bytes(script))
    except ScriptError as e:
        return ExecutionResult(False, st, str(e), 0, max_stack)

    sha = hashlib.sha256
    dec = decode_num
    enc = encode_num
    n_ins = len(ins)
    pc = 0
    err = None

    try:
        while pc < n_ins:
            code, arg = ins[pc]
            pc += 1
            if code == _PUSH:
                if len(arg) > MAX_ELEMENT:
                    raise ScriptError("element too large")
                st.append(arg)
            elif code == op.OP_EQUALVERIFY:
                a = st.pop()
                b = st.pop()
                if a != b:
                    raise ScriptError(
                        f"OP_EQUALVERIFY failed: {a.hex()} != {b.hex()}"
                    )
            elif code == op.OP_DUP:
                st.append(st[-1])
            elif code == op.OP_ADD:
                b = dec(st.pop())
                a = dec(st.pop())
                st.append(enc(a + b))
            elif code == op.OP_SUB:
                b = dec(st.pop())
                a = dec(st.pop())
                st.append(enc(a - b))
            elif code == op.OP_TOALTSTACK:
                alt.append(st.pop())
            elif code == op.OP_FROMALTSTACK:
                if not alt:
                    raise ScriptError("altstack underflow")
                st.append(alt.pop())
            elif code == op.OP_PICK or code == op.OP_ROLL:
                k = dec(st.pop())
                if k < 0 or k >= len(st):
                    raise ScriptError("pick/roll out of range")
                if code == op.OP_ROLL:
                    st.append(st.pop(-k - 1))
                else:
                    st.append(st[-k - 1])
            elif code == op.OP_HASH160:
                st.append(hash160(st.pop()))
            elif code == op.OP_SWAP:
                st[-1], st[-2] = st[-2], st[-1]
            elif code == op.OP_IF or code == op.OP_NOTIF:
                top = st.pop()
                if top not in (b"", b"\x01"):
                    raise ScriptError("MINIMALIF violation")
                val = top == b"\x01"
                if code == op.OP_NOTIF:
                    val = not val
                if not val:
                    pc = arg  # jump to else-branch / past endif
            elif code == op.OP_ELSE:
                pc = arg  # end of taken branch: jump past endif
            elif code == op.OP_ENDIF:
                pass
            elif code == op.OP_2DROP:
                st.pop()
                st.pop()
            elif code == op.OP_DROP:
                st.pop()
            elif code == op.OP_GREATERTHANOREQUAL:
                b = dec(st.pop())
                a = dec(st.pop())
                st.append(b"\x01" if a >= b else b"")
            elif code == op.OP_MIN:
                b = dec(st.pop())
                a = dec(st.pop())
                st.append(enc(min(a, b)))
            elif code == op.OP_2DUP:
                st += st[-2:]
            elif code == op.OP_ROT:
                st.append(st.pop(-3))
            elif code == op.OP_OVER:
                st.append(st[-2])
            elif code == op.OP_TUCK:
                st.insert(-2, st[-1])
            elif code == op.OP_NIP:
                del st[-2]
            elif code == op.OP_EQUAL:
                a = st.pop()
                b = st.pop()
                st.append(b"\x01" if a == b else b"")
            elif code == op.OP_VERIFY:
                if not _truthy(st.pop()):
                    raise ScriptError("OP_VERIFY failed")
            elif code == op.OP_1NEGATE:
                st.append(enc(-1))
            elif op.OP_1 <= code <= op.OP_16:
                st.append(enc(code - op.OP_1 + 1))
            elif code == op.OP_NOP:
                pass
            elif code == op.OP_RETURN:
                raise ScriptError("OP_RETURN")
            elif code == op.OP_3DUP:
                st += st[-3:]
            elif code == op.OP_2OVER:
                st += st[-4:-2]
            elif code == op.OP_2ROT:
                st.append(st.pop(-6))
                st.append(st.pop(-6))
            elif code == op.OP_2SWAP:
                st[-4], st[-3], st[-2], st[-1] = st[-2], st[-1], st[-4], st[-3]
            elif code == op.OP_IFDUP:
                if _truthy(st[-1]):
                    st.append(st[-1])
            elif code == op.OP_DEPTH:
                st.append(enc(len(st)))
            elif code == op.OP_SIZE:
                st.append(enc(len(st[-1])))
            elif code == op.OP_1ADD:
                st.append(enc(dec(st.pop()) + 1))
            elif code == op.OP_1SUB:
                st.append(enc(dec(st.pop()) - 1))
            elif code == op.OP_NEGATE:
                st.append(enc(-dec(st.pop())))
            elif code == op.OP_ABS:
                st.append(enc(abs(dec(st.pop()))))
            elif code == op.OP_NOT:
                st.append(enc(int(dec(st.pop()) == 0)))
            elif code == op.OP_0NOTEQUAL:
                st.append(enc(int(dec(st.pop()) != 0)))
            elif code == op.OP_BOOLAND:
                b = dec(st.pop())
                a = dec(st.pop())
                st.append(enc(int(a != 0 and b != 0)))
            elif code == op.OP_BOOLOR:
                b = dec(st.pop())
                a = dec(st.pop())
                st.append(enc(int(a != 0 or b != 0)))
            elif code == op.OP_NUMEQUAL:
                b = dec(st.pop())
                a = dec(st.pop())
                st.append(enc(int(a == b)))
            elif code == op.OP_NUMEQUALVERIFY:
                b = dec(st.pop())
                a = dec(st.pop())
                if a != b:
                    raise ScriptError("OP_NUMEQUALVERIFY failed")
            elif code == op.OP_NUMNOTEQUAL:
                b = dec(st.pop())
                a = dec(st.pop())
                st.append(enc(int(a != b)))
            elif code == op.OP_LESSTHAN:
                b = dec(st.pop())
                a = dec(st.pop())
                st.append(b"\x01" if a < b else b"")
            elif code == op.OP_GREATERTHAN:
                b = dec(st.pop())
                a = dec(st.pop())
                st.append(b"\x01" if a > b else b"")
            elif code == op.OP_LESSTHANOREQUAL:
                b = dec(st.pop())
                a = dec(st.pop())
                st.append(b"\x01" if a <= b else b"")
            elif code == op.OP_MAX:
                b = dec(st.pop())
                a = dec(st.pop())
                st.append(enc(max(a, b)))
            elif code == op.OP_WITHIN:
                mx = dec(st.pop())
                mn = dec(st.pop())
                x = dec(st.pop())
                st.append(b"\x01" if mn <= x < mx else b"")
            elif code == op.OP_RIPEMD160:
                st.append(ripemd160(st.pop()))
            elif code == op.OP_SHA256:
                st.append(sha(st.pop()).digest())
            elif code == op.OP_HASH256:
                st.append(sha(sha(st.pop()).digest()).digest())
            else:
                raise ScriptError(f"unimplemented opcode 0x{code:02x}")
            op_count += 1
            depth = len(st) + len(alt)
            if depth > stack_limit:
                raise ScriptError("stack size limit exceeded")
            if depth > max_stack:
                max_stack = depth
    except ScriptError as e:
        return ExecutionResult(
            False, st, str(e), op_count, max_stack, offsets[pc - 1]
        )
    except IndexError:
        return ExecutionResult(
            False, st, "stack underflow", op_count, max_stack, offsets[pc - 1]
        )
    except ValueError as e:
        return ExecutionResult(
            False, st, str(e), op_count, max_stack, offsets[pc - 1]
        )

    ok = len(st) == 1 and _truthy(st[0])
    err = None if ok else "final stack not a single truthy element"
    return ExecutionResult(ok, st, err, op_count, max_stack)
