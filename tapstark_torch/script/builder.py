"""Bitcoin Script serialization: minimal pushes + opcode assembly.

Number pushes follow the `bitcoin-script` macro / CScriptNum conventions the
reference relies on (scripts embed field values and indices as minimally
encoded script numbers; script BYTES feed the tapleaf hashes, so encoding is
consensus-relevant for root stability).
"""

from __future__ import annotations

from . import opcodes as op


def encode_num(n: int) -> bytes:
    """Minimal CScriptNum encoding (little-endian sign-magnitude)."""
    if n == 0:
        return b""
    neg = n < 0
    mag = -n if neg else n
    out = bytearray()
    while mag:
        out.append(mag & 0xFF)
        mag >>= 8
    if out[-1] & 0x80:
        out.append(0x80 if neg else 0x00)
    elif neg:
        out[-1] |= 0x80
    return bytes(out)


def decode_num(b: bytes, require_minimal: bool = True, max_size: int = 4) -> int:
    if len(b) > max_size:
        raise ValueError(f"script number overflow ({len(b)} bytes)")
    if not b:
        return 0
    if require_minimal:
        if b[-1] & 0x7F == 0 and (len(b) == 1 or not (b[-2] & 0x80)):
            raise ValueError(f"non-minimal script number: {b.hex()}")
    neg = bool(b[-1] & 0x80)
    mag = int.from_bytes(b[:-1] + bytes([b[-1] & 0x7F]), "little")
    return -mag if neg else mag


def push_bytes(data: bytes) -> bytes:
    n = len(data)
    if n == 0:
        return bytes([op.OP_0])
    if n <= 0x4B:
        return bytes([n]) + data
    if n <= 0xFF:
        return bytes([op.OP_PUSHDATA1, n]) + data
    if n <= 0xFFFF:
        return bytes([op.OP_PUSHDATA2]) + n.to_bytes(2, "little") + data
    return bytes([op.OP_PUSHDATA4]) + n.to_bytes(4, "little") + data


def push_int(n: int) -> bytes:
    if n == 0:
        return bytes([op.OP_0])
    if 1 <= n <= 16:
        return bytes([op.OP_1 + n - 1])
    if n == -1:
        return bytes([op.OP_1NEGATE])
    return push_bytes(encode_num(n))


class ScriptBuilder:
    """Accumulates serialized script bytes."""

    __slots__ = ("parts", "_len")

    def __init__(self, initial: bytes = b""):
        self.parts: list[bytes] = [initial] if initial else []
        self._len = len(initial)

    def emit(self, *ops: int) -> "ScriptBuilder":
        self.parts.append(bytes(ops))
        self._len += len(ops)
        return self

    def num(self, n: int) -> "ScriptBuilder":
        b = push_int(n)
        self.parts.append(b)
        self._len += len(b)
        return self

    def data(self, b: bytes) -> "ScriptBuilder":
        b = push_bytes(b)
        self.parts.append(b)
        self._len += len(b)
        return self

    def raw(self, b: bytes) -> "ScriptBuilder":
        self.parts.append(b)
        self._len += len(b)
        return self

    def extend(self, other: "ScriptBuilder") -> "ScriptBuilder":
        self.parts.extend(other.parts)
        self._len += other._len
        return self

    def build(self) -> bytes:
        return b"".join(self.parts)

    def __len__(self) -> int:
        return self._len
