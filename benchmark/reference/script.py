"""The committed leaves, worked out again: Winternitz keys from the bit
commitments' secrets, their lock scripts, each taptree leaf's script and
its SHA-256 suffix.

The protocol this follows (the proof format of the port, tapstark's
commitment scheme, in Bitcoin Script):
- a bit commitment to a u32 is a Winternitz key of 10 base-16 digits (8
  of the message, 2 of its checksum); digit d's public key is hash160
  applied 16 times to secret || d; the secret of assignment k, limb j of a
  manager is sha256("tapstark/bc-secret/v1" || seed || le64(k) ||
  le64(j))[:20], and each manager counts its assignments from 0;
- a commit of a matrix of v values a leaf (1 limb each for the base
  field, 4 for the extension) assigns per query repetition and per column
  shard of at most 40 values: one u32 commitment for the leaf index, then
  one per value, counter by counter;
- a leaf's script is a constant head (every lock of the shard, the index
  lock first, NOP-padded so the per-leaf SHA-256 suffix spans the fewest
  blocks), then a tail that pushes each limb (last value first) and the
  index, each followed by OP_FROMALTSTACK OP_EQUALVERIFY, then OP_1, then
  NOPs to a length shared by the shard;
- a leaf's hash is the BIP-341 TapLeaf tagged hash of 0xc0 ||
  compact_size(len) || script, a node's the TapBranch tagged hash of its
  two children in byte order.
"""

from __future__ import annotations

import hashlib

import torch

from . import hashes as H

OP_0, OP_1, OP_1NEGATE, OP_PUSHDATA1, OP_NOP = 0x00, 0x51, 0x4F, 0x4C, 0x61
OP_TOALTSTACK, OP_FROMALTSTACK, OP_2DROP, OP_DUP = 0x6B, 0x6C, 0x6D, 0x76
OP_PICK, OP_ROLL, OP_SWAP, OP_TUCK = 0x79, 0x7A, 0x7C, 0x7D
OP_EQUALVERIFY, OP_NEGATE, OP_ADD, OP_SUB, OP_MIN, OP_HASH160 = 0x88, 0x8F, 0x93, 0x94, 0xA3, 0xA9

DIGITS = 15
N_MSG, N_CHECK = 8, 2
N_DIGITS = N_MSG + N_CHECK
MAX_LEAF_VALUES = 40
SECRET_DOMAIN = b"tapstark/bc-secret/v1"
LEAF_VERSION = 0xC0


def encode_num(n: int) -> bytes:
    if n == 0:
        return b""
    mag, out = abs(n), bytearray()
    while mag:
        out.append(mag & 0xFF)
        mag >>= 8
    if out[-1] & 0x80:
        out.append(0x80 if n < 0 else 0)
    elif n < 0:
        out[-1] |= 0x80
    return bytes(out)


def push_int(n: int) -> bytes:
    if n == 0:
        return bytes([OP_0])
    if 1 <= n <= 16:
        return bytes([OP_1 + n - 1])
    if n == -1:
        return bytes([OP_1NEGATE])
    data = encode_num(n)
    return bytes([len(data)]) + data  # every number here is under 2^31: < 0x4C bytes


def compact_size(n: int) -> bytes:
    if n < 0xFD:
        return bytes([n])
    if n <= 0xFFFF:
        return b"\xfd" + n.to_bytes(2, "little")
    return b"\xfe" + n.to_bytes(4, "little")


def _checksig_segments() -> list[bytes]:
    segs, cur = [], bytearray()
    for _ in range(N_DIGITS):
        cur += push_int(DIGITS) + bytes([OP_MIN, OP_DUP, OP_TOALTSTACK, OP_TOALTSTACK])
        cur += bytes([OP_DUP, OP_HASH160]) * DIGITS + bytes([OP_FROMALTSTACK, OP_PICK])
        segs.append(bytes(cur))
        cur = bytearray([OP_EQUALVERIFY]) + bytes([OP_2DROP]) * ((DIGITS + 1) // 2)
    cur += bytes([OP_FROMALTSTACK, OP_DUP, OP_NEGATE]) + bytes([OP_FROMALTSTACK, OP_TUCK, OP_SUB]) * (N_MSG - 1)
    cur += push_int(DIGITS * N_MSG) + bytes([OP_ADD, OP_FROMALTSTACK])
    cur += (bytes([OP_DUP, OP_ADD]) * 4 + bytes([OP_FROMALTSTACK, OP_ADD])) * (N_CHECK - 1)
    cur += bytes([OP_EQUALVERIFY])
    for i in range(N_MSG // 2):
        cur += bytes([OP_SWAP]) + bytes([OP_DUP, OP_ADD]) * 4 + bytes([OP_ADD])
        if i != N_MSG // 2 - 1:
            cur += bytes([OP_TOALTSTACK])
    cur += bytes([OP_FROMALTSTACK]) * (N_MSG // 2 - 1)
    segs.append(bytes(cur))
    return segs


_SEGS = _checksig_segments()


def _u32_compress() -> bytes:
    out = push_int(3) + bytes([OP_ROLL])
    for k in range(3):
        out += bytes([OP_DUP, OP_ADD]) * 8
        out += push_int(3 - k) + bytes([OP_ROLL, OP_ADD]) if k < 2 else bytes([OP_ADD])
    return out


_U32_COMPRESS = _u32_compress()


def u32_lock(pubkeys: list[bytes]) -> bytes:
    """checksig of one u32's 10 digit keys, then the bytes joined into one
    number."""
    parts = [_SEGS[0]]
    for i in range(N_DIGITS):
        pk = pubkeys[N_DIGITS - 1 - i]
        parts += [bytes([len(pk)]) + pk, _SEGS[i + 1]]
    return b"".join(parts) + _U32_COMPRESS


def parked_lock(limb_pubkeys: list[list[bytes]]) -> bytes:
    """A commitment to 1 or 4 limbs, last limb first, each left on the
    altstack."""
    return b"".join(u32_lock(pk) + bytes([OP_TOALTSTACK]) for pk in reversed(limb_pubkeys))


def tail_span(num_values: int, num_limbs: int) -> int:
    return (num_values * num_limbs + 1) * 7 + 1


def head_pad(head_len: int, span: int) -> int:
    """NOPs after the head so that the per-leaf suffix spans the fewest
    SHA-256 blocks (the first such count)."""
    best_d, best_b = 0, None
    for d in range(64):
        hl = head_len + d
        rem = (1 + len(compact_size(hl + span)) + hl) % 64
        b = -(-(rem + span + 9) // 64)
        if best_b is None or b < best_b:
            best_b, best_d = b, d
    return best_d


def leaf_tail(index: int, row) -> bytes:
    """row: per value, its limbs."""
    out = bytearray()
    for limbs in reversed(row):
        for v in limbs:
            out += push_int(int(v)) + bytes([OP_FROMALTSTACK, OP_EQUALVERIFY])
    out += push_int(index) + bytes([OP_FROMALTSTACK, OP_EQUALVERIFY, OP_1])
    return bytes(out)


def head_length(num_values: int, num_limbs: int) -> int:
    """The head's length before its NOP pad: every lock has the same size."""
    one = len(u32_lock([bytes(20)] * N_DIGITS)) + 1
    return one * (1 + num_values * num_limbs)


def suffix_blocks(num_values: int, num_limbs: int) -> int:
    """SHA-256 blocks a leaf hashes after its shard's constant prefix."""
    hl = head_length(num_values, num_limbs)
    span = tail_span(num_values, num_limbs)
    hl += head_pad(hl, span)
    rem = (1 + len(compact_size(hl + span)) + hl) % 64
    return -(-(rem + span + 9) // 64)


def shard_bounds(num_values: int) -> list[tuple[int, int]]:
    if num_values <= MAX_LEAF_VALUES:
        return [(0, num_values)]
    k = -(-num_values // MAX_LEAF_VALUES)
    base, rem = divmod(num_values, k)
    out, lo = [], 0
    for s in range(k):
        hi = lo + base + (1 if s < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def secret(seed: bytes, k: int, j: int) -> bytes:
    return hashlib.sha256(SECRET_DOMAIN + seed + k.to_bytes(8, "little") + j.to_bytes(8, "little")).digest()[:20]


def pubkeys(secrets: list[bytes], device) -> list[list[bytes]]:
    """Every secret's 10 digit keys, all chains at once."""
    if not secrets:
        return []
    msg = torch.tensor(
        [list(s) + [d] for s in secrets for d in range(N_DIGITS)], dtype=torch.int64, device=device
    )
    h = H.hash160_lanes(msg)
    for _ in range(DIGITS):
        h = H.hash160_lanes(h)
    flat = bytes(h.to(torch.uint8).cpu().numpy().tobytes())
    return [
        [flat[20 * (N_DIGITS * i + d) : 20 * (N_DIGITS * i + d + 1)] for d in range(N_DIGITS)]
        for i in range(len(secrets))
    ]


class Shard:
    """One (repetition, shard) of a commit: its bit commitments and the
    constant head of its leaves."""

    def __init__(self, index_secret: bytes, value_secrets: list[list[bytes]], keys: dict, num_limbs: int):
        self.index_secret = index_secret
        self.value_secrets = value_secrets  # per value, its limbs' secrets
        self.num_values = len(value_secrets)
        self.num_limbs = num_limbs
        head = parked_lock([keys[index_secret]])
        for limbs in value_secrets:
            head += parked_lock([keys[s] for s in limbs])
        span = tail_span(self.num_values, num_limbs)
        self.head = head + bytes([OP_NOP]) * head_pad(len(head), span)
        self.fixed_len = len(self.head) + span

    def script(self, index: int, row) -> bytes:
        tail = leaf_tail(index, row)
        return self.head + tail + bytes([OP_NOP]) * (self.fixed_len - len(self.head) - len(tail))

    def leaf_message_prefix(self) -> bytes:
        """The tagged TapLeaf message's bytes before the tail."""
        return bytes([LEAF_VERSION]) + compact_size(self.fixed_len) + self.head


def tag_midstate(tag: bytes) -> list[int]:
    t = hashlib.sha256(tag).digest()
    return H.sha256_midstate(t + t)


def tapleaf_hash(script: bytes) -> bytes:
    t = hashlib.sha256(b"TapLeaf").digest()
    return hashlib.sha256(t + t + bytes([LEAF_VERSION]) + compact_size(len(script)) + script).digest()


def tapbranch_hash(a: bytes, b: bytes) -> bytes:
    t = hashlib.sha256(b"TapBranch").digest()
    lo, hi = (a, b) if a <= b else (b, a)
    return hashlib.sha256(t + t + lo + hi).digest()


def _push_bytes_lanes(v: torch.Tensor):
    """Minimal pushes of values in [0, 2^31) as (N, 5) bytes and lengths."""
    n = v.shape[0]
    out = torch.zeros((n, 5), dtype=torch.int64, device=v.device)
    # the fewest bytes that leave the top byte's sign bit clear
    nbytes = 1 + sum((v >= 1 << (8 * k - 1)).long() for k in (1, 2, 3))
    out[:, 0] = nbytes
    for k in range(4):
        out[:, 1 + k] = (v >> (8 * k)) & 0xFF
    length = nbytes + 1
    small = v <= 16
    out[:, 0] = torch.where(v == 0, OP_0, torch.where(small, OP_1 + v - 1, out[:, 0]))
    length = torch.where(small, torch.ones_like(length), length)
    return out, length


def leaf_suffix_words(shard: Shard, values: torch.Tensor, indices: torch.Tensor) -> tuple[list[int], torch.Tensor]:
    """For leaves of this shard (values (N, v, limbs) canonical, indices
    (N,)): the SHA-256 state after the message's whole blocks before the
    first one a leaf changes, and each leaf's remaining padded blocks as
    (N, 16 * blocks) big-endian words."""
    t = hashlib.sha256(b"TapLeaf").digest()
    prefix = t + t + shard.leaf_message_prefix()
    cut = len(prefix) - len(prefix) % 64
    state = H.sha256_midstate(prefix[:cut])
    rem = prefix[cut:]
    total = len(prefix) + (shard.fixed_len - len(shard.head))
    n = values.shape[0]
    dev = values.device
    items = torch.cat([values.flip(1).reshape(n, -1), indices[:, None]], dim=1)  # push order
    k = items.shape[1]
    enc, lens = _push_bytes_lanes(items.reshape(-1))
    enc, lens = enc.view(n, k, 5), lens.view(n, k)
    span = tail_span(shard.num_values, shard.num_limbs)
    tail = torch.full((n, span + 1), OP_NOP, dtype=torch.int64, device=dev)  # one spare column
    starts = torch.cumsum(lens + 2, dim=1) - (lens + 2)
    rows = torch.arange(n, device=dev)[:, None]
    for b in range(5):
        pos = torch.where(b < lens, starts + b, torch.full_like(starts, span))
        tail[rows, pos] = torch.where(b < lens, enc[:, :, b], tail[rows, pos])
    end = starts + lens
    tail[rows, end] = OP_FROMALTSTACK
    tail[rows, end + 1] = OP_EQUALVERIFY
    tail[torch.arange(n, device=dev), (end[:, -1] + 2)] = OP_1
    tail = tail[:, :span]
    pad = H.sha256_pad(total, b"")
    head_bytes = torch.tensor(list(rem), dtype=torch.int64, device=dev).expand(n, len(rem))
    pad_bytes = torch.tensor(list(pad), dtype=torch.int64, device=dev).expand(n, len(pad))
    msg = torch.cat([head_bytes, tail, pad_bytes], dim=1)
    if msg.shape[1] % 64:
        raise AssertionError("leaf suffix is not whole blocks")
    return state, H.be_words(msg.contiguous())
