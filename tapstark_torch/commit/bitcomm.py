"""Bit commitments: u32 values committed via Winternitz OTS.

Behavioral port of the reference BitCommitmentU32 / BitCommitment
(tap-stark's scripts/src/bit_comm/bit_comm_u32.rs, bit_comm.rs) plus the
assignment manager role played by the external bitcoin-verifier crate's
BcManagerIns (reference basic/src/tcs/mod.rs:31-46).

Secret policy (own deterministic design — the reference's SecretGenIns lives
in an unavailable external crate, see SURVEY.md §7 "hard parts"): secret for
assignment counter k, limb j = sha256("tapstark/bc-secret/v1" || le64(k) ||
le64(j))[:20]. Deterministic and unique per (assignment, limb), giving
reproducible roots with one-time-signature hygiene per query repetition
(fresh assignments per cloned tree).
"""

from __future__ import annotations

import hashlib
import threading

from ..script import opcodes as op
from ..script.builder import ScriptBuilder
from .winternitz import N0, Winternitz, to_digits, u32_compress

COMMIT_TYPE_U32 = "u32"  # one u32 limb (base-field value / index)
COMMIT_TYPE_U128 = "u128"  # four u32 limbs (quartic-extension value)


class BitCommitmentU32:
    """Commitment to one u32 via a Winternitz keypair."""

    __slots__ = ("winternitz", "value")

    def __init__(self, secret_key: bytes, value: int = 0, pub_key=None):
        self.winternitz = Winternitz(secret_key, pub_key)
        self.value = value

    def set_value(self, value: int) -> None:
        assert 0 <= value < 1 << 32
        self.value = value

    def locking_script(self) -> ScriptBuilder:
        """checksig + compress: leaves the committed u32 on the stack."""
        sb = self.winternitz.checksig_verify()
        sb.extend(u32_compress())
        return sb

    def signature(self) -> list[bytes]:
        return self.winternitz.sign(to_digits(self.value, N0))


class BitCommitment:
    """Commitment to a vector of u32 limbs (1 = base field, 4 = extension).

    Conventions (self-consistent; the reference's exact stack order is set by
    the unavailable external crate):
      - locking_script recovers limb n-1 first, parking limbs on the
        altstack, then unloads them so limb n-1 ends on TOP. The leaf script
        then pushes claimed values high-limb-first with OP_EQUALVERIFY —
        the same visible order as the reference leaf
        (basic/src/tcs/mod.rs:197-226).
      - witness() therefore concatenates limb signatures low-limb-first, so
        the first checksig to run (limb n-1) finds its signature on top.
    """

    __slots__ = ("commitments",)

    def __init__(self, commitments: list[BitCommitmentU32]):
        self.commitments = commitments

    @property
    def num_limbs(self) -> int:
        return len(self.commitments)

    def set_values(self, limbs: list[int]) -> None:
        assert len(limbs) == len(self.commitments)
        for c, v in zip(self.commitments, limbs):
            c.set_value(v)

    def locking_script(self) -> ScriptBuilder:
        sb = ScriptBuilder()
        for c in reversed(self.commitments):
            sb.extend(c.locking_script())
            sb.emit(op.OP_TOALTSTACK)
        for _ in self.commitments:
            sb.emit(op.OP_FROMALTSTACK)
        return sb

    def locking_script_parked(self) -> ScriptBuilder:
        """Like locking_script, but leaves every recovered limb PARKED on the
        altstack (limb n-1 deepest, limb 0 on top). Used by the constant-head
        leaf layout: all locks run first, then a short variable tail pops and
        EQUALVERIFYs each limb — so the per-leaf script bytes after the
        shared constant head are tiny and tapleaf hashing can resume from a
        precomputed SHA-256 midstate."""
        sb = ScriptBuilder()
        for c in reversed(self.commitments):
            sb.extend(c.locking_script())
            sb.emit(op.OP_TOALTSTACK)
        return sb

    def witness(self) -> list[bytes]:
        out: list[bytes] = []
        for c in self.commitments:
            out.extend(c.signature())
        return out


class BcManager:
    """Thread-safe deterministic assignment of fresh bit commitments
    (the SyncBcManager role, reference basic/src/tcs/mod.rs:38-69)."""

    _DOMAIN = b"tapstark/bc-secret/v1"

    def __init__(self, seed: bytes = b""):
        self._seed = seed
        self._counter = 0
        self._lock = threading.Lock()

    def _secret(self, k: int, j: int) -> bytes:
        return hashlib.sha256(
            self._DOMAIN + self._seed + k.to_bytes(8, "little") + j.to_bytes(8, "little")
        ).digest()[:20]

    def assign_bc(self, commit_type: str) -> BitCommitment:
        return self.assign_bcs(commit_type, 1)[0]

    def assign_bcs(self, commit_type: str, count: int) -> list[BitCommitment]:
        """Bulk assignment: one native keygen call for all count*limbs
        Winternitz keypairs (identical secrets/order to repeated assign_bc)."""
        limbs = 1 if commit_type == COMMIT_TYPE_U32 else 4
        with self._lock:
            k0 = self._counter
            self._counter += count
        secrets = [
            self._secret(k0 + i, j) for i in range(count) for j in range(limbs)
        ]
        from .. import native
        from .winternitz import DIGITS, N

        pk = native.winternitz_pubkeys_batch(secrets, N, DIGITS)
        pub_keys = [[bytes(pk[s, d]) for d in range(N)] for s in range(len(secrets))]
        return [
            BitCommitment(
                [
                    BitCommitmentU32(
                        secrets[i * limbs + j], pub_key=pub_keys[i * limbs + j]
                    )
                    for j in range(limbs)
                ]
            )
            for i in range(count)
        ]
