"""The FRI commit phase's transcript chain where the layers are folded (the
port of `tapstark.challenger.device_tail`).

Each FRI layer's fold needs its beta, and beta comes from the transcript:
observe_commitment(the layer's R taptree roots) then sample(). On the host
that is a copy of the roots to the host and of beta back, a round trip per
layer that stalls the card. The chain runs that step where the roots are:
`transcript_step` (csrc/transcript.cu, one thread, one launch a layer)
reads the (R, 8) root words the SHA-256 kernels wrote, computes the
commitment's blake3 digest, advances a word-exact twin of the BfChallenger
duplex, and writes beta in Montgomery form for the fold.

The host challenger is replayed afterwards from one copy of every chained
layer's roots and popped words (fri/prover.py, the flush); the replay
raises if a popped word differs, so the transcript, the op_log the script
verifier replays and the proof bytes are the host's.

Duplex semantics (challenger.BfChallenger): absorb rate 16 words with a
compression at a full buffer; sample pops from the END of the 8-word
output; observe clears the output. In the FRI loop each layer observes 8
digest words then samples 4, so only the first step can carry pending
input words (0-15 of them; with 8 or more a compression happens mid-absorb).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.constants import P
from ..field.device import to_mont
from ..hashes.blake3 import CHUNK_END, CHUNK_START, IV, ROOT, compress_batch, compress_scan  # noqa: F401 (the reference's name)
from . import FLAGS, RATE, Blake3Compression, TestPermutation

# steps taken by every chain since the process started (tests and
# chip_smoke.py read it)
TOTAL_STEPS = 0

KIND_BLAKE3, KIND_TEST = 0, 1
MAX_REPS = 32  # R * 32 bytes of roots in one blake3 chunk (1024 bytes)

# launches of `transcript_step`'s kernel since the last reset
launches = {"transcript_step": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


_M32 = 0xFFFFFFFF


def _byteswap(x: torch.Tensor) -> torch.Tensor:
    return ((x >> 24) | ((x >> 8) & 0xFF00) | ((x & 0xFF00) << 8) | (x << 24)) & _M32


def _duplex_plain(cv: list, block: list, n: int, kind: int) -> list:
    """Blake3Compression.compress / TestPermutation.compress on int64 0-d
    tensors: the block's first n words are input, the rest zero."""
    if kind == KIND_BLAKE3:
        return compress_batch(block, 0, 4 * n, FLAGS, cv)
    mixed = [((cv[i] ^ block[i]) + block[i + 8] + 4 * n + i) & _M32 for i in range(8)]
    return mixed[::-1]


def transcript_step_plain(cv: torch.Tensor, pending: torch.Tensor, roots: torch.Tensor, kind: int):
    """`transcript_step`'s plain version, eager torch on the tensors' device
    (compress_batch on int64 scalars): ~1,000 small ops a compression."""
    words = _byteswap(roots.to(torch.int64).reshape(-1) & _M32)
    n = words.numel()
    blocks = -(-n // 16)
    words = torch.cat([words, words.new_zeros(16 * blocks - n)])
    digest = list(IV)
    for b in range(blocks):
        flags = (CHUNK_START if b == 0 else 0) | (CHUNK_END | ROOT if b == blocks - 1 else 0)
        digest = compress_batch([words[16 * b + i] for i in range(16)], 0, min(64, 4 * n - 64 * b), flags, digest)
    buf = [w for w in pending.to(torch.int64) & _M32] + digest
    state = [w for w in cv.to(torch.int64) & _M32]
    zero = words[0] * 0
    did_full = len(buf) >= RATE
    if did_full:
        state = _duplex_plain(state, buf[:RATE], RATE, kind)
        buf = buf[RATE:]
    if buf or not did_full:
        state = _duplex_plain(state, buf + [zero] * (RATE - len(buf)), len(buf), kind)
    out = torch.stack(state)
    popped = out[[7, 6, 5, 4]]
    return out.to(torch.int32), to_mont(popped % P), popped.to(torch.int32)


def transcript_step(cv: torch.Tensor, pending: torch.Tensor, roots: torch.Tensor, kind: int):
    """One FRI layer's observe_commitment(roots) then sample(): cv (8,) and
    pending (k,) int32 duplex words (k < 16), roots (R, 8) int32 big-endian
    SHA words (any strides, R <= MAX_REPS), kind KIND_BLAKE3 or KIND_TEST.
    Returns (cv' (8,), beta (4,) Montgomery int32, the popped words (4,)).
    On the card one launch of csrc/transcript.cu; on CPU tensors, its
    plain version."""
    if roots.dim() != 2 or roots.shape[1] != 8 or not 1 <= roots.shape[0] <= MAX_REPS:
        raise ValueError(f"transcript_step: roots of shape {tuple(roots.shape)}, not (R <= {MAX_REPS}, 8)")
    if cv.shape != (8,) or pending.dim() != 1 or pending.shape[0] >= RATE or kind not in (KIND_BLAKE3, KIND_TEST):
        raise ValueError("transcript_step: cv must be (8,), pending (k < 16,), kind 0 or 1")
    if roots.device.type == "cpu":
        return transcript_step_plain(cv, pending, roots, kind)
    if roots.device.type != "cuda":
        raise ValueError(f"transcript_step: no path for device {roots.device}")
    if any(t.dtype != torch.int32 or t.device != roots.device for t in (cv, pending, roots)):
        raise ValueError("transcript_step: expected int32 tensors on one device")
    cv, pending = cv.contiguous(), pending.contiguous()
    from .._build import load_library

    out = torch.empty(16, dtype=torch.int32, device=roots.device)
    with torch.cuda.device(roots.device):
        err = load_library().tapstark_transcript_step(
            cv.data_ptr(), pending.data_ptr(), pending.shape[0], roots.data_ptr(), roots.shape[0], roots.stride(0),
            roots.stride(1), kind, out.data_ptr(), torch.cuda.current_stream(roots.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transcript_step: CUDA error {err}")
    launches["transcript_step"] += 1
    return out[:8], out[8:12], out[12:]


def chain_supported(challenger, reps: int) -> bool:
    """True when the chain can twin this challenger: an extension-field
    challenger with a known compression (Blake3Compression or
    TestPermutation) and a commitment digest of one blake3 chunk
    (reps * 32 <= 1024 bytes)."""
    if type(challenger.compression) not in (Blake3Compression, TestPermutation):
        return False
    return challenger.field == "ext" and 1 <= reps <= MAX_REPS


class DeviceTailChain:
    """The challenger's twin for the FRI commit phase: snapshots the host
    challenger's (cv, pending input) once, then step(roots) per layer with
    the layer's roots where they are; returns the fold's beta (Montgomery)
    and the popped words (which the flush holds against the host's replay).
    The host challenger must not advance between steps."""

    def __init__(self, challenger):
        self._kind = KIND_TEST if isinstance(challenger.compression, TestPermutation) else KIND_BLAKE3
        self._cv = np.array(challenger.cv, dtype=np.uint32).view(np.int32)
        self._pending = np.array(challenger.input_buffer, dtype=np.uint32).view(np.int32)
        self.steps = 0

    def step(self, roots: torch.Tensor):
        global TOTAL_STEPS
        cv, pending = self._cv, self._pending
        if isinstance(cv, np.ndarray):  # the first step: the host state goes where the roots are
            cv, pending = (torch.from_numpy(a.copy()).to(roots.device) for a in (cv, pending))
        self._cv, beta_mont, beta_words = transcript_step(cv, pending, roots, self._kind)
        self._pending = pending[:0]
        self.steps += 1
        TOTAL_STEPS += 1
        return beta_mont, beta_words
