"""The Fiat-Shamir transcript the proof format defines: a duplex on the
BLAKE3 compression function. The state is an 8-word chaining value from
the BLAKE3 IV; 16 absorbed words (fewer, zero-padded, with their byte
length as the block length) make one compression with the flags
CHUNK_START | CHUNK_END | ROOT; its 8 output words are the new state and
the squeeze, popped from the last. An absorb clears the squeeze. A
commitment is absorbed as the 8 little-endian words of the BLAKE3 hash of
its roots' little-endian words. An extension sample is 4 popped words mod
p; sample_bits(b) the top b bits of one popped word. The proof-of-work
witness is the smallest w with sample_bits(bits) == 0 after absorbing w."""

from __future__ import annotations

import struct

from . import hashes as H
from .field import P

FLAGS = H.CHUNK_START | H.CHUNK_END | H.ROOT


class Transcript:
    def __init__(self):
        self.cv = list(H.B3_IV)
        self.inbuf: list[int] = []
        self.outbuf: list[int] = []

    def _step(self, cv, words):
        block = words + [0] * (16 - len(words))
        return H.blake3_compress(cv, block, 0, 4 * len(words), FLAGS)[:8]

    def _compress(self):
        self.cv = self._step(self.cv, self.inbuf)
        self.inbuf = []
        self.outbuf = list(self.cv)

    def observe(self, w: int):
        self.outbuf = []
        self.inbuf.append(w & H.M32)
        if len(self.inbuf) == 16:
            self._compress()

    def observe_commitment(self, roots: list[list[int]]):
        data = b"".join(struct.pack("<I", w) for root in roots for w in root)
        for w in struct.unpack("<8I", H.blake3(data)):
            self.observe(w)

    def _pop(self) -> int:
        if self.inbuf or not self.outbuf:
            self._compress()
        return self.outbuf.pop()

    def sample_ext(self):
        return tuple(self._pop() % P for _ in range(4))

    def sample_bits(self, bits: int) -> int:
        return self._pop() >> (32 - bits)

    def grind(self, bits: int) -> int:
        w = 0
        while w < 1 << 32:
            pending = self.inbuf + [w]
            if len(pending) <= 16 and self._step(self.cv, pending)[7] >> (32 - bits) == 0:
                self.observe(w)
                if self.sample_bits(bits) != 0:
                    raise AssertionError("grind: the witness does not check")
                return w
            w += 1
        raise RuntimeError("grind: no witness")
