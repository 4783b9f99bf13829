"""The proof's bytes as the format defines them (version 1: a constant
final polynomial; 2: a list of coefficients), read into plain values and
written back, and the comparison of two such readings by section.

Layout, little-endian u32 throughout: b"TAPSTARK" version; trace roots;
quotient roots (roots: count, then per repetition its word count and
words); trace_local, trace_next (count, extension values); quotient chunks
(count, per chunk count and values); the FRI proof (layer roots; per
query its input openings and layer openings; the final polynomial; the
proof-of-work witness); degree_bits. An opening is its values (per matrix
a count of tagged scalars: 1 then a u32, or 4 then four u32) and its
leaf proof (tag 0, one shard, or 1 and a count of shards); a shard is its
script, leaf hash, path (length-prefixed bytes each), the index
commitment and each value's commitment (per limb its secret and a 0),
and the leaf index.
"""

from __future__ import annotations

import io
import struct


class Reader:
    def __init__(self, data: bytes):
        self.b = io.BytesIO(data)
        self.size = len(data)

    def u32(self) -> int:
        raw = self.b.read(4)
        if len(raw) != 4:
            raise ValueError("proof ends early")
        return struct.unpack("<I", raw)[0]

    def raw(self, n: int) -> bytes:
        out = self.b.read(n)
        if len(out) != n:
            raise ValueError("proof ends early")
        return out

    def bytes_(self) -> bytes:
        return self.raw(self.u32())

    def ext(self):
        return tuple(self.u32() for _ in range(4))

    def scalar(self):
        tag = self.raw(1)
        if tag == b"\x01":
            return ("F", self.u32())
        if tag == b"\x04":
            return ("E", self.ext())
        raise ValueError(f"bad scalar tag {tag!r}")

    def roots(self):
        return [[self.u32() for _ in range(self.u32())] for _ in range(self.u32())]

    def bc(self):
        return [(self.bytes_(), self.u32()) for _ in range(self.u32())]

    def shard(self):
        return {
            "script": self.bytes_(),
            "leaf_hash": self.bytes_(),
            "branch": [self.bytes_() for _ in range(self.u32())],
            "index_bc": self.bc(),
            "evals_bc": [self.bc() for _ in range(self.u32())],
            "query_index": self.u32(),
        }

    def leaf_proof(self):
        tag = self.u32()
        if tag == 1:
            return {"sharded": True, "shards": [self.shard() for _ in range(self.u32())]}
        if tag != 0:
            raise ValueError(f"bad leaf proof tag {tag}")
        return {"sharded": False, "shards": [self.shard()]}

    def values(self):
        return [[self.scalar() for _ in range(self.u32())] for _ in range(self.u32())]


def parse(data: bytes) -> dict:
    r = Reader(data)
    magic = r.raw(9)
    if magic[:8] != b"TAPSTARK" or magic[8] not in (1, 2):
        raise ValueError("bad proof header")
    out = {"version": magic[8], "trace_roots": r.roots(), "quotient_roots": r.roots()}
    out["trace_local"] = [r.ext() for _ in range(r.u32())]
    out["trace_next"] = [r.ext() for _ in range(r.u32())]
    out["quotient_chunks"] = [[r.ext() for _ in range(r.u32())] for _ in range(r.u32())]
    out["fri_roots"] = [r.roots() for _ in range(r.u32())]
    queries = []
    for _ in range(r.u32()):
        inputs = [{"values": r.values(), "proof": r.leaf_proof()} for _ in range(r.u32())]
        layers = [{"values": r.values(), "proof": r.leaf_proof()} for _ in range(r.u32())]
        queries.append({"inputs": inputs, "layers": layers})
    out["queries"] = queries
    if out["version"] == 2:
        out["final_poly"] = [r.ext() for _ in range(r.u32())]
    else:
        out["final_poly"] = [r.ext()]
    out["pow_witness"] = r.u32()
    out["degree_bits"] = r.u32()
    if r.b.tell() != r.size:
        raise ValueError(f"{r.size - r.b.tell()} bytes after the proof")
    return out


class Writer:
    def __init__(self):
        self.b = io.BytesIO()

    def u32(self, v):
        self.b.write(struct.pack("<I", v))

    def bytes_(self, data):
        self.u32(len(data))
        self.b.write(data)

    def roots(self, roots):
        self.u32(len(roots))
        for root in roots:
            self.u32(len(root))
            for w in root:
                self.u32(w)

    def ext(self, v):
        for c in v:
            self.u32(c)

    def values(self, rows):
        self.u32(len(rows))
        for row in rows:
            self.u32(len(row))
            for kind, v in row:
                if kind == "F":
                    self.b.write(b"\x01")
                    self.u32(v)
                else:
                    self.b.write(b"\x04")
                    self.ext(v)

    def leaf_proof(self, p):
        self.u32(1 if p["sharded"] else 0)
        if p["sharded"]:
            self.u32(len(p["shards"]))
        for s in p["shards"]:
            self.bytes_(s["script"])
            self.bytes_(s["leaf_hash"])
            self.u32(len(s["branch"]))
            for h in s["branch"]:
                self.bytes_(h)
            for bc in [s["index_bc"]] + [None] + s["evals_bc"]:
                if bc is None:
                    self.u32(len(s["evals_bc"]))
                    continue
                self.u32(len(bc))
                for secret, v in bc:
                    self.bytes_(secret)
                    self.u32(v)
            self.u32(s["query_index"])


def serialize(p: dict) -> bytes:
    w = Writer()
    w.b.write(b"TAPSTARK" + bytes([p["version"]]))
    w.roots(p["trace_roots"])
    w.roots(p["quotient_roots"])
    for key in ("trace_local", "trace_next"):
        w.u32(len(p[key]))
        for v in p[key]:
            w.ext(v)
    w.u32(len(p["quotient_chunks"]))
    for chunk in p["quotient_chunks"]:
        w.u32(len(chunk))
        for v in chunk:
            w.ext(v)
    w.u32(len(p["fri_roots"]))
    for roots in p["fri_roots"]:
        w.roots(roots)
    w.u32(len(p["queries"]))
    for q in p["queries"]:
        for part in ("inputs", "layers"):
            w.u32(len(q[part]))
            for o in q[part]:
                w.values(o["values"])
                w.leaf_proof(o["proof"])
    if p["version"] == 2:
        w.u32(len(p["final_poly"]))
    for c in p["final_poly"]:
        w.ext(c)
    w.u32(p["pow_witness"])
    w.u32(p["degree_bits"])
    return w.b.getvalue()


def count_differences(a, b) -> int:
    """Leaves of two nested readings that differ; a missing or extra
    element counts once."""
    if isinstance(a, dict) and isinstance(b, dict):
        keys = set(a) | set(b)
        return sum(count_differences(a.get(k), b.get(k)) if k in a and k in b else 1 for k in keys)
    if isinstance(a, list) and isinstance(b, list):
        return sum(count_differences(x, y) for x, y in zip(a, b)) + abs(len(a) - len(b))
    return int(a != b)
