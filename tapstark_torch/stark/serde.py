"""Proof (de)serialization (twin of `tapstark.stark.serde`: the same
bytes, so either package reads what the other wrote).

Reference parity: serde derives on FriProof/CommitedProof/Proof
(fri/src/proof.rs:7-12, basic/src/tcs/mod.rs:100-106; postcard roundtrip in
the reference's mul_air test). This is the framework's full persistence
story — proofs are pure data; proving is a batch function (SURVEY.md §5).

Binary format: a simple length-prefixed canonical encoding (little-endian),
stable across processes; `proof_to_bytes`/`proof_from_bytes` roundtrip the
entire Proof including taptree leaves, merkle branches and Winternitz
commitments (secrets included — the proof carrier re-signs openings exactly
like the reference's CommitedProof with embedded BitCommitments).
"""

from __future__ import annotations

import io
import struct

from ..commit.bitcomm import BitCommitment, BitCommitmentU32
from ..commit.taptree import LeafNode
from ..commit.tcs import CommitedProof, ShardedCommitedProof, UseBComm
from ..field.scalar import EF4, F
from ..fri.pcs import BatchOpening
from ..fri.proof import BfQueryProof, FriProof
from .proof import Commitments, OpenedValues, Proof


def _w_u32(b, v):
    b.write(struct.pack("<I", v))


def _r_u32(b):
    return struct.unpack("<I", b.read(4))[0]


def _w_bytes(b, data: bytes):
    _w_u32(b, len(data))
    b.write(data)


def _r_bytes(b) -> bytes:
    return b.read(_r_u32(b))


def _w_ef(b, v: EF4):
    for c in v.c:
        _w_u32(b, c)


def _r_ef(b) -> EF4:
    return EF4([_r_u32(b) for _ in range(4)])


def _w_scalar(b, v):
    if isinstance(v, F):
        b.write(b"\x01")
        _w_u32(b, v.v)
    else:
        b.write(b"\x04")
        _w_ef(b, v)


def _r_scalar(b):
    tag = b.read(1)
    if tag == b"\x01":
        return F(_r_u32(b))
    return _r_ef(b)


def _w_roots(b, roots: list[list[int]]):
    _w_u32(b, len(roots))
    for r in roots:
        # 8 words per shard tree; sharded wide commits carry 8*K words
        if len(r) % 8:
            raise ValueError("a commitment root list holds 8 words per shard tree")
        _w_u32(b, len(r))
        for w in r:
            _w_u32(b, w)


def _r_roots(b) -> list[list[int]]:
    n = _r_u32(b)
    return [[_r_u32(b) for _ in range(_r_u32(b))] for _ in range(n)]


def _w_bc(b, bc: BitCommitment):
    _w_u32(b, len(bc.commitments))
    for c in bc.commitments:
        _w_bytes(b, c.winternitz.secret_key)
        # .value is transient working state (set_values runs before every
        # leaf-script build; UseBComm objects are shared across the queries
        # of one tree, so the live value is call-history-dependent) —
        # serialize a canonical 0 so proof bytes are a pure function of the
        # proof's content
        _w_u32(b, 0)


def _r_bc(b) -> BitCommitment:
    n = _r_u32(b)
    return BitCommitment(
        [BitCommitmentU32(_r_bytes(b), _r_u32(b)) for _ in range(n)]
    )


def _w_commited_proof(b, p):
    """Tag 0 = single CommitedProof, 1 = sharded (wide-trace column shards)."""
    if isinstance(p, ShardedCommitedProof):
        _w_u32(b, 1)
        _w_u32(b, len(p.shards))
        for sp in p.shards:
            _w_one_commited_proof(b, sp)
        return
    _w_u32(b, 0)
    _w_one_commited_proof(b, p)


def _w_one_commited_proof(b, p: CommitedProof):
    _w_bytes(b, p.leaf.script)
    _w_bytes(b, p.leaf.leaf_hash)
    _w_u32(b, len(p.leaf.merkle_branch))
    for h in p.leaf.merkle_branch:
        _w_bytes(b, h)
    _w_bc(b, p.use_bcs.index_bc)
    _w_u32(b, len(p.use_bcs.evaluations_bc))
    for bc in p.use_bcs.evaluations_bc:
        _w_bc(b, bc)
    _w_u32(b, p.query_index)


def _r_commited_proof(b):
    tag = _r_u32(b)
    if tag == 1:
        return ShardedCommitedProof(
            shards=[_r_one_commited_proof(b) for _ in range(_r_u32(b))]
        )
    if tag != 0:
        raise ValueError(f"bad CommitedProof tag {tag}")
    return _r_one_commited_proof(b)


def _r_one_commited_proof(b) -> CommitedProof:
    script = _r_bytes(b)
    leaf_hash = _r_bytes(b)
    branch = [_r_bytes(b) for _ in range(_r_u32(b))]
    index_bc = _r_bc(b)
    evals_bc = [_r_bc(b) for _ in range(_r_u32(b))]
    qi = _r_u32(b)
    return CommitedProof(
        leaf=LeafNode(script=script, leaf_hash=leaf_hash, merkle_branch=branch),
        use_bcs=UseBComm(index_bc=index_bc, evaluations_bc=evals_bc),
        query_index=qi,
    )


def _w_batch_opening(b, bo: BatchOpening):
    _w_u32(b, len(bo.opened_values))
    for row in bo.opened_values:
        _w_u32(b, len(row))
        for v in row:
            _w_scalar(b, v)
    _w_commited_proof(b, bo.opening_proof)


def _r_batch_opening(b) -> BatchOpening:
    rows = []
    for _ in range(_r_u32(b)):
        rows.append([_r_scalar(b) for _ in range(_r_u32(b))])
    return BatchOpening(opened_values=rows, opening_proof=_r_commited_proof(b))


def _w_fri_proof(b, fp: FriProof):
    """final_poly: a single EF4 (format v1, fold-to-constant) or a coeff
    list (format v2, early-stopping FRI — see FriConfig.log_final_poly_len);
    the header byte disambiguates so v1 proof bytes are unchanged."""
    _w_u32(b, len(fp.commit_phase_commits))
    for roots in fp.commit_phase_commits:
        _w_roots(b, roots)
    _w_u32(b, len(fp.query_proofs))
    for qp in fp.query_proofs:
        _w_u32(b, len(qp.input_proof))
        for bo in qp.input_proof:
            _w_batch_opening(b, bo)
        _w_u32(b, len(qp.commit_phase_openings))
        for opened, cp in qp.commit_phase_openings:
            _w_u32(b, len(opened))
            for row in opened:
                _w_u32(b, len(row))
                for v in row:
                    _w_scalar(b, v)
            _w_commited_proof(b, cp)
    if isinstance(fp.final_poly, list):
        _w_u32(b, len(fp.final_poly))
        for c in fp.final_poly:
            _w_ef(b, c)
    else:
        _w_ef(b, fp.final_poly)
    _w_u32(b, fp.pow_witness)


def _r_fri_proof(b, final_poly_list: bool = False) -> FriProof:
    commits = [_r_roots(b) for _ in range(_r_u32(b))]
    qps = []
    for _ in range(_r_u32(b)):
        input_proof = [_r_batch_opening(b) for _ in range(_r_u32(b))]
        openings = []
        for _ in range(_r_u32(b)):
            opened = []
            for _ in range(_r_u32(b)):
                opened.append([_r_scalar(b) for _ in range(_r_u32(b))])
            openings.append((opened, _r_commited_proof(b)))
        qps.append(BfQueryProof(input_proof=input_proof, commit_phase_openings=openings))
    if final_poly_list:
        final_poly = [_r_ef(b) for _ in range(_r_u32(b))]
    else:
        final_poly = _r_ef(b)
    pow_witness = _r_u32(b)
    return FriProof(
        commit_phase_commits=commits,
        query_proofs=qps,
        final_poly=final_poly,
        pow_witness=pow_witness,
    )


def proof_to_bytes(proof: Proof) -> bytes:
    b = io.BytesIO()
    version = 2 if isinstance(proof.opening_proof.final_poly, list) else 1
    b.write(b"TAPSTARK" + bytes([version]))
    _w_roots(b, proof.commitments.trace)
    _w_roots(b, proof.commitments.quotient_chunks)
    ov = proof.opened_values
    for vec in (ov.trace_local, ov.trace_next):
        _w_u32(b, len(vec))
        for v in vec:
            _w_ef(b, v)
    _w_u32(b, len(ov.quotient_chunks))
    for chunk in ov.quotient_chunks:
        _w_u32(b, len(chunk))
        for v in chunk:
            _w_ef(b, v)
    _w_fri_proof(b, proof.opening_proof)
    _w_u32(b, proof.degree_bits)
    return b.getvalue()


def proof_from_bytes(data: bytes) -> Proof:
    b = io.BytesIO(data)
    magic = b.read(9)
    if magic[:8] != b"TAPSTARK" or len(magic) < 9 or magic[8] not in (1, 2):
        raise ValueError("bad proof header")
    final_poly_list = magic[8] == 2
    trace = _r_roots(b)
    quotient = _r_roots(b)
    trace_local = [_r_ef(b) for _ in range(_r_u32(b))]
    trace_next = [_r_ef(b) for _ in range(_r_u32(b))]
    chunks = []
    for _ in range(_r_u32(b)):
        chunks.append([_r_ef(b) for _ in range(_r_u32(b))])
    fri = _r_fri_proof(b, final_poly_list)
    degree_bits = _r_u32(b)
    return Proof(
        commitments=Commitments(trace=trace, quotient_chunks=quotient),
        opened_values=OpenedValues(
            trace_local=trace_local, trace_next=trace_next, quotient_chunks=chunks
        ),
        opening_proof=fri,
        degree_bits=degree_bits,
    )
