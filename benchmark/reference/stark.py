"""The plain reference of a prove: from a statement (trace and public
values) it works out again every part of the proof's bytes and compares
them with the bytes the program wrote.

What it computes, all in plain PyTorch (`field`, `hashes`) and Python:
the trace's coset LDE (blowup B on the coset of the generator 31, rows in
bit-reversed order), the constraint quotient over the disjoint coset and
its chunks' LDEs, the values opened at zeta and zeta * w_n, the reduced
opening, every FRI fold, the final polynomial, the grind, the query
indices, and each query's opened rows, leaf scripts, leaf hashes and bit
commitments, with the Winternitz keys derived from their secrets.

Its one shortcut is the taptrees: a full tree per query repetition is
thousands of times the work of everything else. So the transcript absorbs
the proof's own roots, and of every commit the reference rebuilds whole
the trees of `TREES_PER_COMMIT` repetitions drawn from the sample seed,
comparing their roots and the paths of their queries. For every other
repetition it checks that the path the proof gives leads from the leaf
hash the reference computed to the root the proof gives.

`check` returns the number of differing values in each section of the
proof, each to be held to 0.
"""

from __future__ import annotations

import importlib
import random
from dataclasses import dataclass

import numpy as np
import torch

from . import field as fd
from . import proof as pf
from . import script as sc
from . import tree
from .field import P
from .transcript import Transcript

TREES_PER_COMMIT = 1
MANAGER_SEED = b""  # the bit-commitment managers' seed in `standard_config`
_COLS = 32  # LDE columns at a time


@dataclass(frozen=True)
class Setting:
    """A configuration's proving parameters (`standard_config`'s)."""

    air: str
    log_n: int
    log_blowup: int
    num_queries: int
    pow_bits: int
    log_final_poly_len: int = 0

    @classmethod
    def from_config(cls, cfg: dict) -> "Setting":
        return cls(cfg["air"], cfg["log_n"], cfg["log_blowup"], cfg["num_queries"], cfg["proof_of_work_bits"],
                   cfg.get("log_final_poly_len", 0))


def air_module(name: str):
    return importlib.import_module(f"{__package__}.airs.{name}")


def _log2_ceil(n: int) -> int:
    return (n - 1).bit_length()


def log_quotient_degree(air) -> int:
    return _log2_ceil(max(air.DEGREE, 2) - 1)


def num_layers(s: Setting) -> int:
    return s.log_n - s.log_final_poly_len


def assignments_per_prove(s: Setting) -> tuple[int, int]:
    """Counter steps of the base and extension bit-commitment managers in
    one prove: per repetition and shard one index and one per value."""
    air = air_module(s.air)
    qd = 1 << log_quotient_degree(air)
    base = sum(s.num_queries * (1 + hi - lo) for w in (air.WIDTH, 4 * qd) for lo, hi in sc.shard_bounds(w))
    return base, num_layers(s) * s.num_queries * 3


class _Selectors:
    def __init__(self, xs, log_n):
        n = 1 << log_n
        last = fd.inv(fd.two_adic_generator(log_n))
        zh = (fd.pow_t(xs, n) - 1) % P
        self.first = zh * fd.inv_t((xs - 1) % P) % P
        self.last = zh * fd.inv_t((xs - last) % P) % P
        self.transition = (xs - last) % P
        self.inv_zh = fd.inv_t(zh)


def _lde_bitrev(evals: torch.Tensor, log_n: int, log_size: int, shift: int):
    """(coefficients, values on shift * H_size in bit-reversed row order)."""
    coeffs, out = [], []
    br = fd.bitrev(log_size, evals.device)
    for c0 in range(0, evals.shape[1], _COLS):
        c = fd.interpolate(evals[:, c0 : c0 + _COLS], log_n)
        coeffs.append(c)
        out.append(fd.evaluate_coset(c, log_size, shift)[br])
    return torch.cat(coeffs, 1), torch.cat(out, 1)


def _fold(mat: torch.Tensor, beta) -> torch.Tensor:
    """(half, 2, 4) bit-reversed pairs -> (half, 4): (1/2 + beta / (2 x)) e0
    + (1/2 - beta / (2 x)) e1, x^-1 the powers of the inverse generator of
    order 2 half in bit-reversed order."""
    half = mat.shape[0]
    log_half = half.bit_length() - 1
    ginv = fd.powers(fd.inv(fd.two_adic_generator(log_half + 1)), half, mat.device)[fd.bitrev(log_half, mat.device)]
    inv2 = fd.inv(2)
    hb = fd.ef_const([b * inv2 for b in beta], mat.device)
    power = hb[None, :] * ginv[:, None] % P
    plus, minus = power.clone(), (-power) % P
    plus[:, 0] = (plus[:, 0] + inv2) % P
    minus[:, 0] = (minus[:, 0] + inv2) % P
    return (fd.ef_mul(plus, mat[:, 0]) + fd.ef_mul(minus, mat[:, 1])) % P


class _Commit:
    """A commit of equal-height matrices: its leaf values (N, v, limbs)
    and per repetition its shards."""

    def __init__(self, values: torch.Tensor, ext: bool, counter: int, reps: int, seed: bytes):
        self.values = values
        self.limbs = 4 if ext else 1
        self.bounds = sc.shard_bounds(values.shape[1])
        self.secrets = []  # per rep, per shard: (index secret, [[limb secrets] per value])
        for _ in range(reps):
            rep = []
            for lo, hi in self.bounds:
                index = sc.secret(seed, counter, 0)
                vals = [[sc.secret(seed, counter + 1 + i, j) for j in range(self.limbs)] for i in range(hi - lo)]
                counter += 1 + hi - lo
                rep.append((index, vals))
            self.secrets.append(rep)
        self.counter = counter
        self.shards = None

    def all_secrets(self):
        return [s for rep in self.secrets for index, vals in rep for s in [index] + [x for v in vals for x in v]]

    def build(self, keys):
        self.shards = [[sc.Shard(index, vals, keys, self.limbs) for index, vals in rep] for rep in self.secrets]


def _dig(x, *path):
    for k in path:
        try:
            x = x[k]
        except (KeyError, IndexError, TypeError):
            return None
    return x


def _root_bytes(words) -> bytes | None:
    if not isinstance(words, list) or len(words) != 8:
        return None
    return b"".join(int(w).to_bytes(4, "little") for w in words)


def check(s: Setting, trace: np.ndarray, pis: list[int], got_bytes: bytes, prior_proves: int,
          sample_seed: int, device) -> dict[str, int]:
    try:
        got = pf.parse(got_bytes)
    except ValueError:
        return {"parse": 1}
    air = air_module(s.air)
    dev = torch.device(device)
    n, log_n, blow = 1 << s.log_n, s.log_n, 1 << s.log_blowup
    log_big = log_n + s.log_blowup
    big = 1 << log_big
    g = fd.GENERATOR

    # trace commit
    tr_evals = torch.from_numpy(np.ascontiguousarray(trace, dtype=np.int64)).to(dev)
    tr_coeffs, tr_lde = _lde_bitrev(tr_evals, log_n, log_big, g)
    del tr_evals
    ts = Transcript()
    ts.observe_commitment(got["trace_roots"])
    alpha = ts.sample_ext()

    # quotient
    lqd = log_quotient_degree(air)
    qd, log_m = 1 << lqd, log_n + lqd
    m = 1 << log_m
    on_q = tr_lde[fd.bitrev(log_big, dev)[:: big // m]]  # natural order on g H_m
    nxt = torch.roll(on_q, -qd, dims=0)
    xs = fd.powers(fd.two_adic_generator(log_m), m, dev, start=g)
    sel = _Selectors(xs, log_n)
    acc = torch.zeros((m, 4), dtype=torch.int64, device=dev)
    alpha_t = fd.ef_const(alpha, dev)
    local = list(on_q.unbind(1))
    nxt_cols = list(nxt.unbind(1))
    for c in air.constraints(local, nxt_cols, [int(v) for v in pis], sel):
        acc = fd.ef_mul(acc, alpha_t)
        acc[:, 0] = (acc[:, 0] + c) % P
    quotient = fd.ef_scale(acc, sel.inv_zh)
    del on_q, nxt, local, nxt_cols, acc, sel, xs
    wm = fd.two_adic_generator(log_m)
    chunk_shifts = [g * pow(wm, i, P) % P for i in range(qd)]
    q_coeffs, q_ldes = [], []
    for i in range(qd):
        c, lde = _lde_bitrev(quotient[i::qd].contiguous(), log_n, log_big, g * fd.inv(chunk_shifts[i]) % P)
        q_coeffs.append(c)
        q_ldes.append(lde)
    del quotient
    ts.observe_commitment(got["quotient_roots"])
    zeta = ts.sample_ext()
    zeta_next = fd.e_mul(zeta, fd.e_base(fd.two_adic_generator(log_n)))

    trace_local = fd.eval_at(tr_coeffs, zeta)
    trace_next = fd.eval_at(tr_coeffs, zeta_next)
    chunk_vals = [fd.eval_at(c, fd.e_mul(zeta, fd.e_base(fd.inv(sh)))) for c, sh in zip(q_coeffs, chunk_shifts)]
    del tr_coeffs, q_coeffs

    # the open: one height, entries in (round, matrix, point) order
    alpha_o = ts.sample_ext()
    w = tr_lde.shape[1]
    columns = [tr_lde[:, c] for c in range(w)] + [lde[:, c] for lde in q_ldes for c in range(4)]
    entries = [(0, trace_local), (1, trace_next)]  # (point, ys of the trace's columns)
    weights = {0: [], 1: []}  # point -> (column, alpha power, opened value)
    ap = (1, 0, 0, 0)
    for p, ys in entries:
        for c in range(w):
            weights[p].append((c, ap, tuple(ys[c].tolist())))
            ap = fd.e_mul(ap, alpha_o)
    for i in range(qd):
        for c in range(4):
            weights[0].append((w + 4 * i + c, ap, tuple(chunk_vals[i][c].tolist())))
            ap = fd.e_mul(ap, alpha_o)
    xs_br = fd.powers(fd.two_adic_generator(log_big), big, dev, start=g)[fd.bitrev(log_big, dev)]
    ro = torch.zeros((big, 4), dtype=torch.int64, device=dev)
    for p, z in ((0, zeta), (1, zeta_next)):
        red = torch.zeros((big, 4), dtype=torch.int64, device=dev)
        ydot = (0, 0, 0, 0)
        for c, a, y in weights[p]:
            red = (red + columns[c][:, None] * fd.ef_const(a, dev)[None, :]) % P
            ydot = fd.e_add(ydot, fd.e_mul(a, y))
        red = (red - fd.ef_const(ydot, dev)) % P
        den = ((-fd.ef_const(z, dev)) % P).repeat(big, 1)  # x - z
        den[:, 0] = (den[:, 0] + xs_br) % P
        ro = (ro + fd.ef_mul(red, fd.ef_inv_t(den))) % P
    del columns, red, den, xs_br

    # FRI commit phase
    stop = blow << s.log_final_poly_len
    layers, folded, li = [], ro, 0
    while folded.shape[0] > stop:
        mat = folded.view(folded.shape[0] // 2, 2, 4)
        layers.append(mat)
        ts.observe_commitment(_dig(got, "fri_roots", li) or [])
        folded = _fold(mat, ts.sample_ext())
        li += 1
    if s.log_final_poly_len == 0:
        final = [tuple(folded[0].tolist())]
        if not bool((folded == folded[0]).all()):
            raise AssertionError("reference: the last layer is not constant")
    else:
        log_stop = stop.bit_length() - 1
        coeffs = fd.interpolate(folded[fd.bitrev(log_stop, dev)], log_stop)
        if bool(coeffs[1 << s.log_final_poly_len :].any()):
            raise AssertionError("reference: the final polynomial is too long")
        final = [tuple(r) for r in coeffs[: 1 << s.log_final_poly_len].tolist()]
        for c in final:
            for word in c:
                ts.observe(word)
    pow_witness = ts.grind(s.pow_bits)
    queries = [ts.sample_bits(log_big) for _ in range(s.num_queries)]

    # the commits' keys and leaves
    per_base, per_ext = assignments_per_prove(s)
    reps = s.num_queries
    trace_c = _Commit(tr_lde[:, :, None], False, prior_proves * per_base, reps, MANAGER_SEED)
    quot_c = _Commit(torch.cat(q_ldes, 1)[:, :, None], False, trace_c.counter, reps, MANAGER_SEED)
    layer_cs, counter = [], prior_proves * per_ext
    for mat in layers:
        c = _Commit(mat, True, counter, reps, MANAGER_SEED)
        counter = c.counter
        layer_cs.append(c)
    commits = [trace_c, quot_c] + layer_cs
    secrets = [x for c in commits for x in c.all_secrets()]
    keys = dict(zip(secrets, sc.pubkeys(secrets, dev)))
    for c in commits:
        c.build(keys)

    got_roots = [got["trace_roots"], got["quotient_roots"]] + [_dig(got, "fri_roots", i) for i in range(len(layers))]
    rng = random.Random(sample_seed)
    sampled = [set(rng.sample(range(reps), min(TREES_PER_COMMIT, reps))) for _ in commits]
    index_shift = [0, 0] + [i + 1 for i in range(len(layers))]

    # the sampled trees, all at once
    jobs, leaves = [], []
    for ci, c in enumerate(commits):
        for r in sorted(sampled[ci]):
            for si, (lo, hi) in enumerate(c.bounds):
                leaves.append(tree.leaf_digests(c.shards[r][si], c.values[:, lo:hi]))
                jobs.append((ci, r, si))
    built = dict(zip(jobs, tree.roots_and_paths(leaves, [queries[r] >> index_shift[ci] for ci, r, _ in jobs])))
    del leaves

    exp_roots = []
    for ci, c in enumerate(commits):
        roots = []
        for r in range(reps):
            if r in sampled[ci]:
                words = []
                for si in range(len(c.bounds)):
                    words += list(np.frombuffer(built[(ci, r, si)][0], dtype="<u4").tolist())
                roots.append(words)
            else:
                roots.append(_dig(got_roots, ci, r))
        exp_roots.append(roots)

    path_failures = 0

    def opening(ci, r, index, values_of):
        nonlocal path_failures
        c = commits[ci]
        row = c.values[index].tolist()  # (v, limbs)
        shards = []
        for si, (lo, hi) in enumerate(c.bounds):
            sh = c.shards[r][si]
            script = sh.script(index, row[lo:hi])
            leaf_hash = sc.tapleaf_hash(script)
            if r in sampled[ci]:
                branch = built[(ci, r, si)][1]
            else:
                branch = _dig(got, *values_of, "proof", "shards", si, "branch")
                root = _root_bytes(_dig(got_roots, ci, r, slice(8 * si, 8 * si + 8)))
                h = leaf_hash
                for sib in branch or []:
                    h = sc.tapbranch_hash(h, sib)
                if branch is None or root is None or h != root:
                    path_failures += 1
            shards.append({
                "script": script,
                "leaf_hash": leaf_hash,
                "branch": branch,
                "index_bc": [(c.secrets[r][si][0], 0)],
                "evals_bc": [[(x, 0) for x in v] for v in c.secrets[r][si][1]],
                "query_index": index,
            })
        return {"sharded": len(shards) > 1, "shards": shards}

    exp_queries = []
    for r, q in enumerate(queries):
        tr_row = [("F", v[0]) for v in trace_c.values[q].tolist()]
        q_row = [v[0] for v in quot_c.values[q].tolist()]
        inputs = [
            {"values": [tr_row], "proof": opening(0, r, q, ("queries", r, "inputs", 0))},
            {"values": [[("F", v) for v in q_row[4 * i : 4 * i + 4]] for i in range(qd)],
             "proof": opening(1, r, q, ("queries", r, "inputs", 1))},
        ]
        lays = []
        for i in range(len(layers)):
            idx = q >> (i + 1)
            pair = layers[i][idx].tolist()
            lays.append({"values": [[("E", tuple(pair[0])), ("E", tuple(pair[1]))]],
                         "proof": opening(2 + i, r, idx, ("queries", r, "layers", i))})
        exp_queries.append({"inputs": inputs, "layers": lays})

    exp = {
        "version": 2 if s.log_final_poly_len > 0 else 1,
        "trace_roots": exp_roots[0],
        "quotient_roots": exp_roots[1],
        "trace_local": [tuple(v) for v in trace_local.tolist()],
        "trace_next": [tuple(v) for v in trace_next.tolist()],
        "quotient_chunks": [[tuple(v) for v in cv.tolist()] for cv in chunk_vals],
        "fri_roots": exp_roots[2:],
        "queries": exp_queries,
        "final_poly": final,
        "pow_witness": pow_witness,
        "degree_bits": log_n,
    }
    return compare(exp, got, got_bytes, path_failures)


SECTIONS = {
    "header": ("version", "degree_bits"),
    "roots": ("trace_roots", "quotient_roots", "fri_roots"),
    "opened": ("trace_local", "trace_next", "quotient_chunks"),
    "final_poly": ("final_poly",),
    "pow_witness": ("pow_witness",),
}


def compare(exp: dict, got: dict, got_bytes: bytes, path_failures: int) -> dict[str, int]:
    out = {name: sum(pf.count_differences(exp[k], got.get(k)) for k in keys) for name, keys in SECTIONS.items()}
    parts = {"query_values": ("values",), "query_leaves": ("script", "leaf_hash"),
             "query_keys": ("index_bc", "evals_bc", "query_index"), "query_paths": ("branch",)}
    counts = dict.fromkeys(parts, 0)
    eq, gq = exp["queries"], got.get("queries", [])
    counts["query_values"] += abs(len(eq) - len(gq))
    for e, g in zip(eq, gq):
        eo = e["inputs"] + e["layers"]
        go = g.get("inputs", []) + g.get("layers", [])
        counts["query_values"] += abs(len(eo) - len(go))
        for a, b in zip(eo, go):
            counts["query_values"] += pf.count_differences(a["values"], b["values"])
            sa, sb = a["proof"]["shards"], b["proof"]["shards"]
            counts["query_leaves"] += abs(len(sa) - len(sb)) + int(a["proof"]["sharded"] != b["proof"]["sharded"])
            for x, y in zip(sa, sb):
                for name, keys in parts.items():
                    if name != "query_values":
                        counts[name] += sum(pf.count_differences(x[k], y[k]) for k in keys)
    out.update(counts)
    out["path_checks"] = path_failures
    try:
        out["bytes"] = int(pf.serialize(exp) != got_bytes)
    except (TypeError, KeyError, AttributeError, ValueError, OverflowError):
        out["bytes"] = 1
    out["parse"] = 0
    return out
