"""RecursionAir statements (163 columns), each the trace that
`tapstark_torch.airs.generate_recursion_trace(n, seed, x0, y0)` makes,
with (seed, x0, y0) drawn per statement: the hash lane's word chain runs
for all statements at once, row by row, and the rest is vectorized."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import field as fd
from ..reference.airs.recursion import OFFSETS, ROT, WIDTH

P = fd.P
M32 = 0xFFFFFFFF


def port_air():
    from tapstark_torch.airs import RecursionAir

    return RecursionAir()


def _chains(x0: np.ndarray, y0: np.ndarray, ms: np.ndarray):
    """(n, J) words x and y of J chains: z = rotr(x ^ y), x' = x + z + m,
    y' = z. The J lanes ride in one Python integer, 64 bits a lane (a
    32-bit sum of three words never reaches the next lane), so a row is a
    few big-integer operations."""
    n, lanes = ms.shape

    def pack(words):
        return int.from_bytes(np.ascontiguousarray(words, dtype="<u8").tobytes(), "little")

    low = pack(np.full(lanes, M32))  # each lane's 32 bits: what a shift moves across lanes lies outside
    rows_m = [pack(ms[i]) for i in range(n)]
    x, y = pack(x0), pack(y0)
    xs, ys = [], []
    width = 8 * lanes
    for i in range(n):
        xs.append(x.to_bytes(width, "little"))
        ys.append(y.to_bytes(width, "little"))
        t = x ^ y
        z = ((t >> ROT) | (t << (32 - ROT))) & low
        x, y = (x + z + rows_m[i]) & low, z
    unpack = lambda rows: np.frombuffer(b"".join(rows), dtype="<u8").reshape(n, lanes).astype(np.uint64)
    return unpack(xs), unpack(ys)


def statements(log_n: int, count: int, rng: np.random.Generator, device):
    n = 1 << log_n
    seeds = rng.integers(0, 1 << 62, count).tolist()
    x0 = rng.integers(0, 1 << 32, count, dtype=np.uint64)
    y0 = rng.integers(0, 1 << 32, count, dtype=np.uint64)
    draws = []
    for s in seeds:
        r = np.random.default_rng(s)
        ms = r.integers(0, 1 << 11, n).astype(np.uint64)
        beta = [int(v) for v in r.integers(1, P, 4)]
        e0 = r.integers(0, P, (n, 4))
        e1 = r.integers(0, P, (n, 4))
        draws.append((ms, beta, e0, e1))
    xs, ys = _chains(x0, y0, np.stack([d[0] for d in draws], axis=1))
    shifts = torch.arange(32, dtype=torch.int64, device=device)
    out = []
    for j, (ms, beta, e0, e1) in enumerate(draws):
        x = torch.from_numpy(xs[:, j].astype(np.int64)).to(device)
        y = torch.from_numpy(ys[:, j].astype(np.int64)).to(device)
        m = torch.from_numpy(ms.astype(np.int64)).to(device)
        t = x ^ y
        z = ((t >> ROT) | (t << (32 - ROT))) & M32
        a = (x + z + m) & M32
        c_lo = ((x & 0xFFFF) + (z & 0xFFFF) + m) >> 16
        c_hi = ((x >> 16) + (z >> 16) + c_lo) >> 16
        ca = (c_lo & 3) | ((c_hi & 3) << 2)
        e0_t = torch.from_numpy(e0).to(device)
        e1_t = torch.from_numpy(e1).to(device)
        bacc = fd.ef_mul(fd.ef_powers(beta, n, device), fd.ef_const(beta, device))
        step = fd.ef_mul(bacc, (e1_t - e0_t) % P)
        facc = torch.zeros((n, 4), dtype=torch.int64, device=device)
        facc[1:] = torch.cumsum(step[:-1], dim=0) % P
        rows = torch.empty((n, WIDTH), dtype=torch.int64, device=device)
        for name, words in (("x", x), ("y", y), ("z", z), ("a", a)):
            o = OFFSETS[name]
            rows[:, o : o + 32] = (words[:, None] >> shifts) & 1
        rows[:, OFFSETS["ca"] : OFFSETS["ca"] + 4] = (ca[:, None] >> shifts[:4]) & 1
        rows[:, OFFSETS["m"] : OFFSETS["m"] + 11] = (m[:, None] >> shifts[:11]) & 1
        for name, v in (("e0", e0_t), ("e1", e1_t), ("bacc", bacc), ("facc", facc)):
            rows[:, OFFSETS[name] : OFFSETS[name] + 4] = v
        rows[:, OFFSETS["beta"] : OFFSETS["beta"] + 4] = fd.ef_const(beta, device)
        trace = rows.to(torch.int32).cpu().numpy().view(np.uint32)
        x_first, y_first = int(xs[0, j]), int(ys[0, j])
        pis = [x_first & 0xFFFF, x_first >> 16, y_first & 0xFFFF, y_first >> 16] + beta
        pis += [int(v) for v in facc[-1].tolist()]
        out.append((trace, pis))
    return out
