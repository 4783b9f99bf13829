"""The least time a piece of work can take on the card: the larger of its
bytes over the memory bandwidth and its 32-bit integer instructions over
the issue rate. A frozen copy of the port's own bound arithmetic
(`chip_smoke.py`, PR 5-10), so that later changes to that file do not move
this yardstick.

Peaks, for an NVIDIA H100 SXM5 80GB at its 700 W limit:
- MEM_BYTES_PER_S: 3.35 TB/s of HBM3, NVIDIA's H100 data sheet.
- INT32_OPS_PER_S: the issue ceiling, 132 SMs x 4 schedulers x 32 lanes x
  1.98 GHz. The SM count and the four schedulers, each issuing one warp
  instruction a clock, are the Hopper architecture whitepaper's; 1.98 GHz
  is the SXM5 part's boost clock. NVIDIA publishes no integer peak: this
  is half the data sheet's 67 TFLOP/s FP32 figure, which counts an FMA
  as two flops.
- ALU_OPS_PER_S: the 64 INT32 lanes an SM has (the whitepaper's) at the
  same clock, the pipe that funnel shifts and logic (LOP3) issue on.
The run records the card's name, SM clock and power limit beside the
shares it reports.
"""

from __future__ import annotations

import numpy as np

MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
ALU_OPS_PER_S = 132 * 64 * 1.98e9

# the fewest 32-bit instructions a unit of work takes
OPS_SHOUP_MUL = 3  # w * x - umulhi(ws, x) * p: umulhi and two IMADs, in [0, 2p)
OPS_REDUCE = 2  # [0, 2p) -> [0, p): a subtract and an unsigned min
OPS_SHOUP_BUTTERFLY = OPS_SHOUP_MUL + 2 * OPS_REDUCE + 2  # lazy Shoup DIT/DIF butterfly
# SHA-256 by pipe: (ALU-only logic, rotates, shifts, adds). A round is four
# LOP3, six rotates and four adds; a schedule word two LOP3, four rotates,
# two shifts and two adds; a compression's feed-forward eight adds; a
# TapBranch node sorts its two digests (24) and compresses them and the
# constant padding block.
SHA_ROUND, SHA_SCHEDULE = np.array([4, 6, 0, 4]), np.array([2, 4, 2, 2])
SHA_FEED_FORWARD, SHA_SORT = np.array([0, 0, 0, 8]), np.array([24, 0, 0, 0])
SHA_COMPRESS = 64 * SHA_ROUND + 48 * SHA_SCHEDULE + SHA_FEED_FORWARD
SHA_TAPBRANCH = SHA_SORT + SHA_COMPRESS + 64 * SHA_ROUND + SHA_FEED_FORWARD


def bound(ops: float, nbytes: float) -> tuple[float, str, dict]:
    """(ms, what bounds it, both times in ms)."""
    times = {"bytes": 1e3 * nbytes / MEM_BYTES_PER_S, "operations": 1e3 * ops / INT32_OPS_PER_S}
    by = max(times, key=times.get)
    return times[by], by, times


def alu_pipe_least(alu: float, rotates: float, shifts: float, adds: float) -> float:
    """The fewest instructions the ALU pipe must issue over every split of
    rotates, shifts and adds between the ALU and FMA pipes (a rotate moved
    to the FMA pipe costs it two)."""
    fixed, free = alu + rotates, shifts + adds
    if fixed <= free:
        return (fixed + free) / 2
    return fixed - min(rotates, (fixed - free) / 3)


def sha_bound(compressions: float, nodes: float, nbytes: float) -> tuple[float, str, dict]:
    """SHA-256 work: the larger of the bytes, all instructions at the issue
    rate and the ALU pipe's share at its rate."""
    work = [float(x) for x in compressions * SHA_COMPRESS + nodes * SHA_TAPBRANCH]
    times = {"bytes": 1e3 * nbytes / MEM_BYTES_PER_S, "operations": 1e3 * sum(work) / INT32_OPS_PER_S,
             "alu pipe": 1e3 * alu_pipe_least(*work) / ALU_OPS_PER_S}
    by = max(times, key=times.get)
    return times[by], "bytes" if by == "bytes" else "operations", times


def subtree_nodes(m: int, levels: int, write_first: int) -> tuple[int, int]:
    """(TapBranch nodes, nodes written) of `levels` levels over m nodes."""
    return (sum(m >> level for level in range(1, levels + 1)),
            sum(m >> level for level in range(write_first, levels + 1)))


def leaf_bound(r: int, n: int, nb: int, levels: int) -> tuple[float, str, dict]:
    """R x N leaves of nb compressions and the nodes of `levels` levels above."""
    nodes, written = subtree_nodes(r * n, levels, levels)
    return sha_bound(r * n * nb, nodes, 4 * (16 * nb * n + 16 * nb * r + 8 * r) + 32 * written)


def levels_bound(r: int, n: int, levels: int, write_first: int) -> tuple[float, str, dict]:
    nodes, written = subtree_nodes(r * n, levels, write_first)
    return sha_bound(0, nodes, 32 * (r * n + written))


def lde_bounds(log_n: int, w: int, log_blowup: int) -> dict:
    """A coset LDE of (n, w): an n-point inverse transform per column with
    1/n, then blowup n-point forward transforms per column with the
    shift, each element made canonical once; inputs read once, outputs and
    tables written or read once."""
    n, blow = 1 << log_n, 1 << log_blowup
    per_transform = n // 2 * log_n * OPS_SHOUP_BUTTERFLY + n * (OPS_SHOUP_MUL + OPS_REDUCE)
    return {
        "lde_inverse": bound(w * per_transform, 4 * (2 * n * w + n // 2)),
        "lde_forward": bound(blow * w * per_transform, 4 * (n * w + blow * n + n // 2 + blow * n * w)),
    }


def lde_least_ms(log_n: int, w: int, log_blowup: int) -> float:
    return sum(t for t, _, _ in lde_bounds(log_n, w, log_blowup).values())


def first_bound(log_n: int, w: int, log_blowup: int) -> tuple[float, str, dict]:
    log_c = log_n // 2
    log_r, h = log_n - log_c, (log_n + 1) // 2
    r, c, blow = 1 << log_r, 1 << log_c, 1 << log_blowup
    lanes = c * blow * w
    ops = r // 2 * log_r * lanes * OPS_SHOUP_BUTTERFLY + r * lanes * (2 * OPS_SHOUP_MUL + OPS_REDUCE)
    nbytes = 4 * (r * c * w + r * lanes) + 8 * (r - 1 + blow * (r + c)) + 4 * ((1 << h) + (1 << (log_n - h)))
    return bound(ops, nbytes)


def last_bound(log_n: int, w: int) -> tuple[float, str, dict]:
    log_c = log_n // 2
    h = (log_n + 1) // 2
    n, c = 1 << log_n, 1 << log_c
    ops = n // 2 * log_c * w * OPS_SHOUP_BUTTERFLY + n * w * (OPS_SHOUP_MUL + OPS_REDUCE)
    nbytes = 4 * 2 * n * w + 8 * (c - 1) + 4 * ((1 << h) + (1 << (log_n - h)))
    return bound(ops, nbytes)


def cols_bound(log_r: int, b: int) -> tuple[float, str, dict]:
    r = 1 << log_r
    return bound(r // 2 * log_r * b * OPS_SHOUP_BUTTERFLY + r * b * OPS_REDUCE, 8 * r * b)


def commit_least_ms(leaves: int, reps: int, shards: list[tuple[int, int]]) -> float:
    """A taptree commit of `leaves` leaves per repetition and shard, shards
    given as (values, limbs): every leaf's suffix blocks after its shard's
    constant prefix and every TapBranch node, the leaf values read once and
    the roots written once."""
    from ..reference.script import suffix_blocks

    total = 0.0
    for values, limbs in shards:
        nb = suffix_blocks(values, limbs)
        total += sha_bound(reps * leaves * nb, reps * (leaves - 1), 4 * leaves * values * limbs + 32 * reps)[0]
    return total
