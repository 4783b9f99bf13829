"""The sharded prover step (twin of `tapstark/mesh/prover_step.py`): one
step of the prover's device work over a mesh, the multichip dry run's
(`dryrun.py`).

- the coset LDE over the mesh (`ntt.coset_lde_shards`), then one
  `all_to_all` that leaves each shard a contiguous block of the LDE's
  rows, and the halo: the next_step rows after the block, from the next
  shard (the JAX package's collective permute of the next row);
- the constraint quotient of each shard's rows: the AIR's generated
  segments on the shard's window of the coset (`air/program.py
  quotient_window`) on the card, the eager folder over the window on the
  CPU;
- one FRI fold of each shard's rows (`poly/fold.py fold_matrix` with the
  shard's row offset into the g^-1 powers);
- a PoW grind batch: each shard checks its slice of the candidate words
  (`hashes/blake3.compress_batch`, the challenger's observe of one word:
  block [w, 0 × 15], block_len 4, the capacity as chaining value), and
  the winner is the smallest passing global index, or 0 if none passes
  (the JAX package's argmax).

The outputs are gathered onto the mesh's primary device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..air.program import quotient_window
from ..field.constants import P
from ..field.device import fetch_canonical, np_to_mont
from ..field.scalar import EF4, F
from ..hashes.blake3 import compress_batch
from ..poly.domain import TwoAdicMultiplicativeCoset
from ..poly.fold import fold_matrix
from ..utils import log2_strict
from . import collectives
from .ntt import coset_lde_shards, split

GRIND_BATCH = 128  # candidate words a shard checks (tapstark/mesh/prover_step.py:115)


def make_sharded_prover_step(mesh, air, log_n: int = 6, log_blowup: int = 1, grind_bits: int = 8):
    """Returns (step, example_args). The step takes (trace (n, width),
    alpha (4,), beta (4,), grind_ws (num·128,), capacity (8,)), the field
    words in Montgomery form, on the mesh's primary device, and returns
    (lde (N, width), quotient (N, 4), folded (N/2, 4), winner) there, N =
    n·2^log_blowup. The example args are the JAX package's: the same
    draws of `np.random.default_rng(0)`."""
    n = 1 << log_n
    big = n << log_blowup
    width = air.width()
    num = mesh.size
    rows = big // num  # each shard's block of LDE rows
    next_step = 1 << log_blowup
    split(log_n, num)  # both transforms' splits: raise here if the mesh is too large
    split(log_n + log_blowup, num)
    if rows < max(next_step, 2):
        raise ValueError(f"make_sharded_prover_step: {rows} rows a shard, fewer than the next row's {next_step}")

    shift = F.generator().v
    trace_domain = TwoAdicMultiplicativeCoset(log_n, 1)
    coset = TwoAdicMultiplicativeCoset(log_n + log_blowup, shift)
    public_values = [F(0), F(1), F(0)]
    none = 1 << 62  # no passing word

    def step(trace, alpha4, beta4, grind_ws, capacity):
        ys, _ = coset_lde_shards(mesh, trace, log_blowup, shift)
        # shard s takes the rows k = k2·R + k1 with k2 in its C/num: from each
        # shard e the k1 in e's R/num
        recv = collectives.all_to_all(mesh, ys, 0)  # shard s: (num, C/num, R/num, width)
        blocks = [r.permute(1, 0, 2, 3).reshape(rows, width) for r in recv]
        halos = collectives.halo(mesh, blocks, next_step)
        alpha = EF4(tuple(int(v) for v in fetch_canonical(alpha4)))
        cv = [int(v) & 0xFFFFFFFF for v in capacity.tolist()]
        ws = collectives.scatter(mesh, grind_ws, 0)
        quotients, folded, firsts = [], [], []
        for s, (blk, h) in enumerate(zip(blocks, halos)):
            dev = blk.device
            tq = torch.cat([blk, h]).t().contiguous().t()  # (rows + next_step, width), by columns
            q = quotient_window(air, public_values, trace_domain, coset, tq, alpha, s * rows, rows)
            quotients.append(q)
            folded.append(fold_matrix(beta4.to(dev), q.reshape(rows // 2, 2, 4), s * rows // 2,
                                      log2_strict(big // 2)))
            w = ws[s].to(torch.int64) & 0xFFFFFFFF
            out = compress_batch([w] + [w * 0] * 15, block_len=4, cv=cv)
            ok = (out[7] >> (32 - grind_bits)) == 0
            index = torch.arange(w.shape[0], dtype=torch.int64, device=dev) + s * w.shape[0]
            firsts.append(torch.where(ok, index, none).min().reshape(1))
        first = collectives.gather(mesh, firsts, 0).min()
        winner = torch.where(first == none, 0, first)
        return (collectives.gather(mesh, blocks, 0), collectives.gather(mesh, quotients, 0),
                collectives.gather(mesh, folded, 0), winner)

    rng = np.random.default_rng(0)
    dev = mesh.primary

    def words(*shape):
        return torch.from_numpy(np_to_mont(rng.integers(0, P, shape).astype(np.uint32)).view(np.int32)).to(dev)

    trace = words(n, width)
    alpha4 = words(4)
    beta4 = words(4)
    grind_ws = torch.arange(num * GRIND_BATCH, dtype=torch.int32, device=dev)
    capacity = torch.arange(8, dtype=torch.int32, device=dev)
    return step, (trace, alpha4, beta4, grind_ws, capacity)
