"""The exchanges between a mesh's shards (in the JAX package XLA inserts
them: `all_to_all`, the sharding of inputs and outputs, the collective
permute of the next row).

Every exchange is a set of block copies, each written straight into a
tensor on the receiving shard's device (`dst.copy_(src)`). Between two
cards PyTorch orders such a copy itself: the sending device's current
stream waits for the receiver's, copies (peer to peer where the cards
allow it), and the receiver's current stream waits for the copy. So a
shard's later kernels see the block, and the host never synchronizes.

`counts` tallies what the wrappers did since the last reset, as the
kernel wrappers count launches: "exchanges" (calls), "copies" (blocks
that went from one shard to another) and "bytes" (their bytes). A block
counts when it changes shard, also when both shards lie on one device.
"""

from __future__ import annotations

import torch

counts = {"exchanges": 0, "copies": 0, "bytes": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _send(dst: torch.Tensor, src: torch.Tensor, crosses: bool) -> None:
    dst.copy_(src)
    if crosses:
        counts["copies"] += 1
        counts["bytes"] += src.numel() * src.element_size()


def scatter(mesh, x: torch.Tensor, dim: int) -> list[torch.Tensor]:
    """x (on the primary device) cut into mesh.size equal blocks along
    `dim`: block d, contiguous, on shard d's device."""
    counts["exchanges"] += 1
    k = x.shape[dim] // mesh.size
    if k * mesh.size != x.shape[dim]:
        raise ValueError(f"scatter: {x.shape[dim]} along dim {dim} does not split over {mesh.size} shards")
    out = []
    for d, dev in enumerate(mesh.devices):
        part = x.narrow(dim, d * k, k)
        blk = torch.empty(part.shape, dtype=x.dtype, device=dev)
        _send(blk, part, d != 0)
        out.append(blk)
    return out


def gather(mesh, blocks: list[torch.Tensor], dim: int) -> torch.Tensor:
    """The shards' blocks joined along `dim` on the primary device (block
    d at position d)."""
    counts["exchanges"] += 1
    k = blocks[0].shape[dim]
    shape = list(blocks[0].shape)
    shape[dim] = k * len(blocks)
    out = torch.empty(shape, dtype=blocks[0].dtype, device=mesh.primary)
    for d, blk in enumerate(blocks):
        _send(out.narrow(dim, d * k, k), blk, d != 0)
    return out


def all_to_all(mesh, blocks: list[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """Every shard cuts its block into mesh.size equal parts along `dim`;
    part e of shard d goes to shard e. Shard e receives a (mesh.size,
    *part) tensor whose entry d is shard d's part e."""
    counts["exchanges"] += 1
    num = mesh.size
    k = blocks[0].shape[dim] // num
    if k * num != blocks[0].shape[dim]:
        raise ValueError(f"all_to_all: {blocks[0].shape[dim]} along dim {dim} does not split over {num} shards")
    out = []
    for e, dev in enumerate(mesh.devices):
        part_shape = list(blocks[0].shape)
        part_shape[dim] = k
        recv = torch.empty((num, *part_shape), dtype=blocks[0].dtype, device=dev)
        for d, blk in enumerate(blocks):
            _send(recv[d], blk.narrow(dim, e * k, k), d != e)
        out.append(recv)
    return out


def halo(mesh, blocks: list[torch.Tensor], rows: int) -> list[torch.Tensor]:
    """For every shard d, the first `rows` rows of shard d + 1's block
    (shard 0's for the last shard), on shard d's device."""
    counts["exchanges"] += 1
    out = []
    for d, dev in enumerate(mesh.devices):
        e = (d + 1) % mesh.size
        src = blocks[e][:rows]
        if src.shape[0] != rows:
            raise ValueError(f"halo: shard {e} holds {src.shape[0]} rows, fewer than {rows}")
        h = torch.empty(src.shape, dtype=src.dtype, device=dev)
        _send(h, src, d != e)
        out.append(h)
    return out
