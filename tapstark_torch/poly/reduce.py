"""Modular sums over an axis (twin of `tapstark.poly.reduce`).

Values are < p < 2^31, so an int64 sum of up to 2^32 of them is exact; one
remainder then gives the same word as the reference's fp_add tree."""

from __future__ import annotations

import torch

from ..field.constants import P


def fp_sum_axis0(x: torch.Tensor) -> torch.Tensor:
    """Sum a (n, ...) Montgomery tensor over axis 0."""
    if x.shape[0] > 1 << 32:
        raise ValueError("fp_sum_axis0: more than 2^32 terms overflows int64")
    return torch.remainder(x.to(torch.int64).sum(dim=0), P).to(torch.int32)
