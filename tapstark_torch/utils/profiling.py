"""Phase timing for the port's prover (the role of
`tapstark.utils.profiling`, which annotates JAX traces).

`span(name, device)` adds the wall time of its body to `name` when
profiling is on. On a CUDA device it synchronizes at the end of the body
first, so work enqueued inside the span is counted there and not in a
later one. Off (the default), a span costs one flag test.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_enabled = False


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = flag


def enabled() -> bool:
    return _enabled


def reset() -> None:
    _totals.clear()
    _counts.clear()


def report() -> dict[str, dict[str, float]]:
    return {
        name: {"total_s": _totals[name], "calls": _counts[name]} for name in sorted(_totals)
    }


@contextlib.contextmanager
def span(name: str, device=None):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    yield
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    _totals[name] += time.perf_counter() - t0
    _counts[name] += 1
