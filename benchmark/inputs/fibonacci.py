"""Fibonacci statements: row i of a trace is (x_i, x_(i+1)), x_0 = a,
x_1 = b, so x_i = a F(i - 1) + b F(i) mod p over one Fibonacci sequence F
computed once; (a, b) is drawn per statement. Public values (a, b, x_n)."""

from __future__ import annotations

import numpy as np
import torch

P = 2013265921


def port_air():
    from tapstark_torch.airs import FibonacciAir

    return FibonacciAir()


def fibonacci_mod_p(count: int, device) -> torch.Tensor:
    """F(-1), F(0), ..., F(count - 2) mod p: a short prefix by the
    recurrence, then blocks by F(a + j) = F(a) F(j + 1) + F(a - 1) F(j)."""
    prefix = [1, 0]
    while len(prefix) < min(count, 64):
        prefix.append((prefix[-1] + prefix[-2]) % P)
    f = torch.zeros(count, dtype=torch.int64, device=device)  # f[k] = F(k - 1)
    f[: len(prefix)] = torch.tensor(prefix[:count], dtype=torch.int64)
    known = len(prefix)
    while known < count:
        take = min(known - 3, count - known)  # F(known - 1 + j), j = 1 .. take
        j = torch.arange(1, 1 + take, device=device)
        f[known : known + take] = (f[known - 1] * f[j + 2] + f[known - 2] * f[j + 1]) % P
        known += take
    return f


def statements(log_n: int, count: int, rng: np.random.Generator, device):
    n = 1 << log_n
    f = fibonacci_mod_p(n + 2, device)  # F(-1) .. F(n)
    out = []
    for a, b in rng.integers(0, P, (count, 2)).tolist():
        xs = (a * f[:-1] + b * f[1:]) % P  # x_0 .. x_n
        trace = torch.stack([xs[:-1], xs[1:]], dim=1).to(torch.int32).cpu().numpy().view(np.uint32)
        out.append((trace, [a, b, int(xs[-1])]))
    return out
