"""The benchmark's seeded statement generators make the port's traces."""

import numpy as np
import pytest

from benchmark.inputs import fibonacci, recursion
from tapstark_torch.airs import generate_fibonacci_trace, generate_recursion_trace


@pytest.mark.parametrize("log_n", [3, 8, 11])
def test_fibonacci_statements_equal_the_ports(log_n):
    got = fibonacci.statements(log_n, 3, np.random.default_rng(2**31 + 3), "cpu")
    draws = np.random.default_rng(2**31 + 3).integers(0, fibonacci.P, (3, 2)).tolist()
    assert len({tr.tobytes() for tr, _ in got}) == 3
    for (trace, pis), (a, b) in zip(got, draws):
        want = generate_fibonacci_trace(a, b, 1 << log_n)
        assert trace.dtype == np.uint32 and (trace == want).all()
        assert pis == [a, b, int(want[-1, 1])]


@pytest.mark.parametrize("log_n", [3, 9])
def test_recursion_statements_equal_the_ports(log_n):
    got = recursion.statements(log_n, 3, np.random.default_rng(12345), "cpu")
    rng = np.random.default_rng(12345)
    seeds = rng.integers(0, 1 << 62, 3).tolist()
    x0 = rng.integers(0, 1 << 32, 3, dtype=np.uint64)
    y0 = rng.integers(0, 1 << 32, 3, dtype=np.uint64)
    for (trace, pis), s, x, y in zip(got, seeds, x0, y0):
        want, want_pis = generate_recursion_trace(1 << log_n, seed=s, x0=int(x), y0=int(y))
        assert (trace == want).all() and pis == want_pis
