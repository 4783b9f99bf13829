"""Fibonacci (uni-stark/tests/fib_air.rs:21-101): columns (a, b), public
values (a0, b0, x); rows step (a, b) -> (b, a + b), the last b is x."""

from __future__ import annotations

from ..field import P

WIDTH = 2
NUM_PUBLIC = 3
DEGREE = 2


def constraints(local, nxt, pis, sel):
    a0, b0, x = pis
    yield sel.first * ((local[0] - a0) % P) % P
    yield sel.first * ((local[1] - b0) % P) % P
    yield sel.transition * ((local[1] - nxt[0]) % P) % P
    yield sel.transition * ((local[0] + local[1] - nxt[1]) % P) % P
    yield sel.last * ((local[1] - x) % P) % P
