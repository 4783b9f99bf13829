"""BabyBear and its quartic extension, in plain PyTorch on canonical int64.

The plain reference of the benchmark: every value is an int64 in [0, p),
an extension value a (..., 4) tensor of coefficients of 1, X, X^2, X^3
with X^4 = W. Products of two canonical values stay below 2^62, so each
product is reduced at once. Nothing here is tuned; it is written to be
read against the field's definition.
"""

from __future__ import annotations

import torch

P = 2013265921  # 15 * 2^27 + 1
W = 11  # X^4 = W
GENERATOR = 31  # generates the multiplicative group
TWO_ADICITY = 27


def two_adic_generator(bits: int) -> int:
    """A generator of the subgroup of order 2^bits."""
    if not 0 <= bits <= TWO_ADICITY:
        raise ValueError(f"no subgroup of order 2^{bits}")
    g = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)
    return pow(g, 1 << (TWO_ADICITY - bits), P)


def inv(x: int) -> int:
    return pow(x, P - 2, P)


# -- scalar extension arithmetic (tuples of four ints) ----------------------


def e_add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def e_mul(a, b):
    c0 = a[0] * b[0] + W * (a[1] * b[3] + a[2] * b[2] + a[3] * b[1])
    c1 = a[0] * b[1] + a[1] * b[0] + W * (a[2] * b[3] + a[3] * b[2])
    c2 = a[0] * b[2] + a[1] * b[1] + a[2] * b[0] + W * a[3] * b[3]
    c3 = a[0] * b[3] + a[1] * b[2] + a[2] * b[1] + a[3] * b[0]
    return (c0 % P, c1 % P, c2 % P, c3 % P)


def e_base(x: int):
    return (x % P, 0, 0, 0)


def e_pow(a, e: int):
    acc, base = (1, 0, 0, 0), a
    while e:
        if e & 1:
            acc = e_mul(acc, base)
        base = e_mul(base, base)
        e >>= 1
    return acc


_ROOT4 = two_adic_generator(2)  # X -> ROOT4^k X are the conjugations


# -- tensors ----------------------------------------------------------------


def pow_t(a: torch.Tensor, e: int) -> torch.Tensor:
    acc = torch.ones_like(a)
    base = a.clone()
    while e:
        if e & 1:
            acc = acc * base % P
        base = base * base % P
        e >>= 1
    return acc


def inv_t(a: torch.Tensor) -> torch.Tensor:
    return pow_t(a, P - 2)


def powers(x: int, n: int, device, start: int = 1) -> torch.Tensor:
    """start * x^i for i < n, by doubling."""
    out = torch.empty(n, dtype=torch.int64, device=device)
    out[0] = start % P
    k, step = 1, x % P
    while k < n:
        m = min(k, n - k)
        out[k : k + m] = out[:m] * step % P
        step = step * step % P
        k += m
    return out


def ef_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Extension product of (..., 4) tensors (broadcasting)."""
    a0, a1, a2, a3 = a.unbind(-1)
    b0, b1, b2, b3 = b.unbind(-1)

    def dot(*pairs):
        acc = None
        for x, y in pairs:
            t = x * y % P
            acc = t if acc is None else acc + t
        return acc

    c0 = (dot((a0, b0)) + W * (dot((a1, b3), (a2, b2), (a3, b1)) % P)) % P
    c1 = (dot((a0, b1), (a1, b0)) + W * (dot((a2, b3), (a3, b2)) % P)) % P
    c2 = (dot((a0, b2), (a1, b1), (a2, b0)) + W * (a3 * b3 % P)) % P
    c3 = dot((a0, b3), (a1, b2), (a2, b1), (a3, b0)) % P
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), dim=-1)


def ef_scale(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Extension (..., 4) times base (...)."""
    return a * s.unsqueeze(-1) % P


def ef_const(v, device) -> torch.Tensor:
    return torch.tensor([int(x) % P for x in v], dtype=torch.int64, device=device)


def ef_inv_t(a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of (..., 4), through the norm."""
    r = _ROOT4
    conj = []
    for k in (1, 2, 3):
        rk = torch.tensor([pow(r, k * i, P) for i in range(4)], dtype=torch.int64, device=a.device)
        conj.append(a * rk % P)
    prod = ef_mul(ef_mul(conj[0], conj[1]), conj[2])
    norm = ef_mul(a, prod)[..., 0]
    return ef_scale(prod, inv_t(norm))


def ef_powers(z, n: int, device) -> torch.Tensor:
    """(n, 4): z^i, by doubling."""
    out = torch.zeros((n, 4), dtype=torch.int64, device=device)
    out[0, 0] = 1
    k, step = 1, tuple(z)
    while k < n:
        m = min(k, n - k)
        out[k : k + m] = ef_mul(out[:m], ef_const(step, device))
        step = e_mul(step, step)
        k += m
    return out


def bitrev(log_n: int, device) -> torch.Tensor:
    idx = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    r = torch.zeros_like(idx)
    for b in range(log_n):
        r |= ((idx >> b) & 1) << (log_n - 1 - b)
    return r


def ntt(x: torch.Tensor, root: int) -> torch.Tensor:
    """Natural-order evaluations sum_i x_i root^(i j) over the rows of (n, w)
    x, by radix-2 decimation in time."""
    n = x.shape[0]
    log_n = n.bit_length() - 1
    if n != 1 << log_n:
        raise ValueError("ntt: the height is not a power of two")
    y = x[bitrev(log_n, x.device)]
    for s in range(1, log_n + 1):
        m = 1 << s
        tw = powers(pow(root, n >> s, P), m // 2, x.device)
        y = y.view(n // m, 2, m // 2, -1)
        u, v = y[:, 0], y[:, 1] * tw[None, :, None] % P
        y = torch.stack(((u + v) % P, (u - v) % P), dim=1).reshape(n, -1)
    return y


def interpolate(evals: torch.Tensor, log_n: int) -> torch.Tensor:
    """Coefficients of the polynomials whose values on the subgroup of order
    2^log_n (natural order) are the columns of evals."""
    n = 1 << log_n
    coeffs = ntt(evals, inv(two_adic_generator(log_n)))
    return coeffs * inv(n) % P


def evaluate_coset(coeffs: torch.Tensor, log_size: int, shift: int) -> torch.Tensor:
    """Values at shift * w^j, j < 2^log_size (natural order), of the
    polynomials with these coefficient columns (zero-padded)."""
    n = coeffs.shape[0]
    size = 1 << log_size
    scaled = torch.zeros((size, coeffs.shape[1]), dtype=torch.int64, device=coeffs.device)
    scaled[:n] = coeffs * powers(shift, n, coeffs.device)[:, None] % P
    return ntt(scaled, two_adic_generator(log_size))


def eval_at(coeffs: torch.Tensor, z) -> torch.Tensor:
    """(w, 4): each coefficient column's polynomial at the extension point z."""
    n, w = coeffs.shape
    out = torch.zeros((w, 4), dtype=torch.int64, device=coeffs.device)
    rows = min(n, 1 << 16)
    zp = ef_powers(z, rows, coeffs.device)  # z^i within a block
    step = e_pow(z, rows)
    zk = (1, 0, 0, 0)
    for r0 in range(0, n, rows):
        block_zp = ef_mul(zp, ef_const(zk, coeffs.device))
        for k in range(4):
            # each product reduced below p: 2^16 of them sum below 2^47
            out[:, k] = (out[:, k] + (coeffs[r0 : r0 + rows] * block_zp[:, k : k + 1] % P).sum(0)) % P
        zk = e_mul(zk, step)
    return out
