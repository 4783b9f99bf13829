"""BabyBear / EF4 arithmetic on torch tensors (the port's twin of
`tapstark.field.device`).

Representation: every tensor holds field elements in **Montgomery form**
(x·R mod p, R = 2^32) as `torch.int32`, word for word the uint32 arrays of
the JAX package (values are < p = 0x78000001 < 2^31, so they fit). The
eager math runs in `int64`: a 31×31-bit product fits, and so does the
REDC sum when it is split into high halves (see `_redc`). The CUDA kernels
read the same storage as `uint32`. Extension elements are (..., 4).

Every operation returns int32 in [0, p); inputs may be int32 or int64
tensors of values in [0, p), or Python ints.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.constants import EXT_W, MU, P, R2_MOD_P, R_MOD_P, ROOT4

_M32 = 0xFFFFFFFF

MONT_ONE = R_MOD_P
MONT_HALF = (pow(2, P - 2, P) * R_MOD_P) % P


def _wide(x):
    return x if isinstance(x, int) else x.to(torch.int64)


def _narrow(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _redc(t: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of int64 t in [0, p·2^32) → t·R^{-1} mod p.

    m = lo·MU mod 2^32 (the int64 product wraps, its low word is exact);
    t + m·p ≡ 0 mod 2^32, so the low words sum to 0 (lo = 0) or to 2^32,
    and (t + m·p) >> 32 = hi(t) + hi(m·p) + (lo != 0), which never
    leaves int64 (m·p < 2^63)."""
    lo = t & _M32
    m = (lo * MU) & _M32
    u = (t >> 32) + ((m * P) >> 32) + (lo != 0).to(torch.int64)
    return torch.where(u >= P, u - P, u)


def _mod(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x, P)


# ---------------------------------------------------------------------------
# Base field
# ---------------------------------------------------------------------------


def fp_add(a, b):
    s = _wide(a) + _wide(b)
    return _narrow(torch.where(s >= P, s - P, s))


def fp_sub(a, b):
    d = _wide(a) - _wide(b)
    return _narrow(torch.where(d < 0, d + P, d))


def fp_neg(a):
    a = _wide(a)
    return _narrow(torch.where(a == 0, a, P - a))


def fp_mul(a, b):
    return _narrow(_redc(_wide(a) * _wide(b)))


def fp_square(a):
    return fp_mul(a, a)


def fp_pow(a: torch.Tensor, e: int) -> torch.Tensor:
    """a**e for a host-known exponent (square and multiply)."""
    acc = None
    base = _wide(a)
    while e:
        if e & 1:
            acc = base if acc is None else _redc(acc * base)
        e >>= 1
        if e:
            base = _redc(base * base)
    if acc is None:
        return torch.full_like(a, MONT_ONE, dtype=torch.int32)
    return _narrow(acc)


def fp_inv(a):
    """Elementwise a^(p-2) (inverse; 0 maps to 0)."""
    return fp_pow(a, P - 2)


def to_mont(a) -> torch.Tensor:
    """Canonical values (tensor, or numpy uint32 array) → Montgomery int32."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a.astype(np.int64))
    return fp_mul(a, R2_MOD_P)


def from_mont(a) -> torch.Tensor:
    """Montgomery → canonical int32."""
    return _narrow(_redc(_wide(a)))


def fp_const(v: int) -> int:
    """Host canonical int → Montgomery word (a Python int, broadcasts)."""
    return (v % P) * R_MOD_P % P


def np_to_mont(a: np.ndarray) -> np.ndarray:
    """Host canonical → Montgomery (numpy uint32)."""
    flat = a.astype(np.uint64).reshape(-1)
    out = (flat * np.uint64(R_MOD_P)) % np.uint64(P)
    return out.astype(np.uint32).reshape(a.shape)


def np_from_mont(a: np.ndarray) -> np.ndarray:
    rinv = pow(R_MOD_P, P - 2, P)
    flat = a.astype(np.uint64).reshape(-1)
    out = (flat * np.uint64(rinv)) % np.uint64(P)
    return out.astype(np.uint32).reshape(a.shape)


def fetch_canonical(a: torch.Tensor) -> np.ndarray:
    """Montgomery tensor (any device) → canonical numpy uint32: the REDC
    runs where the tensor lives, then one copy to the host."""
    return from_mont(a).cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Quartic extension (..., 4), x^4 = W
# ---------------------------------------------------------------------------


def ef_add(a, b):
    return fp_add(a, b)


def ef_sub(a, b):
    return fp_sub(a, b)


def ef_neg(a):
    return fp_neg(a)


def _ef_mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Binomial product of int64 (..., 4) tensors → int64 (..., 4) in [0, p).
    Each partial product is REDC-reduced, so the sums stay < 2^36."""
    prod = [[_redc(a[..., i] * b[..., j]) for j in range(4)] for i in range(4)]
    c = []
    for k in range(4):
        low = sum(prod[i][k - i] for i in range(k + 1))
        high = sum(prod[i][k + 4 - i] for i in range(k + 1, 4))
        c.append(_mod(low + EXT_W * high))
    return torch.stack(c, dim=-1)


def ef_mul(a, b):
    """(..., 4) × (..., 4) binomial-extension product."""
    a, b = torch.broadcast_tensors(_wide(a), _wide(b))
    return _narrow(_ef_mul_wide(a, b))


def ef_mul_base(a, b):
    """(..., 4) ext times (...,) base, broadcast."""
    b = b if isinstance(b, int) else b[..., None]
    return fp_mul(a, b)


def ef_add_base(a, b):
    """(..., 4) ext plus (...,) base: the base element adds into
    coefficient 0."""
    out = _narrow(_wide(a)).clone()
    out[..., 0] = fp_add(out[..., 0], b)
    return out


def ef_square(a):
    return ef_mul(a, a)


def ef_pow(a: torch.Tensor, e: int) -> torch.Tensor:
    """a**e for a host-known exponent (square and multiply)."""
    acc = None
    base = _wide(a)
    while e:
        if e & 1:
            acc = base if acc is None else _ef_mul_wide(acc, base)
        e >>= 1
        if e:
            base = _ef_mul_wide(base, base)
    if acc is None:
        return ef_one_like(a)
    return _narrow(acc)


def ef_one_like(a: torch.Tensor) -> torch.Tensor:
    """The extension's one (Montgomery) in a's shape (..., 4)."""
    out = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    out[..., 0] = MONT_ONE
    return out


_ROOT4_POWS_MONT = [pow(ROOT4, k, P) * R_MOD_P % P for k in range(4)]


def ef_inv(a):
    """Inverse via the Galois conjugates: prod_conj / Norm (one base
    inversion; 0 maps to 0)."""
    a = _wide(a)

    def conj(k):
        return torch.stack(
            [_redc(a[..., j] * _ROOT4_POWS_MONT[(j * k) % 4]) for j in range(4)],
            dim=-1,
        )

    prod = _ef_mul_wide(_ef_mul_wide(conj(1), conj(2)), conj(3))
    norm = _ef_mul_wide(a, prod)[..., 0]
    ninv = _wide(fp_inv(norm))
    return _narrow(_redc(prod * ninv[..., None]))


def ef_const(ef, device) -> torch.Tensor:
    """Host EF4 scalar → (4,) Montgomery int32 tensor on `device`."""
    vals = np_to_mont(np.array(ef.as_u32_vec(), dtype=np.uint32))
    return torch.from_numpy(vals.astype(np.int32)).to(device)


def ef_from_base(a: torch.Tensor) -> torch.Tensor:
    """(...,) base → (..., 4) extension with zero high coefficients."""
    zeros = torch.zeros_like(a, dtype=torch.int32)
    return torch.stack([a.to(torch.int32), zeros, zeros, zeros], dim=-1)
