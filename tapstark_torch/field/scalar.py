"""Host-side exact field arithmetic: BabyBear `F` and quartic extension `EF4`.

Used for everything that is per-scalar on the host: the Fiat-Shamir
challenger, domain algebra, the native verifier, twiddle precomputation.
Exact Python-int arithmetic; the device kernels (field.device) are tested
against these.

Reference parity: p3-baby-bear / p3-field BinomialExtensionField<BabyBear,4>
(canonical-u32 semantics as used by tap-stark's common/src/lib.rs:20-27).
"""

from __future__ import annotations

from .constants import EXT_W, MULT_GENERATOR, P, ROOT4, two_adic_generator


class F:
    """BabyBear element; canonical value in [0, P)."""

    __slots__ = ("v",)

    def __init__(self, v: int):
        # int() guards against numpy scalars silently overflowing int64.
        self.v = int(v) % P

    # -- constructors ------------------------------------------------------
    @staticmethod
    def zero() -> "F":
        return F(0)

    @staticmethod
    def one() -> "F":
        return F(1)

    @staticmethod
    def two() -> "F":
        return F(2)

    @staticmethod
    def generator() -> "F":
        return F(MULT_GENERATOR)

    @staticmethod
    def two_adic_generator(bits: int) -> "F":
        return F(two_adic_generator(bits))

    @staticmethod
    def from_wrapped_u32(v: int) -> "F":
        return F(v % P)

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, int):
            o = F(o)
        if isinstance(o, EF4):
            return o.__radd__(self)
        return F(self.v + o.v)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, int):
            o = F(o)
        if isinstance(o, EF4):
            return EF4.from_base(self) - o
        return F(self.v - o.v)

    def __rsub__(self, o):
        if isinstance(o, int):
            o = F(o)
        return o - self

    def __neg__(self) -> "F":
        return F(-self.v)

    def __mul__(self, o):
        if isinstance(o, int):
            o = F(o)
        if isinstance(o, EF4):
            return o.__rmul__(self)
        return F(self.v * o.v)

    __rmul__ = __mul__

    def __truediv__(self, o: "F") -> "F":
        return self * o.inverse()

    def inverse(self) -> "F":
        if self.v == 0:
            raise ZeroDivisionError("inverse of zero")
        return F(pow(self.v, P - 2, P))

    def exp(self, e: int) -> "F":
        return F(pow(self.v, e, P))

    def exp_power_of_2(self, k: int) -> "F":
        return F(pow(self.v, 1 << k, P))

    def is_zero(self) -> bool:
        return self.v == 0

    # -- misc --------------------------------------------------------------
    def as_canonical_u32(self) -> int:
        return self.v

    def as_u32_vec(self) -> list[int]:
        """Canonical u32-limb view (reference AsU32Vec, common/src/lib.rs:48)."""
        return [self.v]

    def __eq__(self, o) -> bool:
        return isinstance(o, F) and self.v == o.v

    def __hash__(self):
        return hash(("F", self.v))

    def __repr__(self):
        return f"F({self.v})"


class EF4:
    """Quartic binomial extension BabyBear[x]/(x^4 - 11); coeffs canonical ints."""

    __slots__ = ("c",)

    D = 4

    def __init__(self, c):
        assert len(c) == 4
        self.c = tuple(int(x) % P for x in c)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def zero() -> "EF4":
        return EF4((0, 0, 0, 0))

    @staticmethod
    def one() -> "EF4":
        return EF4((1, 0, 0, 0))

    @staticmethod
    def from_base(b: F) -> "EF4":
        return EF4((b.v, 0, 0, 0))

    @staticmethod
    def from_base_slice(bs) -> "EF4":
        return EF4(tuple(b.v for b in bs))

    @staticmethod
    def monomial(i: int) -> "EF4":
        c = [0, 0, 0, 0]
        c[i] = 1
        return EF4(c)

    @staticmethod
    def two_adic_generator(bits: int) -> "EF4":
        # Embedded base-field root; matches Plonky3's ext_two_adic_generator
        # for bits <= 27 (the only range this protocol exercises).
        return EF4((two_adic_generator(bits), 0, 0, 0))

    # -- arithmetic --------------------------------------------------------
    def _coerce(self, o):
        if isinstance(o, EF4):
            return o
        if isinstance(o, int):
            o = F(o)
        if isinstance(o, F):
            return EF4((o.v, 0, 0, 0))
        return NotImplemented

    def __add__(self, o):
        o = self._coerce(o)
        if o is NotImplemented:
            return o
        a, b = self.c, o.c
        return EF4((a[0] + b[0], a[1] + b[1], a[2] + b[2], a[3] + b[3]))

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        if o is NotImplemented:
            return o
        a, b = self.c, o.c
        return EF4((a[0] - b[0], a[1] - b[1], a[2] - b[2], a[3] - b[3]))

    def __rsub__(self, o):
        return self._coerce(o) - self

    def __neg__(self) -> "EF4":
        a = self.c
        return EF4((-a[0], -a[1], -a[2], -a[3]))

    def __mul__(self, o):
        o = self._coerce(o)
        if o is NotImplemented:
            return o
        a, b = self.c, o.c
        w = EXT_W
        c0 = a[0] * b[0] + w * (a[1] * b[3] + a[2] * b[2] + a[3] * b[1])
        c1 = a[0] * b[1] + a[1] * b[0] + w * (a[2] * b[3] + a[3] * b[2])
        c2 = a[0] * b[2] + a[1] * b[1] + a[2] * b[0] + w * (a[3] * b[3])
        c3 = a[0] * b[3] + a[1] * b[2] + a[2] * b[1] + a[3] * b[0]
        return EF4((c0, c1, c2, c3))

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = self._coerce(o)
        return self * o.inverse()

    def conjugate(self, k: int) -> "EF4":
        """Galois conjugate: x -> ROOT4^k * x."""
        a = self.c
        r = pow(ROOT4, k, P)
        return EF4((a[0], a[1] * r, a[2] * r * r % P, a[3] * pow(r, 3, P)))

    def inverse(self) -> "EF4":
        # inv(a) = sigma1(a)*sigma2(a)*sigma3(a) / N where N = a * (that product)
        # is in the base field.
        prod = self.conjugate(1) * self.conjugate(2) * self.conjugate(3)
        n = (self * prod).c
        assert n[1] == 0 and n[2] == 0 and n[3] == 0, "norm not in base field"
        if n[0] == 0:
            raise ZeroDivisionError("inverse of zero")
        ninv = pow(n[0], P - 2, P)
        return EF4(tuple(x * ninv for x in prod.c))

    def exp(self, e: int) -> "EF4":
        acc = EF4.one()
        base = self
        while e:
            if e & 1:
                acc = acc * base
            base = base * base
            e >>= 1
        return acc

    def exp_power_of_2(self, k: int) -> "EF4":
        acc = self
        for _ in range(k):
            acc = acc * acc
        return acc

    def is_zero(self) -> bool:
        return all(x == 0 for x in self.c)

    # -- misc --------------------------------------------------------------
    def as_base_slice(self) -> list[F]:
        return [F(x) for x in self.c]

    def as_u32_vec(self) -> list[int]:
        """Canonical u32-limb view (reference common/src/lib.rs:58-63)."""
        return list(self.c)

    def as_usize(self) -> int:
        """BitExtractor semantics: first base coefficient
        (reference basic/src/challenger/mod.rs:326-333)."""
        return self.c[0]

    def __eq__(self, o) -> bool:
        if isinstance(o, F):
            o = EF4((o.v, 0, 0, 0))
        return isinstance(o, EF4) and self.c == o.c

    def __hash__(self):
        return hash(("EF4", self.c))

    def __repr__(self):
        return f"EF4{self.c}"


def batch_inverse_scalar(xs):
    """Montgomery batch inversion for host scalars (F or EF4)."""
    if not xs:
        return []
    prefix = [xs[0]]
    for x in xs[1:]:
        prefix.append(prefix[-1] * x)
    inv = prefix[-1].inverse()
    out = [None] * len(xs)
    for i in range(len(xs) - 1, 0, -1):
        out[i] = prefix[i - 1] * inv
        inv = inv * xs[i]
    out[0] = inv
    return out
