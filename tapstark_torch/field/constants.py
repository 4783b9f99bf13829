"""BabyBear field constants.

p = 15 * 2^27 + 1 = 0x78000001 (reference: tap-stark's basic/src/field/mod.rs:45).
Two-adic generator table derived from the multiplicative generator 31
(matches Plonky3's choice: the 2^27-th root of unity is 31^15 = 0x1a427a41).
The quartic extension is BabyBear[x]/(x^4 - 11) (Plonky3
BinomialExtensionField<BabyBear, 4> with W = 11).
"""

from __future__ import annotations

P = 0x78000001  # 2013265921
TWO_ADICITY = 27
MULT_GENERATOR = 31  # generator of the multiplicative group (Plonky3 parity)
EXT_W = 11  # x^4 = W binomial for the quartic extension
EXT_D = 4

# Montgomery parameters with R = 2^32.
R_MOD_P = (1 << 32) % P
R2_MOD_P = (R_MOD_P * R_MOD_P) % P
# MU = -P^{-1} mod 2^32, used in REDC: m = (lo * MU) mod 2^32.
MU = (-pow(P, -1, 1 << 32)) % (1 << 32)

# Two-adic generator table: TWO_ADIC_GENERATORS[k] has order 2^k.
_g27 = pow(MULT_GENERATOR, (P - 1) >> TWO_ADICITY, P)
assert _g27 == 0x1A427A41, hex(_g27)  # Plonky3 / risc0 canonical 2^27 root
TWO_ADIC_GENERATORS = [1] * (TWO_ADICITY + 1)
TWO_ADIC_GENERATORS[TWO_ADICITY] = _g27
for _k in range(TWO_ADICITY - 1, -1, -1):
    TWO_ADIC_GENERATORS[_k] = (
        TWO_ADIC_GENERATORS[_k + 1] * TWO_ADIC_GENERATORS[_k + 1]
    ) % P
assert TWO_ADIC_GENERATORS[1] == P - 1
assert TWO_ADIC_GENERATORS[0] == 1

# 4th root of unity (order exactly 4): used for quartic-extension conjugates.
ROOT4 = TWO_ADIC_GENERATORS[2]
assert pow(ROOT4, 2, P) == P - 1


def two_adic_generator(bits: int) -> int:
    """Canonical generator of the order-2^bits subgroup (Plonky3 parity)."""
    if not 0 <= bits <= TWO_ADICITY:
        raise ValueError(f"two-adicity only supports up to 2^{TWO_ADICITY}")
    return TWO_ADIC_GENERATORS[bits]
