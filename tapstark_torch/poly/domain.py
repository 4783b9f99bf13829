"""Two-adic multiplicative coset domains: host algebra and tensor
selectors (twin of `tapstark.poly.domain`).

Reference parity: p3-commit TwoAdicMultiplicativeCoset (create_disjoint_domain,
split_domains, split_evals, zp_at_point, selectors_at_point,
selectors_on_coset, next_point).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..field.constants import P
from ..field.device import MONT_ONE, fp_const, fp_inv, fp_mul, fp_pow, fp_sub
from ..field.scalar import EF4, F
from ..utils import log2_ceil, log2_strict
from .powers import geom_powers_mont_dev


@dataclass(frozen=True)
class LagrangeSelectors:
    """Unnormalized Lagrange selectors (Plonky3 convention: prover and
    verifier share the definition, so the missing 1/n cancels)."""

    is_first_row: object
    is_last_row: object
    is_transition: object
    inv_zeroifier: object


@dataclass(frozen=True)
class TwoAdicMultiplicativeCoset:
    log_n: int
    shift: int  # canonical u32

    def size(self) -> int:
        return 1 << self.log_n

    def first_point(self) -> F:
        return F(self.shift)

    def gen(self) -> F:
        return F.two_adic_generator(self.log_n)

    def next_point(self, x: EF4) -> EF4:
        return x * EF4.from_base(self.gen())

    def create_disjoint_domain(self, min_size: int) -> "TwoAdicMultiplicativeCoset":
        return TwoAdicMultiplicativeCoset(
            log_n=log2_ceil(min_size), shift=self.shift * F.generator().v % P
        )

    def split_domains(self, num_chunks: int) -> list["TwoAdicMultiplicativeCoset"]:
        log_chunks = log2_strict(num_chunks)
        g = self.gen()
        return [
            TwoAdicMultiplicativeCoset(
                log_n=self.log_n - log_chunks, shift=self.shift * g.exp(i).v % P
            )
            for i in range(num_chunks)
        ]

    def split_evals(self, num_chunks: int, evals: torch.Tensor) -> list[torch.Tensor]:
        """Vertically strided split: chunk i holds rows i, i+num_chunks, ..."""
        return [evals[i::num_chunks] for i in range(num_chunks)]

    def zp_at_point(self, point: EF4) -> EF4:
        shift_inv = F(self.shift).inverse()
        return (point * EF4.from_base(shift_inv)).exp_power_of_2(self.log_n) - EF4.one()

    def selectors_at_point(self, point: EF4) -> LagrangeSelectors:
        unshifted = point * EF4.from_base(F(self.shift).inverse())
        z_h = unshifted.exp_power_of_2(self.log_n) - EF4.one()
        sub_last = EF4.from_base(self.gen().inverse())
        return LagrangeSelectors(
            is_first_row=z_h * (unshifted - EF4.one()).inverse(),
            is_last_row=z_h * (unshifted - sub_last).inverse(),
            is_transition=unshifted - sub_last,
            inv_zeroifier=z_h.inverse(),
        )

    def selectors_on_coset(
        self, coset: "TwoAdicMultiplicativeCoset", device
    ) -> LagrangeSelectors:
        """Selectors of this (shift-1) domain over `coset`, as
        (coset.size(),) base Montgomery tensors on `device`, natural order."""
        if self.shift != 1 or self.log_n > coset.log_n:
            raise ValueError("selectors_on_coset expects the natural domain, not larger")
        xs = geom_powers_mont_dev(coset.gen().v, coset.log_n, coset.shift, device)
        zh = fp_sub(fp_pow(xs, self.size()), MONT_ONE)
        xs_minus_last = fp_sub(xs, fp_const(self.gen().inverse().v))
        return LagrangeSelectors(
            is_first_row=fp_mul(zh, fp_inv(fp_sub(xs, MONT_ONE))),
            is_last_row=fp_mul(zh, fp_inv(xs_minus_last)),
            is_transition=xs_minus_last,
            inv_zeroifier=fp_inv(zh),
        )
