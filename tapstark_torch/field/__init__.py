from .constants import EXT_D, EXT_W, MULT_GENERATOR, P, TWO_ADICITY, two_adic_generator
from .scalar import EF4, F, batch_inverse_scalar

__all__ = [
    "P",
    "EXT_W",
    "EXT_D",
    "MULT_GENERATOR",
    "TWO_ADICITY",
    "two_adic_generator",
    "F",
    "EF4",
    "batch_inverse_scalar",
]
