from .fibonacci import FibonacciAir, generate_fibonacci_trace
from .mul import MulAir, generate_mul_trace
from .recursion import RecursionAir, generate_recursion_trace
from .wide import WideAir, generate_wide_trace

__all__ = [
    "FibonacciAir",
    "generate_fibonacci_trace",
    "MulAir",
    "generate_mul_trace",
    "WideAir",
    "generate_wide_trace",
    "RecursionAir",
    "generate_recursion_trace",
]
