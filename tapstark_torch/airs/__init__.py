from .fibonacci import FibonacciAir, generate_fibonacci_trace
from .mul import MulAir, generate_mul_trace

__all__ = [
    "FibonacciAir",
    "generate_fibonacci_trace",
    "MulAir",
    "generate_mul_trace",
]
