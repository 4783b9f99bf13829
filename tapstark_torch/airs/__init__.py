from .blake3_compression import (
    Blake3CompressionAir,
    Blake3SpongeChainAir,
    generate_blake3_compression_trace,
    generate_blake3_sponge_trace,
)
from .blake3g import Blake3GAir, generate_blake3g_trace
from .fibonacci import FibonacciAir, generate_fibonacci_trace
from .mul import MulAir, generate_mul_trace
from .recursion import RecursionAir, generate_recursion_trace
from .wide import WideAir, generate_wide_trace

__all__ = [
    "FibonacciAir",
    "generate_fibonacci_trace",
    "MulAir",
    "generate_mul_trace",
    "Blake3GAir",
    "generate_blake3g_trace",
    "Blake3CompressionAir",
    "Blake3SpongeChainAir",
    "generate_blake3_compression_trace",
    "generate_blake3_sponge_trace",
    "WideAir",
    "generate_wide_trace",
    "RecursionAir",
    "generate_recursion_trace",
]
