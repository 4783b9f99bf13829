"""Part of the benchmark of tapstark_torch."""
