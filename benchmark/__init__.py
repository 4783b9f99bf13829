"""The benchmark of tapstark_torch (see run.py)."""
