import sys
from pathlib import Path

# the repository root, where `benchmark` and `tapstark_torch` are packages
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
