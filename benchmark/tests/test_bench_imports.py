"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names compared whole
(tapstark_torch begins with tapstark)."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
BLOCKED = {"jax", "jaxlib", "flax", "tapstark"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _modules(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py") if "__pycache__" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    for p in _modules():
        assert not _imports(p) & BLOCKED, p


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "torch", "numpy", "hashlib", "struct", "io", "random", "importlib", "dataclasses"}
    for p in _modules("reference"):
        names = _imports(p)
        assert "tapstark_torch" not in names and names <= allowed, (p, names - allowed)
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                depth = len(p.relative_to(BENCH / "reference").parts) - 1
                assert node.level <= depth + 1, p  # relative imports stay inside reference/


def test_the_names_compared_are_whole_top_level_names():
    from benchmark import harness
    import sys

    sys.modules["tapstark_torch_fake"] = sys
    try:
        assert "tapstark_torch_fake" not in harness.loaded_blocked()
    finally:
        del sys.modules["tapstark_torch_fake"]
