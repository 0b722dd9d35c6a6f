"""Nothing under `portbench/` imports JAX or the JAX package (top-level
module names compared whole: the port's own name begins with the JAX
package's), and the reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "audiocraft_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not FORBIDDEN & set(_top_level_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    allowed = {"math", "re", "typing", "hashlib", "numpy", "torch"}
    assert set(_top_level_imports(path)) <= allowed


def test_run_refuses_forbidden_modules(monkeypatch):
    import sys
    import run
    monkeypatch.setitem(sys.modules, "audiocraft_tpu.models", object())
    assert run.forbidden_modules() == ["audiocraft_tpu.models"]
    monkeypatch.delitem(sys.modules, "audiocraft_tpu.models")
    monkeypatch.setitem(sys.modules, "audiocraft_tpu_torch_extra", object())
    assert "audiocraft_tpu_torch_extra" not in run.forbidden_modules()
