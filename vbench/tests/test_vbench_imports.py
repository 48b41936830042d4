"""Nothing under vbench/ imports JAX or the JAX package, whose name the
port's begins with (top-level names compared whole); the reference imports
nothing of the program either."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


def test_names_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom reprox import y\n")
    assert top_level_imports(f) == {"repro_torch", "reprox"}


def test_reference_and_judge_import_nothing_of_the_program():
    for name in ("reference.py", "judge.py", "roofline.py", "data.py"):
        assert "repro_torch" not in top_level_imports(BENCH / name), name
