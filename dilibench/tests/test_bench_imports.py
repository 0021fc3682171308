"""What the benchmark may import: nothing under `dilibench/` imports JAX or
the JAX package (`repro`, compared as a whole top-level name, since the
port's `repro_torch` begins with it); the yardstick (the reference, the
generator copies, the data, traffic, peak and comparison modules) imports
nothing of the port either."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FILES = sorted(HERE.rglob("*.py"))
YARDSTICK = ["reference.py", "data.py", "traffic.py", "peaks.py",
             "check.py", *(f"gen/{p.name}" for p in (HERE / "gen").glob("*.py"))]


def top_level_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_files_found():
    names = {p.relative_to(HERE).as_posix() for p in FILES}
    assert {"run.py", "harness.py", "reference.py"} <= names
    assert set(YARDSTICK) <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_jax_or_reference_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("rel", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port(rel):
    assert "repro_torch" not in top_level_imports(HERE / rel)


def test_checker_sees_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.api\nfrom repro.core import dili\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert top_level_imports(f) == {"repro_torch", "repro", "importlib",
                                    "jax"}
