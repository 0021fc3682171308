"""The port does everything the JAX package does: every module of
`src/repro/` has a counterpart of the same path in `src/repro_torch/`, and
the public functions of the last slice's modules exist there by name."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "src", "repro")
PORT = os.path.join(ROOT, "src", "repro_torch")
LAST_SLICE = ["models/mamba.py", "parallel/pipeline.py",
              "parallel/sharding.py", "parallel/compression.py",
              "launch/mesh.py", "launch/specs.py"]


def _modules(root):
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                out.add(os.path.relpath(os.path.join(d, f), root))
    return out


def _public_functions(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}


def _names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
    return names


def test_every_reference_module_has_a_counterpart():
    ref = _modules(REF)
    assert "models/mamba.py" in ref and len(ref) > 60
    assert sorted(ref - _modules(PORT)) == []


@pytest.mark.parametrize("module", LAST_SLICE)
def test_public_functions_exist_by_name(module):
    want = _public_functions(os.path.join(REF, module))
    assert want
    assert sorted(want - _names(os.path.join(PORT, module))) == []
