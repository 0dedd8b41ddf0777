"""The benchmark loads nothing of JAX or of the JAX package, and its
reference imports nothing of the program under test."""

import ast
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pnmol_tpu"}


def _roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    assert not _roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    text = path.read_text()
    assert not _roots(path) & {"pnmol_tpu_torch", "harness"}
    assert "pnmol_tpu_torch" not in text


def test_loaded_modules_after_import():
    code = (
        "import sys, pathlib\n"
        f"sys.path.insert(0, {str(BENCH)!r}); sys.path.append({str(ROOT)!r})\n"
        "import run\n"
        "from harness import compare, inputs, manifest, runner, system, trace\n"
        "import reference.discretization, reference.filter, reference.prior, roofline\n"
        "for m in manifest.manifest()['end_to_end'] + manifest.manifest()['per_layer']:\n"
        "    manifest.reader(m['name'])\n"
        "system.import_port('float64')\n"
        "print(','.join(run.forbidden_modules()))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def test_forbidden_names_compare_the_whole_top_level_name(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "pnmol_tpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jax_lookalike.sub", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax.numpy"]
