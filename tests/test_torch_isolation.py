"""The port stands alone: it never imports JAX or the JAX package, and
chip_smoke.py refuses to report a result without a GPU or without the
repository around it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "pnmol_tpu")
# the rank bodies that spawned test ranks import: they must load no JAX
RANK_HELPERS = (REPO / "tests" / "torch_parallel_ranks.py",)

torch.set_num_threads(1)


def _sources():
    return sorted((REPO / "pnmol_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources() + list(RANK_HELPERS),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports_in_source(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


# the modules of the adaptive, semilinear and latent-force slice, of the
# large-N slice, of the MOL baseline and calibration slice, of
# steady-state mode, of the n-D problems, of the space-sharded tier and its
# steady half, of the utilities, the figure drivers and the measurement
# drivers
SLICE_MODULES = ("odetools.step", "ops.stacked_ssm", "solvers.latent", "solvers.pdefilter",
                 "models.examples", "models.mixins", "models.problems", "discretize",
                 "native", "odetools.ek1", "odetools.init", "odetools.ivp",
                 "odetools.reference_solver", "ops.kalman", "solvers.smoothing", "ops.dare",
                 "diffops", "mesh", "interop", "parallel", "parallel.meshes",
                 "parallel.distributed", "parallel.sharded_linalg", "parallel.sharded_filter",
                 "parallel.sharded_init", "parallel.ensembles", "parallel.sharded_dare",
                 "utils", "utils.comm_model", "utils.checkpoint", "utils.configs", "utils.debug",
                 "utils.profiling", "utils.resilience", "experiments", "experiments.common",
                 "experiments.figure1", "experiments.figure2", "experiments.figure3",
                 "experiments.figure4", "experiments.plotting", "experiments.scale_demo",
                 "experiments.steady_decay_probe", "experiments.steady_error_probe",
                 "experiments.work_precision")


def test_the_slice_modules_are_checked():
    checked = {str(p.relative_to(REPO / "pnmol_tpu_torch"))[:-3].replace("/", ".")
               .removesuffix(".__init__") for p in _sources() if p.parent != REPO}
    assert set(SLICE_MODULES) <= checked


@pytest.mark.parametrize("path", sorted((REPO / "pnmol_tpu_torch" / "experiments").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_figure_drivers_keep_their_own_copies(path):
    """Nothing of the JAX package's ``experiments/`` is imported, and only
    the plotting module imports matplotlib (the card's machine has none)."""
    roots = _imported_roots(path)
    assert "experiments" not in roots
    assert ("matplotlib" in roots) == (path.name == "plotting.py")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib, pnmol_tpu_torch\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module('pnmol_tpu_torch.' + m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=300)


def test_rank_helpers_load_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO / 'tests')!r})\n"
        "import torch_parallel_ranks\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=300)


@pytest.mark.parametrize("module",
                         [m for m in SLICE_MODULES if m.startswith(("parallel", "utils"))])
def test_the_sharded_tier_picks_no_device(module):
    """The backend and the device are the caller's: the sharded tier never
    asks whether a GPU is there."""
    path = REPO / "pnmol_tpu_torch" / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = path.with_suffix("") / "__init__.py"
    assert "cuda.is_available" not in path.read_text()


# the JAX modules whose names live elsewhere in the port, each with the
# ROADMAP line that says why: ops/trisolve.py stays behind ("Not to port":
# cuSOLVER needs no blocked triangular solves); ops/pallas_gram.py is
# ops/gram.py, its jnp version the kernel's plain version
MOVED = {"ops.trisolve": None,
         "ops.pallas_gram": ("ops.gram", {"gram_fast_jnp": "gram_radial_reference"})}
# public JAX names that the port leaves out, each with what takes its place:
# the phase timer's forced completions gave way to the program's spans
# (utils.profiling.annotate and the pnmol.init.* spans of initialize)
LEFT_OUT = {"utils.profiling": {"PhaseTimer"}}


def _jax_modules():
    root = REPO / "pnmol_tpu"
    return [str(p.relative_to(root))[:-3].replace("/", ".").removesuffix("__init__")
            .removesuffix(".") for p in sorted(root.rglob("*.py"))]


def _public_names(module):
    path = REPO / "pnmol_tpu" / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = (REPO / "pnmol_tpu" / module.replace(".", "/") / "__init__.py")
    tree = ast.parse(path.read_text(), filename=str(path))
    return [node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_")]


@pytest.mark.parametrize("module", _jax_modules(), ids=lambda m: m or "pnmol_tpu")
def test_the_port_has_every_public_name_of_the_jax_package(module):
    """Every public function and class of each ``pnmol_tpu`` module has its
    counterpart, by name, in the port's module of the same name (read from
    the JAX source; JAX is not imported), but for the modules of ``MOVED``
    and the names of ``LEFT_OUT``, which the port does not have."""
    import importlib.util

    target, renamed = module, {}
    if module in MOVED:
        if MOVED[module] is None:  # left behind: no half-ported module either
            assert importlib.util.find_spec(f"pnmol_tpu_torch.{module}") is None
            return
        target, renamed = MOVED[module]
    port = importlib.import_module("pnmol_tpu_torch" + (f".{target}" if target else ""))
    left_out = LEFT_OUT.get(module, set())
    missing = [name for name in _public_names(module)
               if name not in left_out and not hasattr(port, renamed.get(name, name))]
    assert not missing, f"pnmol_tpu_torch.{target} lacks {missing}"
    assert not [name for name in left_out if hasattr(port, name)]


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_fails_without_a_gpu_or_the_repository(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the refusal without one")
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", tmp_path)
        proc = _run_smoke(cwd)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
