"""Puts the benchmark's folder and the checkout's root on the path, and
builds small cells that the harness drives on the CPU."""

import copy
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
if str(ROOT) not in sys.path:
    sys.path.append(str(ROOT))

from harness import manifest  # noqa: E402

# a sound float64 run on the CPU at these sizes reads each number at least
# ten times below these limits (the readings are in the module docstrings of
# the tests that use them); float32 and the planted faults read far above
SMALL_LIMITS = {"mesh": 0.0, "stencils": 0.0, "boundary": 0.0, "L": 1e-9, "E_sqrtm": 1e-8,
                "init_u": 1e-11, "init_mean": 1e-9, "init_gram": 1e-6, "u": 1e-10,
                "mean": 1e-7, "gram": 1e-5, "diffusion": 1e-6, "calibrated": 1e-7,
                "times": 1e-7, "attempts": 0.0}
SMALL_POINTS = {"heat1d-n512.const": [32], "heat1d-n512.adaptive": [32],
                "heat2d-n1e4.const": [8, 8]}


def small_cell(name):
    """The cell ``name`` at a CPU test's size: its grid cut to
    ``SMALL_POINTS``, two window steps at most before the checked one, and
    ``SMALL_LIMITS`` for the numbers the cell has limits for."""
    cell = manifest.Cell.load(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["problem"]["num_points"] = SMALL_POINTS[name]
    limits = {name: SMALL_LIMITS[name] for name in cell.settings["limits"]}
    cell.settings = dict(cell.settings, window_check_max=2, limits=limits)
    return cell


@pytest.fixture
def cuda_device():
    """Skip unless a CUDA device is here (decided inside the test run)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "`python -m pytest benchmark/tests -m cuda`")
    return "cuda"
