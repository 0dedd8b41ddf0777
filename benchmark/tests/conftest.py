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


def small_cell(name):
    """The cell ``name`` at a CPU test's size, from its settings' ``small``
    block: the grid ``num_points`` in the configuration, every other key of
    the block (the ``limits`` at that size among them) in the settings."""
    cell = manifest.Cell.load(name)
    small = dict(cell.settings["small"])
    cell.config = copy.deepcopy(cell.config)
    cell.config["problem"]["num_points"] = small.pop("num_points")
    cell.settings = dict(cell.settings, **small)
    return cell


def cells():
    """The names of the cells in ``BENCHMARK.json``."""
    return [c["name"] for c in manifest.manifest()["workloads"]]


@pytest.fixture
def cuda_device():
    """Skip unless a CUDA device is here (decided inside the test run)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "`python -m pytest benchmark/tests -m cuda`")
    return "cuda"
