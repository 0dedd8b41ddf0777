"""The harness's whole run on the CPU at small sizes, the card's look left
out, for each cell of ``BENCHMARK.json`` at the size its settings' ``small``
block gives: a sound float64 run is correct; the control (the program in
float32) and each fault planted in the timed path are not.

Readings of sound runs here (seed 123456789012): heat 1-D on 32 points, L
1.1e-12, E_sqrtm 4.0e-11, init_gram 2.5e-9, mean 2.4e-9, gram 1.9e-7,
diffusion 9.1e-9, calibrated 1.4e-10; adaptive, times 6.3e-10, attempts 0;
heat 2-D on 8 x 8, init_gram 1.4e-8 and the rest below 1e-11. The float32
control reads L 7.4e-4, E_sqrtm 2.5e-2, u 1.9e-5 and the gram above 10.
"""

import pytest
import torch

from conftest import cells, small_cell
from harness import faults, runner

SEED = 123456789012
CELLS = cells()


def run(name, **kwargs):
    result, table = runner.run(small_cell(name), SEED, 0.05, device="cpu", **kwargs)
    return result, table


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, table = run(name)
    failing = {k: v for k, v in table.items() if not v["value"] <= v["limit"]}
    assert result["correct"], failing
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) >= {"steps_per_s", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_control_in_float32_is_not_correct(name):
    result, table = run(name, dtype="float32")
    assert not result["correct"]
    assert any(v["limit"] and v["value"] >= 1e3 * v["limit"] for v in table.values()), table


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    result, _ = run(name, fault=fault)
    assert not result["correct"]


def test_run_exits_without_a_card(tmp_path):
    import subprocess
    import sys

    from conftest import BENCH, ROOT

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is here")
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                           "heat1d-n512.const", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
