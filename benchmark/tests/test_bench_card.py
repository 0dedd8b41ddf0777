"""Each cell's whole run on the card, a short window: the result line's
shape, and the check correct. Needs an NVIDIA GPU."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, cells
from harness import faults

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = cells()


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, trace, cuda_device):
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell,
                           "--seed", "2718281828", "--seconds", "2", "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    listed = MANIFEST["per_layer" if trace else "end_to_end"]
    assert set(line["metrics"]) == {m["name"] for m in listed
                                    if cell in m.get("workloads", [cell])}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_in_float32_is_not_correct_on_the_card(cell, cuda_device):
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell,
                           "--seed", "2718281829", "--seconds", "2", "--trace", "0",
                           "--dtype", "float32"],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert not json.loads(proc.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct_on_the_card(cell, fault, cuda_device):
    """Each fault at the cell's own size and limits (readings printed)."""
    from harness import manifest, runner

    result, table = runner.run(manifest.Cell.load(cell), 1414213562, 2.0, fault=fault)
    print(f"\n{cell} {fault}: " + ", ".join(
        f"{name} {entry['value']:.3g} (limit {entry['limit']})" for name, entry in table.items()))
    assert not result["correct"]
