"""The harness on solver paths that no cell of ``BENCHMARK.json`` runs yet:
the white-noise EK1 in steady-state mode (the mean-only step) and the
latent-force EK1 (a state of ``2d`` columns), each on heat 1-D at 32 points,
through the runner's set-up and the ``trajectory`` mode on the CPU. Each
path's summaries have the rows of its own state, and each planted fault
reaches the step the solver binds. The check of such a cell is its own and
is not run here."""

import copy
import time

import pytest
import torch

from harness import faults, manifest, runner
from harness.modes import trajectory

SEED = 123456789014
PATHS = {
    "steady": ("LinearWhiteNoiseEK1", {"steady_state": True}, 1e-2),
    "latent": ("LinearLatentForceEK1", {}, 1e-3),
}


def _cell(path):
    """Heat 1-D on 32 points with the solver and step of ``path``."""
    solver_class, options, dt = PATHS[path]
    base = manifest.Cell.load("heat1d-n512.const")
    config = copy.deepcopy(base.config)
    config["problem"]["num_points"] = [32]
    config["solver"]["class"] = solver_class
    config["solver"]["solver_kwargs"].update(options)
    traffic = dict(base.traffic, steprule={"kind": "Constant", "dt": dt}, tmax=1e4 * dt)
    settings = {"chain_steps": 3, "window_check_max": 2, "probe_columns": 16, "probe_dt": dt}
    return manifest.Cell(f"heat1d-n32.{path}", entry=base.entry, config=config,
                         traffic=traffic, settings=settings, end_to_end=[], per_layer=[])


def _drive(path, fault=None):
    with faults.planted(fault):
        run = runner._Run(_cell(path), SEED, 0.02, False, None, "cpu", time.perf_counter())
        trajectory.drive(run)
    return run


@pytest.mark.parametrize("path", sorted(PATHS))
def test_set_up_and_chain_complete_with_the_state_s_rows(path):
    run = _drive(path)
    chain = run.program["chain"]
    assert len(chain) == run.cell.settings["chain_steps"] + 1 and run.steps >= 1
    d = 64 if path == "latent" else 32
    for summary in chain + [run.program["window"]["output"]]:
        assert summary["mean"].shape == (3, d)
        assert summary["sketch"].shape == (summary["mean"].numel(), 16)
        assert bool(torch.isfinite(summary["sketch"]).all())


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_planted_fault_changes_the_chain(path, fault):
    sound = _drive(path).program["chain"]
    broken = _drive(path, fault).program["chain"]
    assert torch.equal(sound[0]["mean"], broken[0]["mean"])  # the initial state
    assert all(not torch.equal(a["mean"], b["mean"]) for a, b in zip(sound[1:], broken[1:]))
