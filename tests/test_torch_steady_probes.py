"""The steady-state probes on the port (``pnmol_tpu_torch.experiments.
steady_decay_probe`` and ``steady_error_probe``, the CPU and its plain QRs)
against the JAX package: the decay at N = 512 against the committed
``bench_artifacts/steady_decay_probe_f64_n512.json``, the decay at N = 64
against a run of the JAX script (a subprocess: it reads ``sys.argv`` when
imported), and the error probe at the committed configuration (dx 0.02, dt
1e-4, tmax 0.3, the ladder 1, 2, 3, 5, 10, 25, 100) against every row of
``bench_artifacts/steady_error_probe.json`` (read as data).

Tolerances (set from a CPU run of both packages):

- Decay: the Riccati iterations equal; the amplitudes, the ratio and the
  per-step factor within 1e-7 relative at N = 512 (measured 2.7e-9) and
  1e-8 at N = 64 (7e-11); the slowest mode's ratio to 1e-14. The DARE
  certificate sits at its rounding floor (7.6e-10 in JAX's record, 1.7e-9
  on the port), so it is held below 1e-6, not to JAX's value.
- Error probe: the Riccati iterations equal. The deviations from the full
  solve are differences of two solves at 1e-10 to 4e-7 of the amplitude,
  so they are held absolutely: 1e-13 on the unseeded rows (measured 3.3e-15)
  and 2e-10 on the SDA-seeded row (4.8e-11). The unseeded deltas within
  1e-6 relative (1.6e-7 at cap 2, whose delta is 4.7e3). The seeded row's
  polish stops at the SDA fixed point's rounding, so its delta (2.1e-4 in
  JAX's record, 1.2e-3 on the port) is not held; its certificate is held
  below 1e-6.

The JAX error probe's ``main`` writes ``bench_artifacts/``: no test runs it.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_figures

from pnmol_tpu_torch.experiments import steady_decay_probe as decay
from pnmol_tpu_torch.experiments import steady_error_probe as error

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "bench_artifacts"
DECAY_512 = json.loads((ARTIFACTS / "steady_decay_probe_f64_n512.json").read_text())
ERROR_PROBE = json.loads((ARTIFACTS / "steady_error_probe.json").read_text())
DECAY_KEYS = ("absmax0", "absmax_final", "ratio", "per_step_factor")
ERR_ATOL = {"seeded": 2e-10, "unseeded": 1e-13}


@pytest.fixture(scope="module")
def decay_512():
    return decay.run("cpu", n=512, steps=2048, dt=0.01)


@pytest.mark.parametrize("key", DECAY_KEYS)
def test_decay_at_512_matches_the_committed_record(decay_512, key):
    np.testing.assert_allclose(decay_512[key], DECAY_512[key], rtol=1e-7, atol=0)


def test_decay_at_512_has_the_committed_configuration(decay_512):
    for key in ("n", "steps", "dt", "dtype", "riccati_iters"):
        assert decay_512[key] == DECAY_512[key], key
    assert decay_512["riccati_iters"] == 4
    np.testing.assert_allclose(decay_512["slowest_mode_ratio"], DECAY_512["slowest_mode_ratio"],
                               rtol=1e-14)
    assert 0.0 < decay_512["dare_residual"] < 1e-6
    assert decay_512["device"] == "cpu"


@pytest.fixture(scope="module")
def decay_64_jax():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / "experiments" / "steady_decay_probe.py"),
                           "f64", "64", "256"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_decay_at_64_matches_the_jax_script(decay_64_jax):
    got = decay.run("cpu", n=64, steps=256, dt=0.01)
    for key in DECAY_KEYS:
        np.testing.assert_allclose(got[key], decay_64_jax[key], rtol=1e-8, atol=0, err_msg=key)
    for key in ("n", "steps", "dt", "dtype", "riccati_iters"):
        assert got[key] == decay_64_jax[key], key
    np.testing.assert_allclose(got["slowest_mode_ratio"], decay_64_jax["slowest_mode_ratio"],
                               rtol=1e-14)


def test_measure_continues_an_initialized_solver():
    """``measure`` on a built solver equals two measures that split the
    steps: the state is the caller's, the frozen blocks the solver's."""
    solver, state = decay.build("cpu", n=32, dt=0.01)
    whole = decay.measure(solver, state, steps=40)
    first = decay.measure(solver, state, steps=40)
    assert first == whole
    assert whole["ratio"] < 1.0 and whole["riccati_iters"] == solver.steady_cache.iterations


def test_two_qr_is_taken_on_the_card_from_4096_points():
    assert decay.solver_options("cpu", 10000) == {"factorization": None}
    assert decay.solver_options("cuda", 512) == {"factorization": "householder"}
    assert decay.solver_options("cuda", 10000) == {
        "factorization": "householder", "fused": False, "propagate_band": "banded"}


@pytest.fixture(scope="module")
def error_probe():
    cfg = ERROR_PROBE["config"]
    return error.run("cpu", dx=cfg["dx"], dt=cfg["dt"], tmax=cfg["tmax"],
                     iters_ladder=(1, 2, 3, 5, 10, 25, 100))


def test_error_probe_has_the_committed_configuration(error_probe):
    want = ERROR_PROBE["config"]
    got = error_probe["config"]
    for key in ("dx", "dt", "tmax", "d", "num_steps", "platform", "tail_window"):
        assert got[key] == want[key], key
    assert error_probe["note"] == ERROR_PROBE["note"]
    assert [r["config"] for r in error_probe["rows"]] == [r["config"] for r in ERROR_PROBE["rows"]]


@pytest.mark.parametrize("index", range(len(ERROR_PROBE["rows"])),
                         ids=[r["config"] for r in ERROR_PROBE["rows"]])
def test_error_probe_row_matches_the_committed_row(error_probe, index):
    got, want = error_probe["rows"][index], ERROR_PROBE["rows"][index]
    seeded = want["config"] == "sda_seeded"
    assert got["riccati_iterations"] == want["riccati_iterations"]
    for key in ("rel_mean_err_tail", "rel_mean_err_full"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=ERR_ATOL["seeded" if seeded else "unseeded"], err_msg=key)
    if seeded:
        assert 0.0 < got["dare_residual"] < 1e-6
    else:
        assert got["dare_residual"] is None
        np.testing.assert_allclose(got["delta"], want["delta"], rtol=1e-6, atol=0)


def test_the_command_lines_write_only_under_their_output_root(tmp_path, capsys):
    before = torch_figures.committed_digests()
    record = decay.main(["--n", "16", "--steps", "8", "--device", "cpu", "--out", str(tmp_path)])
    assert json.loads((tmp_path / "steady_decay_probe" / "steady_decay_probe.json")
                      .read_text()) == record
    record = error.main(["--dx", "0.25", "--dt", "0.05", "--tmax", "0.2", "--iters-ladder",
                         "1,3", "--device", "cpu", "--out", str(tmp_path)])
    written = json.loads((tmp_path / "steady_error_probe" / "steady_error_probe.json").read_text())
    assert written == record
    assert [r["config"] for r in written["rows"]] == ["unseeded_cap1", "unseeded_cap3",
                                                     "sda_seeded"]
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"artifact": str(tmp_path / "steady_error_probe" /
                                                    "steady_error_probe.json")}
    assert torch_figures.committed_digests() == before


@pytest.mark.parametrize("probe", [decay, error])
def test_the_card_is_refused_without_a_card(probe):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.run("cuda")
