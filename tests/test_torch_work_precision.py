"""The work-precision driver on the port (``pnmol_tpu_torch.experiments.
work_precision``, the CPU and its plain QRs) against the JAX package: the
Lotka-Volterra leg against the committed CPU f64 rows of
``bench_artifacts/tpu_work_precision.json`` (read as data), the heat leg at
N = 512 against JAX's live solve built as ``experiments/tpu_work_precision.
py``'s ``_child`` builds it, and the driver's refusals: a failed leg is
recorded and makes the run exit non-zero, and nothing is written into the
JAX package's committed records.

Tolerances (set from a CPU run of both packages):

- Lotka-Volterra, dt 0.316 and 0.1: the step counts equal; the relative
  RMSE within 1e-6 relative (measured 1.2e-7 and 2.1e-7) and the chi2
  within 2e-4 relative (3.9e-5 and 3.0e-5). The FD kernel is the default
  ``SquareExponential()`` on dx = 0.01, whose 3- and 4-point stencil Grams
  are near singular, so the two packages' error covariances ``E`` part in
  their leading digits there and the chi2 carries that (ROADMAP 3.3).
- Heat at N = 512, dt 0.1 (the dx-adapted FD kernel): the step counts
  equal, the relative RMSE and the chi2 within 1e-6 relative (measured
  1.6e-7 and 2.5e-7), the interior means within 2e-8 of their largest
  entry (4.8e-9). The two packages' ``L`` part by 1.6e-12 and their ``E``
  (formed by cancellation at dx = 1/511) by 5.5e-11, and ten steps of 0.1
  on this stiff system (diffusion 0.05 / dx^2 ~ 1.3e4) carry that into the
  means; the RMSE divides by the reference down to 5e-4 of its peak.

The JAX driver's ``main`` writes ``bench_artifacts/`` and its
``cached_ref`` ``experiments/results/``: no test runs either.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch
import torch_figures

import pnmol_tpu
from pnmol_tpu import kernels as jkernels
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu_torch.experiments import common
from pnmol_tpu_torch.experiments import work_precision as wp

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
COMMITTED = json.loads((REPO / "bench_artifacts" / "tpu_work_precision.json").read_text())
LV_DTS = (0.316, 0.1)
LV_RTOL = {"rmse_rel": 1e-6, "chi2": 2e-4}
HEAT_RTOL, HEAT_MEAN_RTOL = 1e-6, 2e-8


@pytest.fixture(scope="module")
def lv_leg():
    return wp.run_leg("lv_cpu", dts=LV_DTS)


def committed_row(dt):
    (row,) = [r for r in COMMITTED["rows"]
              if r["problem"] == "lv" and r["platform"] == "cpu" and r["dt"] == dt]
    return row


@pytest.mark.parametrize("dt", LV_DTS)
def test_lv_rows_match_the_committed_cpu_rows(lv_leg, dt):
    (got,) = [r for r in lv_leg["rows"] if r["dt"] == dt]
    want = committed_row(dt)
    assert (got["problem"], got["platform"], got["n"], got["num_steps"], got["dtype"]) == (
        "lv", "cpu", want["n"], want["num_steps"], want["dtype"])
    for key, rtol in LV_RTOL.items():
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=0, err_msg=key)


def test_lv_leg_reads_the_committed_reference_and_counts_no_launch_on_the_cpu(lv_leg):
    assert lv_leg["reference"] == {"source": "committed", "tag": "lv_dx0.01_s4"}
    assert lv_leg["device"] == "cpu"
    assert all(row["launches"] == {"panel_lq": 0, "leaf_lq": 0} for row in lv_leg["rows"])
    assert all(row["seconds"] > 0 and row["steps_per_s"] > 0 for row in lv_leg["rows"])


def jax_heat_row(n, dt, u_ref):
    """JAX's heat solve at ``dt``, built as the JAX driver's ``_child``
    builds it, with its record's statistics (host f64)."""
    dx = 1.0 / (n - 1)
    pde = pnmol_tpu.pde.examples.heat_1d_discretized(
        dx=dx, tmax=1.0, kernel=jkernels.SquareExponential(input_scale=0.1 / dx))
    solver = pnmol_tpu.white.LinearWhiteNoiseEK1(
        num_derivatives=wp.NU, steprule=jstep.Constant(dt),
        spatial_kernel=jkernels.Matern52() + jkernels.WhiteNoise())
    final, info = solver.simulate_final_state(pde)
    u = np.asarray(final.y.mean[0][1:-1], np.float64)
    cov = final.y.cov_sqrtm @ final.y.cov_sqrtm.T
    u_cov = np.asarray((solver.E0 @ cov @ solver.E0.T)[1:-1, 1:-1], np.float64)
    err = np.abs(u - u_ref)
    rel = err / np.abs(u_ref)
    return u, {"num_steps": int(info["num_steps"]),
               "rmse_rel": float(np.linalg.norm(rel) / np.sqrt(rel.size)),
               "chi2": wp.chi2_f64(err, u_cov)}


def test_heat_512_row_matches_jax():
    problem = wp.Problem("heat", 512, torch.device("cpu"))
    extract, kept = problem.extract, {}

    def keep(final, solver):  # the row's interior mean, for the comparison
        kept["u"], cov = extract(final, solver)
        return kept["u"], cov

    problem.extract = keep
    u_ref, _ = wp.reference(problem)
    got = wp.solve_row(problem, 0.1, u_ref, None, "cpu")
    u_jax, want = jax_heat_row(512, 0.1, u_ref)
    assert (got["n"], got["num_steps"]) == (512, want["num_steps"]) == (512, 10)
    for key in ("rmse_rel", "chi2"):
        np.testing.assert_allclose(got[key], want[key], rtol=HEAT_RTOL, atol=0, err_msg=key)
    assert np.abs(kept["u"].numpy() - u_jax).max() <= HEAT_MEAN_RTOL * np.abs(u_jax).max()


def test_heat_ladders_are_the_jax_drivers():
    assert wp.default_dts("heat", 512, "cuda") == [0.1, 0.05, 0.02, 0.01, 0.005, 0.002, 0.001]
    assert wp.default_dts("heat", 512, "cpu") == [0.1, 0.05, 0.02, 0.01]
    assert wp.default_dts("heat", 2048, "cpu") == [0.1, 0.05]
    assert wp.default_dts("lv", None, "cuda") == wp.LV_DTS


@pytest.mark.parametrize("leg", ["lv_tpu", "heat_cpu", "wave_512_cpu", "heat_512_cuda_x"])
def test_an_unknown_leg_is_refused(leg):
    with pytest.raises(ValueError, match="unknown leg"):
        wp.parse_leg(leg)


def test_a_leg_that_raises_is_recorded_failed_and_the_run_exits_non_zero(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise FloatingPointError("NaN in the step")

    monkeypatch.setattr(wp, "run_leg", broken)
    before = torch_figures.committed_digests()
    with pytest.raises(SystemExit) as exit_info:
        wp.main(["--legs", "lv_cpu,heat_512_cpu", "--out", str(tmp_path)])
    assert exit_info.value.code == 1
    record = json.loads((tmp_path / "work_precision" / "work_precision.json").read_text())
    assert [s["leg"] for s in record["legs"]] == ["lv_cpu", "heat_512_cpu"]
    assert all(s["status"] == "failed" and s["error"] == "FloatingPointError: NaN in the step"
               for s in record["legs"])
    assert record["rows"] == []
    assert torch_figures.committed_digests() == before


def test_the_card_without_a_card_fails_the_leg():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the refusal without one")
    record, ok = wp.run(["lv_cuda"])
    assert not ok
    (status,) = record["legs"]
    assert status["status"] == "failed" and "no CUDA device" in status["error"]


@pytest.mark.parametrize("root", ["bench_artifacts", "experiments", "docs"])
def test_the_writer_refuses_the_committed_records(tmp_path, root):
    with pytest.raises(ValueError, match="committed record"):
        common.write_artifact("work_precision", {"rows": []}, REPO / root)
    with pytest.raises(ValueError, match="committed record"):
        common.write_artifact("work_precision", {"rows": []}, REPO / root / "results" / "..")
    path = common.write_artifact("work_precision", {"rows": []}, tmp_path)
    assert path == tmp_path / "work_precision" / "work_precision.json"


def test_the_jax_package_keeps_its_committed_references():
    """The driver reads the JAX driver's cached LSODA finals as data."""
    for tag in ("lv_dx0.01_s4", "heat_n512", "heat_n2048"):
        ref = np.load(wp.REFERENCES / f"wp_ref_{tag}.npy")
        assert ref.dtype == np.float64 and np.isfinite(ref).all()
    problem = wp.Problem("lv", None, torch.device("cpu"))
    values, record = wp.reference(problem)
    assert values.shape == (problem.n - 2,) and record["source"] == "committed"
