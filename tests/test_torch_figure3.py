"""Figure 3's driver on the port (``pnmol_tpu_torch.experiments.figure3``,
the CPU and its plain QRs) against the JAX driver's committed grids in
``experiments/results/figure3/``: the coarsest mesh (dx = 1/4, the grids'
last row) at the five largest step sizes (columns 12, 14, 15, 16 and 17 of
the sorted dts: 0.71, 1.41, 2, 2.83 and 4), for the white solver and the
MOL baseline; the batched route against the sequential one; and the
command line.

Tolerances: both LSODA references (rtol = atol = 1e-10) see the rounding of
their own ``f``, so the port's and JAX's references part by ~1e-10
relative, and an error of ~7% of the reference carries that as ~1e-9: the
errors within 1e-8 (3.2e-10 measured), the stds within 1e-9 (2.7e-11), the
chi2 (a Cholesky of the covariance with a 1e-12 nugget) within 1e-6
(7.9e-9). The batched sweep and the sequential solves within 1e-10
(7.8e-13 measured, chi2). Runtimes are never held: JAX's are its CPU times.

The finest row (dx = 1/64, the grids' first) parts from JAX further,
because there the two packages solve slightly different problems: the
default ``SquareExponential()`` stencils are near singular (u cond(K) =
0.07 for the 5-point boundary stencils; the dx/10 reference's 4-point ones
are singular), so the FD rows part (boundary rows 5.4% on the figure's
mesh, 35% on the reference's; interior rows 9e-10 and 9e-6), and so do the
LSODA references (~2e-6 of the reference, rms) and the white solver's
calibration (chi2 4.6% and stds 7e-5 from JAX's at the two largest dts,
on the CPU). ``test_the_fine_sir_boundary_stencils_part_by_their_conditioning``
pins that cause; the row itself, whose references take minutes on a
CPU, is held on the card by ``chip_smoke.py`` phase P (relative RMSE 1e-4
absolute, stds 1e-3, chi2 0.2 white and 2e-4 / RMSE MOL; ROADMAP 3.3).
"""

import numpy as np
import pytest
import torch
import torch_figures

from pnmol_tpu_torch.experiments import figure3

torch.set_num_threads(1)

COLUMNS = [12, 14, 15, 16, 17]
JAX_ROW = 4  # dx = 1/4: rows run finest first
TOLERANCES = {"error_abs": 1e-8, "error_rel": 1e-8, "std": 1e-9, "chi2": 1e-6, "dt": 0.0,
              "dx": 0.0}
EXTRAS = {"reference_time", "reference_jac_time", "reference_jac_calls"}
U = np.finfo(np.float64).eps


def corner(ensemble):
    return figure3.run("cpu", dxs=[0.25], dts=np.sort(figure3.DTS)[COLUMNS], ensemble=ensemble)


@pytest.fixture(scope="module")
def sequential():
    return corner(ensemble=False)


@pytest.fixture(scope="module")
def batched():
    return corner(ensemble=True)


def test_the_corner_is_the_grids_coarsest_row_at_its_largest_steps(sequential):
    want_dt = torch_figures.committed("figure3", "pnmol_white_dt")[JAX_ROW, COLUMNS]
    np.testing.assert_array_equal(sequential["pnmol_white_dt"][0], want_dt)
    np.testing.assert_allclose(want_dt, [2**-0.5, 2**0.5, 2.0, 2**1.5, 4.0], rtol=1e-15)
    assert (torch_figures.committed("figure3", "pnmol_white_dx")[JAX_ROW] == 0.25).all()


@pytest.mark.parametrize("metric", sorted(TOLERANCES))
@pytest.mark.parametrize("method", ["pnmol_white", "tornadox"])
def test_corner_matches_jax(sequential, method, metric):
    got = sequential[f"{method}_{metric}"]
    want = torch_figures.committed("figure3", f"{method}_{metric}")[JAX_ROW, COLUMNS]
    assert got.shape == (1, len(COLUMNS))
    np.testing.assert_allclose(got[0], want, rtol=TOLERANCES[metric], atol=0)


@pytest.mark.parametrize("metric", ["error_abs", "error_rel", "std", "chi2", "dt", "dx"])
def test_batched_sweep_matches_the_sequential_solves(sequential, batched, metric):
    for method in ("pnmol_white", "tornadox"):
        name = f"{method}_{metric}"
        np.testing.assert_allclose(batched[name], sequential[name], rtol=1e-10, atol=0)


def test_batched_runtime_is_the_batch_over_its_lanes(batched):
    runtime = batched["pnmol_white_runtime"][0]
    assert (runtime == runtime[0]).all() and runtime[0] > 0


def test_reference_records_its_jacobian_calls(sequential):
    assert sequential["reference_jac_calls"][0] >= 1
    assert 0 < sequential["reference_jac_time"][0] <= sequential["reference_time"][0]


def test_cli_writes_jax_names_and_leaves_the_committed_results(tmp_path):
    before = torch_figures.results_digests()
    figure3.main(["--fast", "--no-plot", "--device", "cpu", "--out", str(tmp_path),
                  "--dx-levels", "1"])
    written = {p.stem for p in (tmp_path / "figure3_fast").glob("*.npy")}
    assert written == torch_figures.committed_names("figure3") | EXTRAS
    dx = np.load(tmp_path / "figure3_fast" / "pnmol_white_dx.npy")
    assert dx.shape == (1, len(figure3.DTS[::4])) and (dx == 0.25).all()
    assert torch_figures.results_digests() == before


@pytest.mark.parametrize("dx, boundary, gap", [(1.0 / 64, 5, 1e-2), (1.0 / 640, 4, 1e-1)])
def test_the_fine_sir_boundary_stencils_part_by_their_conditioning(dx, boundary, gap):
    """Why the finest row parts from JAX: the two packages' FD rows part
    where the stencil Gram is near singular (the boundary rows: at least
    ``gap`` apart, within 10 u cond of it where that is below 1), and agree
    in the interior to 1e-5."""
    import pnmol_tpu as jp

    import pnmol_tpu_torch as pt

    kwargs = dict(dx=dx, stencil_size_interior=3, stencil_size_boundary=boundary)
    L = pt.pde.examples.sir_1d_discretized(
        device="cpu", kernel=pt.kernels.SquareExponential(), **kwargs).L.numpy()
    jL = np.asarray(jp.pde.examples.sir_1d_discretized(
        kernel=jp.kernels.SquareExponential(), **kwargs).L)
    rows = np.abs(L - jL).max(axis=1) / np.abs(jL).max(axis=1)
    offsets = torch.tensor(np.arange(boundary)[:, None] * dx)
    cond = float(torch.linalg.cond(pt.kernels.SquareExponential()(offsets, offsets.T)))
    n = L.shape[0] // 3
    boundary_rows = [0, n - 1]
    assert rows[boundary_rows].max() >= gap
    assert rows[boundary_rows].max() <= max(10 * U * cond, 1.0)
    assert np.delete(rows[:n], boundary_rows).max() <= 1e-5
