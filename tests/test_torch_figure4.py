"""Figure 4's driver on the port (``pnmol_tpu_torch.experiments.figure4``,
the CPU and its plain QRs) against the JAX driver's committed arrays in
``experiments/results/figure4/``: the coarsest mesh (dx = 0.2) at the four
largest of its twelve step sizes, for the latent and white PNMOL solvers
and the MOL baseline; and the command line.

Tolerances: the step counts equal. The relative RMSE and the chi2 within
1e-6 (1.4e-8 and 6.8e-8 measured): both LSODA references (rtol = atol =
1e-10) see the rounding of their own ``f`` and part by ~1e-10, which an
RMSE of ~1e-2 carries as ~1e-8. Runtimes are never held.

The finest row (dx = 0.01) parts from JAX further: the reference's mesh
(dx/7) gives the default ``SquareExponential()`` stencils u cond(K) ~ 5e-5,
so the two packages' FD rows there part by ~1.5e-4 and their references
by ~6e-7 (relative, rms; the relative RMSEs 6.3e-7 apart at the three
largest dts, on the CPU), and the latent solver diverges at those dts in
both (JAX's RMSE 1.0e5, 1.0e7 and 84, the port's 8.0e4, 4.6e5 and 85:
divergence compounds rounding). That row, whose reference takes minutes on
a CPU, is held on the card by ``chip_smoke.py`` phase P (relative RMSE
1e-5 absolute, chi2 2e-5 / RMSE relative, both diverged; ROADMAP 3.3).
"""

import numpy as np
import pytest
import torch
import torch_figures

from pnmol_tpu_torch.experiments import figure4

torch.set_num_threads(1)

DX = 0.2
NUM_DTS = 4
TOLERANCES = {"rmse": 1e-6, "chi2": 1e-6, "nsteps": 0.0}
EXTRAS = {"reference_time", "reference_jac_time", "reference_jac_calls"}


@pytest.fixture(scope="module")
def arrays():
    return figure4.run("cpu", dxs=[DX], dts=figure4.default_dts(False)[:NUM_DTS])


def committed(name):
    return torch_figures.committed("figure4", f"dx_{DX}_{name}")


def test_the_step_sizes_are_jaxs(arrays):
    np.testing.assert_allclose(arrays[f"dx_{DX}_dts"], committed("dts")[:NUM_DTS], rtol=1e-15)


@pytest.mark.parametrize("metric", sorted(TOLERANCES))
@pytest.mark.parametrize("method", figure4.METHODS)
def test_corner_matches_jax(arrays, method, metric):
    got = arrays[f"dx_{DX}_{method}_{metric}"]
    want = committed(f"{method}_{metric}")[:NUM_DTS]
    assert got.shape == want.shape
    if metric == "nsteps":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOLERANCES[metric], atol=0)


def test_cli_writes_jax_names_and_leaves_the_committed_results(tmp_path):
    before = torch_figures.results_digests()
    figure4.main(["--fast", "--no-plot", "--device", "cpu", "--out", str(tmp_path),
                  "--dxs", "0.2"])
    written = {p.stem for p in (tmp_path / "figure4_fast").glob("*.npy")}
    want = {name for name in torch_figures.committed_names("figure4")
            if name.startswith("dx_0.2_")} | {f"dx_0.2_{name}" for name in EXTRAS}
    assert written == want
    assert torch_figures.results_digests() == before
