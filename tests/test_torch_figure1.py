"""Figure 1's driver on the port (``pnmol_tpu_torch.experiments.figure1``,
the CPU and its plain QRs) against the JAX driver's committed arrays in
``experiments/results/figure1/``, at full size; its command line; and the
port's rendering of the figure.

Tolerances: the PNMOL and MOL means within 1e-12 of the largest mean (the
ports of the same f64 filters differ by rounding: 1.7e-15 measured), the
DP5 reference's within 1e-10 (its rtol is 1e-8; 2.5e-12 measured). The
stds within 1e-11 of each method's largest std, absolute: the two
Dirichlet boundary columns are rounding noise, relative to which no two
packages agree (1.4e-13 measured). Times and points within 1e-14. The
calibrated gammas, which the JAX driver prints, within 1e-12 (1.1e-14
measured).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_figures

from pnmol_tpu_torch.experiments import common, figure1

torch.set_num_threads(1)

PREFIXES = ("pnmol_white", "pnmol_latent", "tornadox", "reference")
# experiments/figure1.py's printout of the calibrated gammas
JAX_GAMMAS = {"pnmol_white": 0.008719248204530036, "pnmol_latent": 0.002750894030713232}
EXTRAS = {"pnmol_white_gamma", "pnmol_latent_gamma"}


@pytest.fixture(scope="module")
def arrays():
    return figure1.run("cpu")


def committed(name):
    return torch_figures.committed("figure1", name)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_means_match_jax(arrays, prefix):
    want = committed(f"{prefix}_means")
    assert arrays[f"{prefix}_means"].shape == want.shape
    limit = 1e-10 if prefix == "reference" else 1e-12
    assert torch_figures.relative_gap(arrays[f"{prefix}_means"], want) <= limit


@pytest.mark.parametrize("prefix", PREFIXES)
def test_stds_match_jax(arrays, prefix):
    want = committed(f"{prefix}_stds")
    got = arrays[f"{prefix}_stds"]
    assert got.shape == want.shape
    if prefix == "reference":
        assert not got.any() and not want.any()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-11 * np.abs(want).max())


@pytest.mark.parametrize("prefix", PREFIXES)
def test_times_and_points_match_jax(arrays, prefix):
    for name in ("ts", "xs"):
        want = committed(f"{prefix}_{name}")
        assert arrays[f"{prefix}_{name}"].shape == want.shape
        np.testing.assert_allclose(arrays[f"{prefix}_{name}"], want, rtol=0, atol=1e-14)


@pytest.mark.parametrize("prefix", sorted(JAX_GAMMAS))
def test_calibrated_gammas_match_jax(arrays, prefix):
    assert float(arrays[f"{prefix}_gamma"]) == pytest.approx(JAX_GAMMAS[prefix], rel=1e-12)


def test_cli_writes_jax_names_and_leaves_the_committed_results(tmp_path):
    """``python -m ...figure1 --fast --no-plot --device cpu --out DIR``: JAX's
    file names (and the gammas) under ``DIR/figure1_fast/``, nothing under
    ``experiments/results/`` touched."""
    before = torch_figures.results_digests()
    subprocess.run(
        [sys.executable, "-m", "pnmol_tpu_torch.experiments.figure1", "--fast", "--no-plot",
         "--device", "cpu", "--out", str(tmp_path)],
        cwd=torch_figures.REPO, check=True, timeout=300, capture_output=True,
    )
    written = {p.stem for p in (tmp_path / "figure1_fast").glob("*.npy")}
    assert written == torch_figures.committed_names("figure1") | EXTRAS
    assert not (tmp_path / "figure1").exists()
    assert torch_figures.results_digests() == before


def test_a_card_asked_for_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        figure1.run("cuda")
    assert common.default_factorization("cpu") is None
    assert common.default_factorization("cuda") == "householder"


def test_plot_renders_the_ports_arrays_into_the_output_root(arrays, tmp_path):
    pytest.importorskip("matplotlib")
    from pnmol_tpu_torch.experiments import plotting

    before = torch_figures.results_digests()
    common.save_arrays(common.results_dir(tmp_path, "figure1"), arrays)
    plotting.figure_1(tmp_path)
    for suffix in (".pdf", ".png"):
        assert (tmp_path / f"figure1{suffix}").stat().st_size > 0
    assert torch_figures.results_digests() == before
