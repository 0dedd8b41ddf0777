"""Figure 2's driver on the port (``pnmol_tpu_torch.experiments.figure2``,
the CPU) against the JAX driver's committed arrays in
``experiments/results/figure2/``, at full size, and its command line.

Tolerances follow the conditioning of each quantity (u = 2.2e-16, f64):

* the MLE scale: equal (the argmax of the same 20 trials);
* the stencil x input-scale RMSE grid: each entry within 10 u cond(K) of
  JAX's, K the Gram of its stencil (n consecutive points of the 25-point
  mesh; measured at most 2u cond(K)). Where u cond(K) > 0.1 the Gram is
  numerically singular and no value is held: there both packages give
  the 100 of a failed Cholesky, or an RMSE, except at the three entries
  where they part (stencil 7 at scales 0.2 and 0.8, stencil 11 at 3.2:
  JAX's Cholesky fails, the port's succeeds; ROADMAP queue 3), pinned by
  ``test_rmse_grid_parts_from_jax_only_where_the_stencil_gram_is_singular``;
* the sparse L and E (3-point stencils at the MLE scale): 1e-10 of the
  largest entry (7e-13 measured);
* the dense L and E (global collocation, cond(K + 1e-12 I) = 9.0e12): L
  within u cond = 2e-3 of its largest entry (8.3e-5 measured), E's factor
  within 10 u cond (2.4e-3 measured: E = LL_k - D L_k^T cancels);
* the grid, the target and its Laplacian: 1e-14 of the largest entry;
* the GP samples, drawn from JAX's own ``jax.random.normal`` noise of
  ``figure2.main``'s key sequence: within u cond(K + 1e-12 I) of the largest
  entry, the forward bound of a Cholesky factor (cond 9e13-1.5e14;
  1.8e-6 to 1.6e-4 measured). The port's own draws (a seeded
  ``torch.Generator``) differ from JAX's by design. That noise is also
  committed as ``tests/golden/figure2_jax_noise.npz``, so that the card,
  which has no JAX, draws the same samples.
"""

import jax
import numpy as np
import pytest
import torch
import torch_figures

import pnmol_tpu_torch as pt
from pnmol_tpu_torch.experiments import figure2

torch.set_num_threads(1)

U = np.finfo(np.float64).eps
# (stencil size, input scale) where JAX's Cholesky fails and the port's does not
PARTED = {(7, 0.2), (7, 0.8), (11, 3.2)}


def jax_noises():
    """The noise of ``experiments/figure2.py``'s samples: one draw per scale
    from PRNGKey(123), the key split after each."""
    key, noises = jax.random.PRNGKey(123), []
    for _ in figure2.INPUT_SCALES:
        noises.append(np.array(jax.random.normal(key, shape=(figure2.NUM_GRID_POINTS, 2))))
        _, key = jax.random.split(key)
    return noises


def test_the_committed_noise_is_jaxs():
    golden = np.load(torch_figures.REPO / "tests" / "golden" / "figure2_jax_noise.npz")
    for i, noise in enumerate(jax_noises()):
        np.testing.assert_array_equal(golden[f"noise{i + 1}"], noise)


@pytest.fixture(scope="module")
def arrays():
    return figure2.run("cpu", noises=jax_noises())


def committed(name):
    return torch_figures.committed("figure2", name)


def gram_condition(points, scale, nugget=0.0):
    pts = torch.tensor(points)
    gram = pt.kernels.SquareExponential(input_scale=scale)(pts, pts.T)
    return float(torch.linalg.cond(gram + nugget * torch.eye(len(points), dtype=gram.dtype)))


def stencil_condition(size, scale):
    mesh = np.linspace(0, 1, figure2.NUM_MESH_POINTS)[:, None]
    return gram_condition(mesh[:size] - mesh[0], scale)


def test_mle_scale_and_the_axes_equal_jax(arrays):
    assert float(arrays["fig2_scale_mle"]) == float(committed("fig2_scale_mle"))
    for name in ("fig2_input_scales", "fig2_stencil_sizes"):
        np.testing.assert_array_equal(arrays[name], committed(name))


def test_rmse_grid_matches_jax_to_the_stencil_conditioning(arrays):
    got, want = arrays["fig2_rmse_all"], committed("fig2_rmse_all")
    assert got.shape == want.shape
    held = 0
    for i, size in enumerate(committed("fig2_stencil_sizes")):
        for j, scale in enumerate(committed("fig2_input_scales")):
            rtol = 10 * U * stencil_condition(int(size), float(scale))
            if rtol <= 1.0:
                assert got[i, j] == pytest.approx(want[i, j], rel=rtol), (size, scale)
                held += 1
    assert held == 7


def test_rmse_grid_parts_from_jax_only_where_the_stencil_gram_is_singular(arrays):
    got, want = arrays["fig2_rmse_all"], committed("fig2_rmse_all")
    sizes, scales = committed("fig2_stencil_sizes"), committed("fig2_input_scales")
    parted = {(int(sizes[i]), float(scales[j]))
              for i, j in zip(*np.nonzero((got == figure2.FAILED_RMSE)
                                          != (want == figure2.FAILED_RMSE)))}
    assert parted == PARTED
    for size, scale in parted:
        assert U * stencil_condition(size, scale) > 1.0
        i, j = list(sizes).index(size), list(scales).index(scale)
        assert want[i, j] == figure2.FAILED_RMSE and np.isfinite(got[i, j])
    assert (want == figure2.FAILED_RMSE).sum() == 25
    assert (got == figure2.FAILED_RMSE).sum() == 25 - len(PARTED)


def test_a_failed_stencil_cholesky_maps_to_the_figures_100():
    """The port's Cholesky raises where JAX's returns NaN: the driver turns
    that into the NaN that the figure maps to 100."""
    mesh = figure2.make_mesh("cpu")
    with pytest.raises(torch.linalg.LinAlgError):
        pt.discretize.fd_probabilistic(pt.diffops.laplace(), mesh,
                                       pt.kernels.SquareExponential(input_scale=0.2), 9, 9)
    rmse, (L, E) = figure2.scale_to_rmse(mesh, 0.2, 9)
    assert np.isnan(rmse) and L is None and E is None


def test_sparse_operators_match_jax(arrays):
    for name in ("fig2_L_sparse", "fig2_E_sparse"):
        assert torch_figures.relative_gap(arrays[name], committed(name)) <= 1e-10


def test_dense_operators_match_jax_to_the_gram_conditioning(arrays):
    points = np.linspace(0, 1, figure2.NUM_MESH_POINTS)[:, None]
    bound = U * gram_condition(points, float(committed("fig2_scale_mle")), nugget=1e-12)
    assert 1e-3 < bound < 3e-3
    assert torch_figures.relative_gap(arrays["fig2_L_dense"], committed("fig2_L_dense")) <= bound
    assert (torch_figures.relative_gap(arrays["fig2_E_dense"], committed("fig2_E_dense"))
            <= 10 * bound)


def test_grid_and_target_match_jax(arrays):
    for name in ("fig2_xgrid", "fig2_fx", "fig2_dfx"):
        assert arrays[name].shape == committed(name).shape
        assert torch_figures.relative_gap(arrays[name], committed(name)) <= 1e-14


@pytest.mark.parametrize("index", [1, 2, 3])
def test_samples_from_jaxs_noise_match_jax(arrays, index):
    xgrid = committed("fig2_xgrid")
    scale = float(committed("fig2_input_scales")[index - 1])
    bound = U * gram_condition(xgrid, scale, nugget=1e-12)
    name = f"fig2_s{index}"
    assert arrays[name].shape == committed(name).shape
    assert torch_figures.relative_gap(arrays[name], committed(name)) <= bound


def test_default_noise_is_seeded_and_fresh_per_scale():
    first, second = (figure2.default_noises("cpu", torch.float64) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert not torch.equal(first[0], first[1])


def test_cli_writes_jax_names_and_leaves_the_committed_results(tmp_path):
    before = torch_figures.results_digests()
    figure2.main(["--fast", "--no-plot", "--device", "cpu", "--out", str(tmp_path)])
    written = {p.stem for p in (tmp_path / "figure2_fast").glob("*.npy")}
    assert written == torch_figures.committed_names("figure2")
    assert torch_figures.results_digests() == before
