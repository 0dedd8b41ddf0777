"""The port's Polynomial kernel and input-scale calibration against the JAX
package's: Grams, the log likelihood (NaN where JAX's Cholesky gives NaN),
figure 2's grid search on its 25-point mesh (JAX's trial, the same trials
masked), the Adam MLE against the optax version and the dx-adapted scale.

Both calibrations meet near-singular Grams. On figure 2's grid the winning
trial (6.16) has a Gram of condition 9e16, whose log likelihood two
Cholesky implementations give 0.8 % apart (140.5 and 141.7; the runner-up
has 22.3); the trials below 1e12 agree to 1e-8. The Adam MLE adds a 1e-10
nugget (condition ~1e10), so JAX's own result moves 1.7e-7 when the
initial scale moves 1e-15: the two agree to 1.4e-7, held to 1e-6."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu import discretize as jdiscretize
from pnmol_tpu import kernels as jkernels
from pnmol_tpu import mesh as jmesh
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import kernels

torch.set_num_threads(1)

CPU = "cpu"
# figure 2's data (experiments/figure2.py): sin(x . x) on 25 points of [0, 1]
POINTS = np.linspace(0.0, 1.0, 25)[:, None]
DATA = np.sin((POINTS**2).sum(axis=1))
TRIALS = np.logspace(-3, 3, 20)


@pytest.mark.parametrize("order, const", [(2, 1.0), (3, 0.5)])
def test_polynomial_grams_match_jax(order, const):
    rng = np.random.default_rng(order)
    X, Y = rng.standard_normal((6, 2)), rng.standard_normal((4, 2))
    k, jk = kernels.Polynomial(order=order, const=const), jkernels.Polynomial(order=order,
                                                                            const=const)
    tX, tY = torch.tensor(X), torch.tensor(Y)
    for got, want in ((k(tX, tY.T), jk(jnp.asarray(X), jnp.asarray(Y).T)),
                      (k(tX, tX), jk(jnp.asarray(X), jnp.asarray(X))),
                      (k(tX[0], tY[1]), jk(jnp.asarray(X[0]), jnp.asarray(Y[1])))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14, atol=0)
    assert k(tX, tY.T).shape == (6, 4)


@pytest.mark.parametrize("scale", [1e-3, 0.3, 30.0, 300.0])
def test_log_likelihood_matches_jax(scale):
    """A tiny scale makes the Gram numerically singular: NaN on both sides."""
    got = kernels.input_scale_to_log_likelihood(scale, torch.tensor(POINTS), torch.tensor(DATA),
                                                kernels.SquareExponential)
    want = float(jkernels.input_scale_to_log_likelihood(
        scale, jnp.asarray(POINTS), jnp.asarray(DATA), jkernels.SquareExponential))
    if np.isnan(want):
        assert torch.isnan(got)
    else:
        assert float(got) == pytest.approx(want, rel=1e-10)
    assert np.isnan(want) == (scale < 1.0)


def test_figure2_grid_search_matches_jax():
    jvalues = np.asarray(jax.vmap(functools.partial(
        jkernels.input_scale_to_log_likelihood, mesh_points=jnp.asarray(POINTS),
        data=jnp.asarray(DATA), kernel_type=jkernels.SquareExponential))(jnp.asarray(TRIALS)))
    values = np.array([float(kernels.input_scale_to_log_likelihood(
        s, torch.tensor(POINTS), torch.tensor(DATA), kernels.SquareExponential))
        for s in TRIALS])
    masked = np.isnan(values)
    np.testing.assert_array_equal(masked, np.isnan(jvalues))
    assert 0 < masked.sum() < len(TRIALS)
    conds = np.array([float(torch.linalg.cond(kernels.SquareExponential(input_scale=s)(
        torch.tensor(POINTS), torch.tensor(POINTS).T))) for s in TRIALS])
    tame = ~masked & (conds < 1e12)
    assert tame.sum() == (~masked).sum() - 1
    np.testing.assert_allclose(values[tame], jvalues[tame], rtol=1e-8)

    got = kernels.mle_input_scale(mesh_points=torch.tensor(POINTS), data=torch.tensor(DATA),
                                  kernel_type=kernels.SquareExponential,
                                  input_scale_trials=torch.tensor(TRIALS))
    want = jkernels.mle_input_scale(mesh_points=jnp.asarray(POINTS), data=jnp.asarray(DATA),
                                    kernel_type=jkernels.SquareExponential,
                                    input_scale_trials=jnp.asarray(TRIALS))
    assert float(got) == float(want) == TRIALS[np.nanargmax(values)]


def test_gradient_mle_matches_optax():
    """Adam on the log-scale, 100 steps, from the grid's neighbourhood, on
    data drawn from a known scale (numpy seed)."""
    points = np.linspace(0.0, 1.0, 20)[:, None]
    gram = np.exp(-0.5 * 25.0 * (points - points.T) ** 2) + 1e-8 * np.eye(20)
    data = np.linalg.cholesky(gram) @ np.random.default_rng(2).standard_normal(20)
    got = kernels.mle_input_scale_gradient(
        mesh_points=torch.tensor(points), data=torch.tensor(data),
        kernel_type=kernels.SquareExponential, initial_scale=2.0)
    want = jkernels.mle_input_scale_gradient(
        mesh_points=jnp.asarray(points), data=jnp.asarray(data),
        kernel_type=jkernels.SquareExponential, initial_scale=2.0)
    assert isinstance(got, float) and got != 2.0
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("dx, target", [(0.1, 1.0), (1.0 / 511, 0.1)])
def test_dx_adapted_input_scale_matches_jax(dx, target):
    mesh = pt.mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], step=dx, device=CPU)
    jm = jmesh.RectangularMesh.from_bbox_1d(jnp.asarray([0.0, 1.0]), step=dx)
    got = pt.discretize.dx_adapted_input_scale(mesh, target=target)
    assert got == pytest.approx(jdiscretize.dx_adapted_input_scale(jm, target=target),
                                rel=1e-14)
    assert got == pytest.approx(target / dx, rel=1e-9)
