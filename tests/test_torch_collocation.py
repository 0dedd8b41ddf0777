"""The port's global collocation (``collocation_global`` and the mixin's
``scheme="collocation"``) and a white-noise EK1 solve on it, against the
JAX package."""

import numpy as np
import pytest
import torch

from pnmol_tpu import diffops as jdiffops
from pnmol_tpu import discretize as jdiscretize
from pnmol_tpu import kernels as jkernels
from pnmol_tpu import mesh as jmesh
from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.solvers import white as jwhite
import pnmol_tpu_torch as pt
from pnmol_tpu_torch.ops import gram as tgram

torch.set_num_threads(1)

# D solves with the radial Gram K, so the two packages (XLA's Cholesky
# against LAPACK's) agree to about eps * cond(K). The kernel scales below
# keep cond(K) at 29 (dx = 0.2, scale 5) and 69 (64 points, scale
# 1/dx); measured: D 5e-16 and 9e-13, E E^T 1e-15 and 1.3e-12 relative to
# their largest entry. E is compared through its Gram, since its Cholesky
# factor is ill-conditioned.
COLLOCATION_RTOL = 1e-10
CASES = [(6, 5.0), (64, 63.0)]


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _gram(C):
    C = np.asarray(C)
    return C @ C.T


@pytest.mark.parametrize("num_points, input_scale", CASES, ids=["dx0.2", "n64"])
def test_collocation_global_matches_jax(num_points, input_scale):
    dx = 1.0 / (num_points - 1)
    kwargs = dict(nugget_gram_matrix=1e-12, nugget_cholesky_E=1e-6, symmetrize_cholesky_E=True)
    jD, jE = jdiscretize.collocation_global(
        jdiffops.laplace(), jmesh.RectangularMesh.from_bbox_1d([0.0, 1.0], step=dx),
        kernel=jkernels.SquareExponential(input_scale=input_scale), **kwargs,
    )
    D, E = pt.discretize.collocation_global(
        pt.diffops.laplace(),
        pt.mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], step=dx, device="cpu"),
        kernel=pt.kernels.SquareExponential(input_scale=input_scale), **kwargs,
    )
    assert D.shape == E.shape == (num_points, num_points)
    assert _rel(D.numpy(), np.asarray(jD)) <= COLLOCATION_RTOL
    assert _rel(_gram(E), _gram(jE)) <= COLLOCATION_RTOL
    assert torch.all(torch.triu(E, 1) == 0)


@pytest.fixture(scope="module")
def mixin_problems():
    kernel_args = dict(stencil_size_interior=3, stencil_size_boundary=3, scheme="collocation")
    jheat = jexamples.heat_1d(tmax=0.5)
    jheat.discretize(
        mesh_spatial=jmesh.RectangularMesh.from_bbox_1d([0.0, 1.0], step=0.2),
        kernel=jkernels.SquareExponential(input_scale=5.0), **kernel_args,
    )
    theat = pt.pde.examples.heat_1d(tmax=0.5)
    theat.discretize(
        mesh_spatial=pt.mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], step=0.2, device="cpu"),
        kernel=pt.kernels.SquareExponential(input_scale=5.0), **kernel_args,
    )
    return jheat, theat


def test_mixin_collocation_matches_jax(mixin_problems):
    """The JAX mixin's nuggets (1e-12 on K and on E) at dx = 0.2."""
    jheat, theat = mixin_problems
    assert _rel(theat.L.numpy(), np.asarray(jheat.L)) <= COLLOCATION_RTOL
    assert _rel(_gram(theat.E_sqrtm), _gram(jheat.E_sqrtm)) <= COLLOCATION_RTOL
    np.testing.assert_array_equal(theat.B.numpy(), np.asarray(jheat.B))
    np.testing.assert_array_equal(theat.R_sqrtm.numpy(), np.asarray(jheat.R_sqrtm))
    np.testing.assert_allclose(theat.y0.numpy(), np.asarray(jheat.y0), rtol=1e-15, atol=1e-17)


def test_solve_on_collocation_matches_jax(mixin_problems):
    """LinearWhiteNoiseEK1 on the collocation problem, in each package.
    Measured: mean 1.1e-14, covariance Gram 4.6e-14, diffusion 1.2e-15
    relative; the bounds of 1e-9 leave four digits of margin."""
    jheat, theat = mixin_problems
    jsol = jwhite.LinearWhiteNoiseEK1(steprule=jstep.Constant(0.1)).solve(jheat)
    sol = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.1)).solve(theat)
    assert _rel(sol.mean.numpy(), np.asarray(jsol.mean)) <= 1e-9
    assert _rel(_gram(sol.cov_sqrtm[-1]), _gram(jsol.cov_sqrtm[-1])) <= 1e-9
    np.testing.assert_allclose(float(sol.diffusion_squared_calibrated),
                               float(jsol.diffusion_squared_calibrated), rtol=1e-9)
    # heat decays on the collocation operator too
    assert sol.mean[-1, 0].abs().max() < sol.mean[0, 0].abs().max()
    assert tgram.gram_radial.launches == 0  # CPU: the plain Gram


def test_mixin_collocation_raises_where_jax_returns_nan():
    """The mixin's nugget 1e-12 on E is too small at N = 128 (ROADMAP queue
    3): JAX's Cholesky returns a factor whose lower triangle is all NaN,
    and torch.linalg.cholesky raises instead."""
    kernel_args = dict(stencil_size_interior=3, stencil_size_boundary=3, scheme="collocation")
    jheat = jexamples.heat_1d(tmax=0.5)
    jheat.discretize(
        mesh_spatial=jmesh.RectangularMesh.from_bbox_1d([0.0, 1.0], step=1 / 127),
        kernel=jkernels.SquareExponential(input_scale=5.0), **kernel_args,
    )
    assert np.isnan(np.asarray(jheat.E_sqrtm)[np.tril_indices(128)]).all()
    theat = pt.pde.examples.heat_1d(tmax=0.5)
    with pytest.raises(torch.linalg.LinAlgError):
        theat.discretize(
            mesh_spatial=pt.mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], step=1 / 127,
                                                              device="cpu"),
            kernel=pt.kernels.SquareExponential(input_scale=5.0), **kernel_args,
        )
