"""The port's mesh, kernels, diffops and probabilistic FD against the JAX
package at the solver's shapes (dx = 0.2 and the full width dx = 1/511)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu import diffops as jdiffops
from pnmol_tpu import kernels as jkernels
from pnmol_tpu.models import examples as jexamples
import pnmol_tpu_torch as pt

torch.set_num_threads(1)

# The stencil Grams, kernel derivatives and Laplacians agree bit for bit;
# the two packages differ only in how they solve the 3x3 stencil systems
# (XLA's Cholesky and triangular-solve expanders against LAPACK), whose
# conditioning magnifies rounding. Measured: FD weights (L) agree to 5e-13
# relative at dx = 0.2 and 1.7e-12 at dx = 1/511, hence rtol 1e-11.
FD_RTOL = 1e-11
# E_sqrtm = llk - w . lk cancels: at dx = 1/511 the two terms are ~2e7 and
# E is ~1e2, so five digits go and no implementation pins E beyond ~1e-12
# relative to llk (measured 7.5e-13). The bound is 1e-11 relative to llk.
E_RTOL_OF_LLK = 1e-11


def _kernels(name, dx):
    if name == "se_default":
        return jkernels.SquareExponential(), pt.kernels.SquareExponential()
    if name == "se_dx_adapted":
        scale = 0.1 / dx
        return (jkernels.SquareExponential(input_scale=scale),
                pt.kernels.SquareExponential(input_scale=scale))
    return jkernels.Matern52(), pt.kernels.Matern52()


CASES = [(0.2, "se_default"), (0.2, "matern52"), (1.0 / 511, "se_dx_adapted")]


@pytest.fixture(scope="module", params=CASES, ids=["dx0.2-se", "dx0.2-matern52", "n512-se"])
def problems(request):
    dx, name = request.param
    jk, tk = _kernels(name, dx)
    jheat = jexamples.heat_1d_discretized(dx=dx, tmax=1.0, kernel=jk)
    theat = pt.pde.examples.heat_1d_discretized(dx=dx, tmax=1.0, kernel=tk, device="cpu")
    theat.fd_kernel = tk
    return jheat, theat


def test_mesh_matches_jax(problems):
    jheat, theat = problems
    jm, tm = jheat.mesh_spatial, theat.mesh_spatial
    np.testing.assert_array_equal(tm.points.numpy(), np.asarray(jm.points))
    for part in ("boundary", "interior"):
        jpts, jmask, jidx = getattr(jm, part)
        tpts, tmask, tidx = getattr(tm, part)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tm.fill_distance == jm.fill_distance
    _, jnb = jm.neighbours(point=jm.interior[0], num=3)
    _, tnb = tm.neighbours(point=tm.interior[0], num=3)
    np.testing.assert_array_equal(tnb.numpy(), np.asarray(jnb))
    np.testing.assert_array_equal(tm.boundary_projection_matrix.numpy(),
                                  np.asarray(jm.boundary_projection_matrix))


def test_fd_operators_match_jax(problems):
    jheat, theat = problems
    np.testing.assert_allclose(theat.L.numpy(), np.asarray(jheat.L), rtol=FD_RTOL, atol=0)
    _, LL_k = pt.discretize._differentiate_kernel(pt.diffops.laplace(), theat.fd_kernel)
    x0 = torch.zeros(1, dtype=torch.float64)
    llk = float(LL_k(x0, x0))
    if isinstance(theat.fd_kernel, pt.kernels.Matern52):  # NaN at 0: the patch value
        llk = pt.discretize._matern52_point_patches(theat.fd_kernel)[1]
    llk = theat.diffop_scale * abs(llk)
    np.testing.assert_allclose(theat.E_sqrtm.numpy(), np.asarray(jheat.E_sqrtm),
                               rtol=0, atol=E_RTOL_OF_LLK * llk)
    np.testing.assert_array_equal(theat.B.numpy(), np.asarray(jheat.B))
    np.testing.assert_array_equal(theat.R_sqrtm.numpy(), np.asarray(jheat.R_sqrtm))
    # the initial value is the same closed form evaluated on the same points
    np.testing.assert_allclose(theat.y0.numpy(), np.asarray(jheat.y0), rtol=1e-15, atol=1e-17)


def test_prior_gram_matches_jax(problems):
    jheat, theat = problems
    X, jX = theat.mesh_spatial.points, jheat.mesh_spatial.points
    gram = (pt.kernels.Matern52() + pt.kernels.WhiteNoise())(X, X.T)
    jgram = (jkernels.Matern52() + jkernels.WhiteNoise())(jX, jX.T)
    # pairwise evaluation of one closed form: agreement to rounding
    np.testing.assert_allclose(gram.numpy(), np.asarray(jgram), rtol=1e-12, atol=0)
    # equal-shape inputs give the diagonal
    np.testing.assert_allclose(
        (pt.kernels.Matern52() + pt.kernels.WhiteNoise())(X, X).numpy(), np.full(len(X), 2.0))


def test_kernel_laplacian_matches_jax():
    """laplace() pushed through a kernel (the FD right-hand side) agrees
    with JAX autodiff, for both arguments."""
    x = np.array([[0.3], [0.45], [0.7]])
    for jk, tk in ((jkernels.SquareExponential(input_scale=2.0),
                    pt.kernels.SquareExponential(input_scale=2.0)),
                   (jkernels.Matern52(), pt.kernels.Matern52())):
        jL = jkernels.Lambda(jdiffops.laplace()(jk.pairwise, argnums=0))
        tL = pt.kernels.Lambda(pt.diffops.laplace()(tk.pairwise, argnums=0))
        jLL = jkernels.Lambda(jdiffops.laplace()(jL.pairwise, argnums=1))
        tLL = pt.kernels.Lambda(pt.diffops.laplace()(tL.pairwise, argnums=1))
        xt = torch.from_numpy(x)
        np.testing.assert_allclose(tL(xt[:1], xt.T).numpy(), np.asarray(jL(x[:1], x.T)),
                                   rtol=1e-13)
        np.testing.assert_allclose(tLL(xt[0], xt[1]).numpy(), np.asarray(jLL(x[0], x[1])),
                                   rtol=1e-13)


def test_gradient_divergence_laplace():
    f = lambda t, x: torch.sum(x**3)  # noqa: E731
    x = torch.tensor([0.5, -1.0], dtype=torch.float64)
    grad = pt.diffops.gradient()(f, argnums=1)
    torch.testing.assert_close(grad(0.0, x), 3 * x**2)
    torch.testing.assert_close(pt.diffops.laplace()(f, argnums=1)(0.0, x), torch.sum(6 * x))
    torch.testing.assert_close(
        pt.diffops.divergence()(grad, argnums=1)(0.0, x), torch.sum(6 * x))


def test_out_of_slice_problem_options_raise():
    heat = pt.pde.examples.heat_1d(tmax=1.0)
    mesh = pt.mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], step=0.2, device="cpu")
    # the n-D Neumann operator is ported: with two-point stencils on a 1-D
    # mesh it is the 1-D operator, bit for bit
    for got, want in zip(pt.discretize.fd_probabilistic_neumann(mesh, stencil_size=2),
                         pt.discretize.fd_probabilistic_neumann_1d(mesh)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Unknown discretization scheme"):
        heat.discretize(mesh_spatial=mesh, kernel=pt.kernels.SquareExponential(),
                        stencil_size_interior=3, stencil_size_boundary=3,
                        scheme="bogus")


def test_fill_distance_above_the_brute_force_cutover_matches_jax():
    """3000 points: the native k-NN's nearest neighbours, as in the JAX mesh."""
    from pnmol_tpu import mesh as jmesh

    points = np.random.default_rng(3).uniform(size=(3000, 1))
    mesh = pt.mesh.RectangularMesh(points, device="cpu")
    assert mesh.fill_distance == jmesh.RectangularMesh(points).fill_distance
