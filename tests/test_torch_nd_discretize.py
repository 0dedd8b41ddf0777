"""The port's FD discretization on n-D meshes against the JAX package:
``fd_probabilistic`` on 2-D grids (the stencil-offset dedupe included),
the n-D Neumann operator ``fd_probabilistic_neumann`` (weights and
uncertainties, the Matern52 patch at coincidence), and the recovery of a
known normal derivative.

Tolerances are relative to the largest entry of JAX's matrix. Where the
stencil Gram is near-singular (the JAX defaults ``SquareExponential()`` with
9-point stencils at dx = 1/11), LAPACK's and XLA's Cholesky solves part in
the last bits of the Gram and the weights agree only to its conditioning:
measured 3.1e-8 on ``L`` and 9.7e-9 on ``B`` at 12 x 12, so those are held
to 1e-7. A dx-adapted kernel keeps the 5-point Gram well conditioned, and
there the weights agree to 1e-11 (measured 1.8e-12 to 1.9e-12); the 7-point
3-D stencils at the same input scale are conditioned about 0.15^-12 ~ 1e10
(measured 2.0e-9), so they too are held to 1e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu import discretize as jdiscretize
from pnmol_tpu import diffops as jdiffops
from pnmol_tpu import kernels as jkernels
from pnmol_tpu import mesh as jmesh
import pnmol_tpu_torch as pt

torch.set_num_threads(1)

CPU = "cpu"
UNIT = [[0.0, 1.0], [0.0, 1.0]]
NEAR_SINGULAR, CONDITIONED = 1e-7, 1e-11


def meshes(n, dim=2):
    box = [[0.0, 1.0]] * dim
    return (pt.mesh.RectangularMesh.from_bbox_nd(box, nums=(n,) * dim, device=CPU),
            jmesh.RectangularMesh.from_bbox_nd(box, nums=(n,) * dim))


def se(module, scale=None):
    return module.SquareExponential() if scale is None else module.SquareExponential(
        input_scale=scale)


def assert_rel(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


# name: (side, dim, input scale times dx (None: the JAX default 1.0),
# interior and boundary stencils, nugget, tolerance on L, on E_sqrtm)
FD_CASES = {
    "12x12-jax-defaults": (12, 2, None, 9, 5, 1e-12, NEAR_SINGULAR, CONDITIONED),
    "48x48-dx-adapted": (48, 2, 0.15, 5, 5, 1e-10, CONDITIONED, CONDITIONED),
    "6^3-dx-adapted": (6, 3, 0.15, 7, 7, 1e-10, NEAR_SINGULAR, CONDITIONED),
}


@pytest.mark.parametrize("case", sorted(FD_CASES))
def test_fd_probabilistic_on_nd_grids_matches_jax(case):
    n, dim, scale, s_int, s_bnd, nugget, tol_L, tol_E = FD_CASES[case]
    tm, jm = meshes(n, dim)
    scale = None if scale is None else scale * (n - 1)
    kwargs = dict(stencil_size_interior=s_int, stencil_size_boundary=s_bnd,
                  nugget_gram_matrix=nugget)
    L, E = pt.discretize.fd_probabilistic(pt.diffops.laplace(), tm, kernel=se(pt.kernels, scale),
                                          **kwargs)
    jL, jE = jdiscretize.fd_probabilistic(jdiffops.laplace(), jm,
                                          kernel=se(jkernels, scale), **kwargs)
    assert_rel(L, jL, tol_L)
    assert_rel(E, jE, tol_E)
    # the sparsity pattern is the stencils': equal, not close
    np.testing.assert_array_equal(L.numpy() != 0, np.asarray(jL) != 0)


@pytest.mark.parametrize("n,dim,stencil", [(12, 2, 9), (48, 2, 5), (6, 3, 7), (6, 3, 11)])
def test_dedupe_offsets_matches_jax(n, dim, stencil):
    """Equal patterns and equal assignment: the patterns are ordered offsets,
    so how many there are depends on the k-NN's tie-break among equidistant
    neighbours, which both packages share."""
    tm, jm = meshes(n, dim)
    _, t_idx = tm.neighbours(point=tm.interior[0], num=stencil)
    _, j_idx = jm.neighbours(point=jm.interior[0], num=stencil)
    offsets, inverse = pt.discretize._dedupe_offsets(tm._points_host, tm.interior[2], t_idx)
    j_offsets, j_inverse = jdiscretize._dedupe_offsets(jm._points_host, jm.interior[2], j_idx)
    np.testing.assert_array_equal(offsets, j_offsets)
    np.testing.assert_array_equal(inverse, j_inverse)


# name: (side, kernel of a kernels module at that dx, stencil, tolerance)
NEUMANN_CASES = {
    "7x7-matern52": (7, lambda k, dx: k.Matern52(input_scale=5.0), 9, CONDITIONED),
    "12x12-jax-default-kernel": (12, lambda k, dx: k.SquareExponential(), 9, NEAR_SINGULAR),
    "12x12-dx-adapted": (12, lambda k, dx: k.SquareExponential(input_scale=0.5 / dx), 9,
                         CONDITIONED),
    "8x8-3-point": (8, lambda k, dx: k.SquareExponential(input_scale=0.5 / dx), 3,
                    CONDITIONED),
}


@pytest.mark.parametrize("case", sorted(NEUMANN_CASES))
def test_fd_probabilistic_neumann_matches_jax(case):
    n, kernel, stencil, tol = NEUMANN_CASES[case]
    tm, jm = meshes(n)
    dx = 1.0 / (n - 1)
    B, R = pt.discretize.fd_probabilistic_neumann(
        tm, kernel=kernel(pt.kernels, dx), stencil_size=stencil, nugget_gram_matrix=1e-12)
    jB, jR = jdiscretize.fd_probabilistic_neumann(
        jm, kernel=kernel(jkernels, dx), stencil_size=stencil, nugget_gram_matrix=1e-12)
    assert B.shape == (4 * n - 4, n * n) and R.shape == (4 * n - 4,) * 2
    assert not torch.isnan(B).any() and not torch.isnan(R).any()
    assert_rel(B, jB, tol)
    assert_rel(R, jR, tol)
    np.testing.assert_array_equal(B.numpy() != 0, np.asarray(jB) != 0)
    np.testing.assert_array_equal(R.numpy(), np.diag(np.diag(R.numpy())))


def test_neumann_matern52_patch_at_coincidence():
    """Matern52 autodiffs to NaN at zero distance: the operator takes the
    removable singularity's values, grad 0 and n . H n = (5/3) s^2 r^2."""
    kernel = pt.kernels.Matern52(input_scale=5.0, output_scale=1.5)
    grad_x = torch.func.grad(lambda x, y: kernel.pairwise(x, y).squeeze(), argnums=0)
    x = torch.tensor([0.0, 1.0], dtype=torch.float64)
    assert torch.isnan(grad_x(x, x)).any()
    tm, _ = meshes(7)
    B, R = pt.discretize.fd_probabilistic_neumann(tm, kernel=kernel, stencil_size=1)
    # a one-point stencil is the point itself: weight 0, uncertainty n.H.n
    np.testing.assert_array_equal(B.numpy(), 0.0)
    np.testing.assert_allclose(torch.diag(R).numpy(), 5.0 / 3.0 * 1.5**2 * 5.0**2, rtol=1e-15)


def test_neumann_recovers_a_known_normal_derivative():
    """B u approximates du/dn of u = x^2 + 2 y^2 on the faces of a 21 x 21
    grid, to JAX's 0.05; the weights are held to JAX's at the nugget-bound
    conditioning of this kernel (input scale 0.05/dx, 9-point stencils:
    measured 8.8e-6 relative at 12 x 12), 1e-4."""
    num = 21
    dx = 1.0 / (num - 1)
    tm, jm = meshes(num)
    B, R = pt.discretize.fd_probabilistic_neumann(
        tm, kernel=pt.kernels.SquareExponential(input_scale=0.05 / dx), stencil_size=9,
        nugget_gram_matrix=1e-12)
    jB, _ = jdiscretize.fd_probabilistic_neumann(
        jm, kernel=jkernels.SquareExponential(input_scale=0.05 / dx), stencil_size=9,
        nugget_gram_matrix=1e-12)
    assert_rel(B, jB, 1e-4)
    x, y = tm.points[:, 0], tm.points[:, 1]
    du_dn = (B @ (x**2 + 2.0 * y**2)).numpy()
    pts, normals = tm.boundary[0].numpy(), tm.boundary_normals.numpy()
    exact = normals[:, 0] * 2 * pts[:, 0] + normals[:, 1] * 4 * pts[:, 1]
    face = np.linalg.norm(normals, ord=np.inf, axis=1) == 1.0  # the corners left out
    np.testing.assert_allclose(du_dn[face], exact[face], atol=0.05)
    assert float(torch.diag(R).min()) >= -1e-10
    j_du_dn = np.asarray(jB @ jnp.asarray(tm.points.numpy()[:, 0] ** 2
                                          + 2.0 * tm.points.numpy()[:, 1] ** 2))
    np.testing.assert_allclose(du_dn, j_du_dn, rtol=0, atol=1e-4 * np.abs(j_du_dn).max())
