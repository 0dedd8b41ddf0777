"""Probabilistic finite differences and global collocation (counterpart of
the FD and collocation paths of :mod:`pnmol_tpu.discretize`).

Kernel (RKHS) finite differences give a differentiation matrix ``L`` and a
diagonal discretization-error factor ``E_sqrtm``. The per-stencil systems
are solved in one ``torch.func.vmap`` batch; for stationary kernels only the
distinct neighbour-offset patterns are solved (O(1) on a uniform grid).
One-sided two-point stencils give the 1-D Neumann boundary operator, and
stencils along each boundary point's outward normal the n-D one.
Global collocation gives a dense ``L`` and a dense Cholesky ``E_sqrtm`` from
three N x N Grams, of which the kernel's own reaches the CUDA Gram kernel.
:func:`dx_adapted_input_scale` ties the kernel's input scale to the mesh.
"""

from functools import partial

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from pnmol_tpu_torch import diffops, kernels


def _matern52_point_patches(kernel):
    """MacLaurin values of the Matern52 derivatives at x == y, where
    autodiff through the Laplacian gives NaN."""
    s2 = kernel.output_scale**2
    r2 = kernel.input_scale**2
    lk_at_zero = s2 * r2 * 2.5 / (1.0 - 2.5)
    llk_at_zero = s2 * r2**2 * 3.0 * 2.5**2 / (2.0 - 3.0 * 2.5 + 2.5**2)
    return lk_at_zero, llk_at_zero


def _differentiate_kernel(diffop, kernel):
    """Push a differential operator through a kernel: L_k and (L x L)_k."""
    L_kx = kernels.Lambda(diffop(kernel.pairwise, argnums=0))
    LL_kx = kernels.Lambda(diffop(L_kx.pairwise, argnums=1))
    return L_kx, LL_kx


def fd_coefficients(x, neighbors, k, L_k, LL_k, nugget_gram_matrix=0.0):
    """Kernel-FD weights and uncertainty for one stencil: solve
    ``K(X, X) w = (L k)(x, X)``; uncertainty ``(L L k)(x, x) - w . (L k)(x, X)``."""
    X, s = neighbors, neighbors.shape[0]
    gram = k(X, X.T) + nugget_gram_matrix * torch.eye(s, dtype=X.dtype, device=X.device)
    lk_at_x = L_k(x[None, :], X.T).reshape(-1)
    llk_at_x = LL_k(x, x).reshape(())

    if isinstance(k, kernels.Matern52):
        lk_zero, llk_zero = _matern52_point_patches(k)
        lk_at_x = torch.nan_to_num(lk_at_x, nan=lk_zero)
        llk_at_x = torch.nan_to_num(llk_at_x, nan=llk_zero)

    chol = torch.linalg.cholesky(gram)
    weights = torch.cholesky_solve(lk_at_x[:, None], chol).reshape(-1)
    uncertainty = llk_at_x - weights @ lk_at_x
    return weights, uncertainty


def _dedupe_offsets(points_host, point_indices, neighbor_indices):
    """Host-side dedupe of stencil offset patterns: (representative offsets
    (U, s, dim) float64, inverse (n,)), from the f64 host geometry."""
    pt_idx = np.asarray(point_indices.cpu())
    nb_idx = np.asarray(neighbor_indices.cpu())
    off = points_host[nb_idx] - points_host[pt_idx][:, None, :]
    scale = np.abs(off).max()
    if scale == 0.0:
        scale = 1.0
    quant = np.round(off / scale * 1e9).astype(np.int64).reshape(off.shape[0], -1)
    _, first, inverse = np.unique(quant, axis=0, return_index=True, return_inverse=True)
    return off[first], inverse.reshape(-1)


def _stencil_coefficients(coeff_batch, mesh_spatial, points, point_indices,
                          neighbors, neighbor_indices, dedupe):
    """Per-point FD weights/uncertainties, deduped for stationary kernels."""
    if not dedupe or points.shape[0] == 0:
        return coeff_batch(points, neighbors)
    rep_offsets, inverse = _dedupe_offsets(
        mesh_spatial._points_host, point_indices, neighbor_indices
    )
    dtype, device = points.dtype, points.device
    zeros = torch.zeros((rep_offsets.shape[0], rep_offsets.shape[2]), dtype=dtype, device=device)
    w_u, u_u = coeff_batch(zeros, torch.tensor(rep_offsets, dtype=dtype, device=device))
    inv = torch.as_tensor(inverse, device=device)
    return w_u[inv], u_u[inv]


def fd_probabilistic(diffop, mesh_spatial, kernel=None, stencil_size_interior=3,
                     stencil_size_boundary=3, nugget_gram_matrix=0.0,
                     stencil_dedupe="auto"):
    """Discretize ``diffop`` with probabilistic finite differences.

    Returns ``L`` (N, N), one stencil row per mesh point, and the diagonal
    error factor ``E_sqrtm`` (N, N), on the mesh's device.
    """
    if kernel is None:
        kernel = kernels.SquareExponential(input_scale=1.0, output_scale=1.0)

    L_kx, LL_kx = _differentiate_kernel(diffop, kernel)
    coeff_batch = vmap(
        partial(
            fd_coefficients, k=kernel, L_k=L_kx, LL_k=LL_kx,
            nugget_gram_matrix=nugget_gram_matrix,
        )
    )
    dedupe = (
        bool(stencil_dedupe)
        if stencil_dedupe != "auto"
        else getattr(kernel, "stationary", False)
    )

    points_interior, _, indices_interior = mesh_spatial.interior
    points_boundary, _, indices_boundary = mesh_spatial.boundary
    neighbors_interior, neighbor_idx_interior = mesh_spatial.neighbours(
        point=points_interior, num=stencil_size_interior
    )
    neighbors_boundary, neighbor_idx_boundary = mesh_spatial.neighbours(
        point=points_boundary, num=stencil_size_boundary
    )

    w_int, u_int = _stencil_coefficients(
        coeff_batch, mesh_spatial, points_interior, indices_interior,
        neighbors_interior, neighbor_idx_interior, dedupe,
    )
    w_bnd, u_bnd = _stencil_coefficients(
        coeff_batch, mesh_spatial, points_boundary, indices_boundary,
        neighbors_boundary, neighbor_idx_boundary, dedupe,
    )

    N = len(mesh_spatial)
    points = mesh_spatial.points
    L = torch.zeros((N, N), dtype=points.dtype, device=points.device)
    E_sqrtm = torch.zeros((N, N), dtype=points.dtype, device=points.device)
    L[indices_boundary[:, None], neighbor_idx_boundary] = w_bnd
    L[indices_interior[:, None], neighbor_idx_interior] = w_int
    E_sqrtm[indices_boundary, indices_boundary] = u_bnd
    E_sqrtm[indices_interior, indices_interior] = u_int
    return L, E_sqrtm


def fd_probabilistic_neumann_1d(mesh_spatial, kernel=None, stencil_size=2,
                                nugget_gram_matrix=0.0):
    """Kernel-FD outward normal derivative at a 1-D mesh's two boundary
    points: two-point one-sided stencils, the left weights negated.
    Returns ``(B (2, N), R_sqrtm (2, 2))`` on the mesh's device."""
    if stencil_size != 2:
        raise NotImplementedError("1-D Neumann stencils have two points")
    if kernel is None:
        kernel = kernels.SquareExponential(input_scale=1.0, output_scale=1.0)

    L_k, LL_k = _differentiate_kernel(diffops.gradient(), kernel)
    points = mesh_spatial.points

    def one_sided(idx_x, idx_neighbors):
        return fd_coefficients(
            x=points[idx_x], neighbors=points[list(idx_neighbors)], k=kernel,
            L_k=L_k, LL_k=LL_k, nugget_gram_matrix=nugget_gram_matrix,
        )

    weights_left, uncertainty_left = one_sided(0, (0, 1))
    weights_right, uncertainty_right = one_sided(-1, (-1, -2))

    # projection onto (left point, its neighbour, right point, its neighbour)
    N = len(mesh_spatial)
    eye = torch.eye(N, dtype=points.dtype, device=points.device)
    B_select = eye[[0, 1, N - 1, N - 2]]
    diffmatrix = torch.block_diag(-weights_left[None, :], weights_right[None, :])
    errormatrix = torch.diag(torch.stack([uncertainty_left, uncertainty_right]))
    return diffmatrix @ B_select, errormatrix


def fd_probabilistic_neumann(mesh_spatial, kernel=None, stencil_size=3,
                             nugget_gram_matrix=0.0):
    """Kernel-FD outward normal derivative in any spatial dimension.

    Per boundary point, the stencil system is solved for the directional
    derivative along that point's outward normal
    (``mesh_spatial.boundary_normals``); the normals are data, so all
    boundary points batch in one ``torch.func.vmap``. Returns
    ``(B (b, N), R_sqrtm (b, b))`` on the mesh's device, like the 1-D
    variant.
    """
    if kernel is None:
        kernel = kernels.SquareExponential(input_scale=1.0, output_scale=1.0)

    pairwise = kernel.pairwise
    grad_x = grad(lambda x, y: pairwise(x, y).squeeze(), argnums=0)
    hess_xy = jacfwd(grad_x, argnums=1)

    # the Matern52 removable singularity at zero distance (autodiff gives
    # NaN there, as in fd_coefficients): the gradient of an even radial
    # kernel is 0 at coincidence, and d_x d_y k is (5/3) s^2 r^2 I there, so
    # n . H n = (5/3) s^2 r^2 for a unit normal
    is_matern = isinstance(kernel, kernels.Matern52)
    if is_matern:
        hess_at_zero = 5.0 / 3.0 * kernel.output_scale**2 * kernel.input_scale**2

    def one_point(x, neighbors, normal):
        s = neighbors.shape[0]
        gram = kernel(neighbors, neighbors.T) + nugget_gram_matrix * torch.eye(
            s, dtype=x.dtype, device=x.device)
        lk = vmap(lambda xj: torch.dot(normal, grad_x(x, xj)))(neighbors)
        llk = normal @ hess_xy(x, x) @ normal
        if is_matern:
            lk = torch.nan_to_num(lk, nan=0.0)
            llk = torch.where(torch.isnan(llk), hess_at_zero, llk)
        chol = torch.linalg.cholesky(gram)
        weights = torch.cholesky_solve(lk[:, None], chol).reshape(-1)
        return weights, llk - weights @ lk

    points_boundary, _, _ = mesh_spatial.boundary
    neighbors, neighbor_idx = mesh_spatial.neighbours(point=points_boundary, num=stencil_size)
    weights, uncertainties = vmap(one_point)(
        points_boundary, neighbors, mesh_spatial.boundary_normals)

    b = points_boundary.shape[0]
    B = weights.new_zeros((b, len(mesh_spatial)))
    B[torch.arange(b, device=B.device)[:, None], neighbor_idx] = weights
    return B, torch.diag(uncertainties)


def collocation_global(diffop, mesh_spatial, kernel=None, nugget_gram_matrix=0.0,
                       nugget_cholesky_E=0.0, symmetrize_cholesky_E=False):
    """Dense global (unsymmetric) collocation: ``D = (L_k K^{-1})^T`` and the
    Cholesky factor of the error covariance ``E = LL_k - D L_k^T``, both
    (N, N) on the mesh's device.

    ``K = k(X, X^T) + nugget_gram_matrix I`` is a radial Gram (the CUDA
    kernel at N >= 512 on a GPU); ``L_k`` and ``LL_k`` are the Grams of the
    kernel pushed through ``diffop`` once and twice (``torch.func``).
    ``torch.linalg.cholesky`` raises where ``E`` is not positive definite
    (the JAX package returns NaN there).
    """
    if kernel is None:
        kernel = kernels.SquareExponential(input_scale=1.0, output_scale=1.0)

    L_kx, LL_kx = _differentiate_kernel(diffop, kernel)

    points = mesh_spatial.points
    N = points.shape[0]
    eye = torch.eye(N, dtype=points.dtype, device=points.device)
    gram_k = kernel(points, points.T) + nugget_gram_matrix * eye
    gram_Lk = L_kx(points, points.T)
    gram_LLk = LL_kx(points, points.T)

    chol_k = torch.linalg.cholesky(gram_k)
    D = torch.cholesky_solve(gram_Lk.T, chol_k).T
    E = gram_LLk - D @ gram_Lk.T
    if symmetrize_cholesky_E:
        E = 0.5 * (E + E.T)
    E = E + nugget_cholesky_E * eye
    return D, torch.linalg.cholesky(E)


def dx_adapted_input_scale(mesh_spatial, target=1.0):
    """Input scale that keeps the stencil systems well conditioned at any dx:
    the conditioning of a kernel-FD stencil Gram grows like ``(input_scale *
    dx)^{-2(s-1)}``, so ``input_scale = target / fill_distance`` holds the
    product at O(1) on every mesh."""
    return float(target) / mesh_spatial.fill_distance
