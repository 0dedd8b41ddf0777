"""Distributed white- and latent-solver initialization over a rank mesh.

Counterpart of :mod:`pnmol_tpu.parallel.sharded_init`: the prior Gram is
assembled row-sharded (:func:`sharded_linalg.sharded_gram`), every (d, d)
Cholesky runs through the distributed panel Cholesky and the closed-form y0
gain ``W = s^2 G (s^2 G + nugget^2 I)^{-1}`` through the distributed
cho_solve, and the init PDE update on the derivative-{0,1} sub-state runs
the distributed blocked panel QR (:func:`sharded_linalg.blocked_qr_r`, R
replicated) with the gain through the column-sharded triangular solve.

Outputs: the mean replicated, the covariance factor ``C0`` column-sharded
(the layout of the distributed-QR steps; its column basis is the
derivative-major one, only its Gram matters) and ``chol_gram`` row-sharded.
Where the JAX tier lets GSPMD assemble the update's operands from the
row-sharded factors, the port gathers ``C00`` and ``chol_gram`` (layout
collectives) and cuts each rank's columns of the pre-array's factors.
"""

import torch

from pnmol_tpu_torch import kernels as kernels_module
from pnmol_tpu_torch.ops import iwp
from pnmol_tpu_torch.parallel import meshes, sharded_filter, sharded_linalg
from pnmol_tpu_torch.solvers import latent as latent_module
from pnmol_tpu_torch.solvers import white as white_module


def _sizes(n, mesh, axis):
    return meshes.block_sizes(n, mesh.shape[axis])


def sharded_update_from_products(HC, C, meascov_sqrtm, mesh, axis="space", panel_size=None):
    """Distributed :func:`pnmol_tpu_torch.ops.sqrt.update_sqrt_from_products`
    on column blocks (``HC`` (m, c), ``C`` (D, c), ``meascov_sqrtm`` (m,
    c')): the rank's rows of the (D + m, m + D) pre-array factorized by the
    blocked panel QR, the gain by the column-sharded triangular solve and
    gathered. Returns ``(posterior (D, D), gain (D, m), innovation factor)``,
    replicated."""
    m, D = HC.shape[0], C.shape[0]
    top = torch.cat((HC.T, C.T), dim=1)
    bottom = torch.cat((meascov_sqrtm.T, HC.new_zeros((meascov_sqrtm.shape[1], D))), dim=1)
    R = sharded_linalg.blocked_qr_r(torch.cat((top, bottom)), mesh, axis=axis,
                                    panel_size=panel_size)
    start, stop = mesh.bounds(D, axis)
    gain_cols = sharded_linalg.sharded_triangular_solve(R[:m, :m], R[:m, m + start:m + stop],
                                                        mesh, axis)
    gain = mesh.gather_rows(gain_cols.T, _sizes(D, mesh, axis), axis)
    return R[m:, m:].T, gain, R[:m, :m].T


def _prior_phase(gram, y0, s, nug, mesh, axis, panel_size):
    """Gram Cholesky and closed-form y0 gain (the semantics of
    ``structured_init_y0``), every (d, d) object row-sharded: returns
    ``(chol_gram rows, u0 replicated, C00 rows)``."""
    d = gram.shape[1]
    start, stop = mesh.bounds(d, axis)
    local = torch.arange(stop - start, device=gram.device)
    S0 = s**2 * gram
    S0[local, start + local] += nug**2
    L_S0 = sharded_linalg.blocked_cholesky(S0, mesh, axis, panel_size)
    del S0
    # W = s^2 G S0^{-1}: G and S0 share an eigenbasis, so W is symmetric
    W = s**2 * sharded_linalg.blocked_cho_solve(L_S0, gram, mesh, axis, panel_size)
    del L_S0
    u0 = mesh.gather_rows(W @ y0, _sizes(d, mesh, axis), axis)
    W_sym = 0.5 * (W + mesh.transpose_rows(W, (d, d), axis))
    del W
    C00 = nug * sharded_linalg.blocked_cholesky(W_sym, mesh, axis, panel_size)
    chol_gram = sharded_linalg.blocked_cholesky(gram, mesh, axis, panel_size)
    return chol_gram, u0, C00


def _reduced_update(blocks, HCsub, noise, z_pde, u0, mesh, axis, panel_size):
    """The init PDE update on the derivative-{0,1} sub-state
    (:func:`pnmol_tpu_torch.solvers.white.reduced_init_pde_update`) through
    :func:`sharded_update_from_products`, with the gain contract. Returns
    the point-major ``m0_flat`` and this rank's columns of ``C0``."""
    d_ = blocks[0].shape[0]
    n = len(blocks)
    m = HCsub.shape[0]
    Csub = torch.block_diag(blocks[0], blocks[1])
    s0, s1 = mesh.bounds(2 * d_, axis)
    n0, n1 = mesh.bounds(m, axis)
    C0sub, kgain, _ = sharded_update_from_products(HCsub[:, s0:s1], Csub[:, s0:s1],
                                                   noise[:, n0:n1], mesh, axis, panel_size)
    corr = kgain @ z_pde
    m0_dm = torch.cat((u0 - corr[:d_], -corr[d_:], u0.new_zeros(d_ * (n - 2))))
    # this rank's columns of blockdiag(C0sub, blocks[2:]), rows to point-major
    D = n * d_
    c0, c1 = mesh.bounds(D, axis)
    cols = u0.new_zeros((D, c1 - c0))
    parts = [(0, 2 * d_, C0sub)] + [(k * d_, (k + 1) * d_, blocks[k]) for k in range(2, n)]
    for lo, hi, block in parts:
        a, b = max(lo, c0), min(hi, c1)
        if a < b:
            cols[lo:hi, a - c0:b - c0] = block[:, a - lo:b - lo]
    perm = iwp.point_major_perm(n, d_, device=u0.device)
    return m0_dm[perm], cols[perm]


def _default_kernel(kernel):
    return kernel if kernel is not None else kernels_module.Matern52() + kernels_module.WhiteNoise()


def sharded_white_initialize(pde, mesh, *, num_derivatives=2, spatial_kernel=None,
                             diffuse_scale=1.0, nugget=None, panel_size=None, f=None, df=None,
                             linear=True, axis="space"):
    """Distributed counterpart of the white solvers' ``initialize``.

    Returns ``(mean0 (n, d) replicated, C0 the rank's columns of the (D, D)
    factor, chol_gram the rank's rows of the (d, d) Gram factor)``: mean to
    roundoff of the single-device init, the factor equal in Gram.
    """
    kernel = _default_kernel(spatial_kernel)
    n = num_derivatives + 1
    d = pde.L.shape[0]
    y0 = pde.y0
    nug = 1e-10 if nugget is None else float(nugget)
    s = float(diffuse_scale)

    gram = sharded_linalg.sharded_gram(kernel, pde.mesh_spatial.points, mesh, axis)
    chol_gram, u0, C00 = _prior_phase(gram, y0, s, nug, mesh, axis, panel_size)
    del gram
    C00_full = mesh.gather_rows(C00, _sizes(d, mesh, axis), axis)
    B1 = s * mesh.gather_rows(chol_gram, _sizes(d, mesh, axis), axis)
    L, B = pde.L, pde.B
    if linear:
        G_lin, z_ode = L, -L @ u0
    else:
        G_lin = df(pde.t0, u0) + L
        z_ode = -L @ u0 - f(pde.t0, u0)
    z_pde = torch.cat((z_ode, B @ u0))
    b_rows = B.shape[0]
    HCsub = torch.cat((
        torch.cat((-G_lin @ C00_full, B1), dim=1),
        torch.cat((B @ C00_full, u0.new_zeros((b_rows, d))), dim=1),
    ))
    E_bc = torch.block_diag(pde.E_sqrtm, pde.R_sqrtm)
    E_bc.diagonal().add_(nug)
    m0_flat, C0 = _reduced_update([C00_full] + [B1] * (n - 1), HCsub, E_bc, z_pde, u0, mesh,
                                  axis, panel_size)
    return iwp.flat_to_mean(m0_flat, n), C0, chol_gram


def sharded_latent_initialize(pde, mesh, *, num_derivatives=2, spatial_kernel=None,
                              diffuse_scale=1.0, nugget=None, panel_size=None, f=None, df=None,
                              linear=True, axis="space"):
    """Distributed counterpart of the latent solvers' ``initialize``: the
    stacked (state | latent) pre-array at twice the point count, through the
    same primitives. Returns ``(mean0 (n, 2d) replicated, C0 the rank's
    columns of the (2D, 2D) factor, chol_gram the rank's rows)``."""
    kernel = _default_kernel(spatial_kernel)
    n = num_derivatives + 1
    d = pde.L.shape[0]
    y0 = pde.y0
    nug = 1e-6 if nugget is None else float(nugget)
    s = float(diffuse_scale)

    gram = sharded_linalg.sharded_gram(kernel, pde.mesh_spatial.points, mesh, axis)
    chol_gram, u0, C00 = _prior_phase(gram, y0, s, nug, mesh, axis, panel_size)
    del gram
    C00_full = mesh.gather_rows(C00, _sizes(d, mesh, axis), axis)
    cg_full = mesh.gather_rows(chol_gram, _sizes(d, mesh, axis), axis)
    E = pde.E_sqrtm
    # derivative 0 = blockdiag(C00, s E), derivatives >= 1 = blockdiag(s chol_gram, s E)
    B0 = torch.block_diag(C00_full, s * E)
    B1 = torch.block_diag(s * cg_full, s * E)
    L, B = pde.L, pde.B
    if linear:
        G_lin, z_ode = L, -L @ u0
    else:
        G_lin = df(pde.t0, u0) + L
        z_ode = -L @ u0 - f(pde.t0, u0)
    z_pde = torch.cat((z_ode, B @ u0))
    b_rows = B.shape[0]
    # ode rows = X1_state - G X0_state - X0_eps, bc rows = B X0_state
    HCsub = torch.cat((
        torch.cat((-G_lin @ C00_full, -s * E, s * cg_full, u0.new_zeros((d, d))), dim=1),
        torch.cat((B @ C00_full, u0.new_zeros((b_rows, 3 * d))), dim=1),
    ))
    m_dim = d + b_rows
    nugget_pde = nug * torch.eye(m_dim, dtype=u0.dtype, device=u0.device)
    u0_stack = torch.cat((u0, u0.new_zeros(d)))
    m0_flat, C0 = _reduced_update([B0] + [B1] * (n - 1), HCsub, nugget_pde, z_pde, u0_stack,
                                  mesh, axis, panel_size)
    m0_state, m0_latent = m0_flat.chunk(2)
    mean0 = torch.cat((iwp.flat_to_mean(m0_state, n), iwp.flat_to_mean(m0_latent, n)), dim=1)
    return mean0, C0, chol_gram


def _noise_factor_columns(spatial, num_derivatives, mesh, axis):
    """The rank's columns of ``kron(spatial, LQ1d)`` (point-major) from the
    full spatial factor."""
    n = num_derivatives + 1
    D = n * spatial.shape[0]
    c0, c1 = mesh.bounds(D, axis)
    _, LQ1d = iwp.system_matrices_1d(num_derivatives, dtype=spatial.dtype, device=spatial.device)
    j0, j1 = c0 // n, -(-c1 // n)
    return torch.kron(spatial[:, j0:j1], LQ1d)[:, c0 - j0 * n:c1 - j0 * n].contiguous()


def _placed(cache):
    """Layouts of a distributed-QR cache: ``Ql`` column-sharded, the rest
    replicated."""
    layouts = {k: meshes.replicated() for k in cache._fields}
    layouts["Ql"] = meshes.column_sharding()
    return layouts


def sharded_white_cache(pde, chol_gram, mesh, *, num_derivatives=2, axis="space"):
    """The white step cache with ``Ql = kron(chol_gram, LQ1d)`` built
    column-sharded from the row-sharded ``chol_gram`` (gathered: a layout
    collective), the small operands replicated; a
    :class:`~pnmol_tpu_torch.parallel.sharded_filter.ShardedCache` for the
    distributed-QR step."""
    d = pde.L.shape[0]
    n = num_derivatives + 1
    cg = mesh.gather_rows(chol_gram, _sizes(d, mesh, axis), axis)
    A1d, _ = iwp.system_matrices_1d(num_derivatives, dtype=cg.dtype, device=cg.device)
    E_bc = torch.block_diag(pde.E_sqrtm, pde.R_sqrtm)
    local = white_module.WhiteSolverCache(
        A1d=A1d, Ql=_noise_factor_columns(cg, num_derivatives, mesh, axis), L=pde.L, B=pde.B,
        E_bc_sqrtm=E_bc,
    )
    shapes = {k: tuple(v.shape) for k, v in local._asdict().items()}
    shapes["Ql"] = (n * d, n * d)
    return sharded_filter.ShardedCache(local=local, layouts=_placed(local), shapes=shapes)


def sharded_latent_cache(pde, chol_gram, mesh, *, num_derivatives=2, axis="space"):
    """The latent step cache with the stacked ``Ql = kron(blockdiag(chol_gram,
    E_sqrtm), LQ1d)`` built column-sharded."""
    d = pde.L.shape[0]
    n = num_derivatives + 1
    cg = mesh.gather_rows(chol_gram, _sizes(d, mesh, axis), axis)
    A1d, _ = iwp.system_matrices_1d(num_derivatives, dtype=cg.dtype, device=cg.device)
    spatial = torch.block_diag(cg, pde.E_sqrtm)
    local = latent_module.LatentSolverCache(
        A1d=A1d, Ql=_noise_factor_columns(spatial, num_derivatives, mesh, axis), L=pde.L,
        B=pde.B,
    )
    shapes = {k: tuple(v.shape) for k, v in local._asdict().items()}
    shapes["Ql"] = (2 * n * d, 2 * n * d)
    return sharded_filter.ShardedCache(local=local, layouts=_placed(local), shapes=shapes)
