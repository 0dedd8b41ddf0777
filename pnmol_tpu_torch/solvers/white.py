"""White-noise EK1 PDE filter for linear problems.

Counterpart of :mod:`pnmol_tpu.solvers.white` on the main path: the
discretization error enters as measurement noise, the prior is the
Gram-Cholesky IWP, the initialization is the closed-form y0 update followed
by one sqrt update on the PDE measurement, and each step runs ONE fused
pre-array factorization: ``torch.linalg.qr`` (``factorization=None``), the
Householder LQ with the CUDA panel kernel (``factorization="householder"``),
or a hook such as the R-form Householder QR with the CUDA leaf kernel
(:func:`pnmol_tpu_torch.ops.qr_householder.make_householder_factorization`).
The state lives in the point-major Nordsieck layout of
:mod:`pnmol_tpu_torch.ops.iwp`, so the measurement matrix ``H`` is never
materialized.
"""

from typing import NamedTuple

import torch

from pnmol_tpu_torch.ops import iwp, qr_householder, rv, sqrt
from pnmol_tpu_torch.solvers import pdefilter


class WhiteSolverCache(NamedTuple):
    """Per-problem constants of the white-noise step."""

    A1d: torch.Tensor  # (n, n) preconditioned 1-D transition
    Ql: torch.Tensor  # (D, D) preconditioned noise factor kron(chol_gram, LQ1d)
    L: torch.Tensor  # (d, d) differentiation matrix
    B: torch.Tensor  # (b, d) boundary operator
    E_bc_sqrtm: torch.Tensor  # (d + b, d + b) blockdiag(E_sqrtm, R_sqrtm)


def _measurement_operator(cache, G, p, n):
    """X -> H @ X for ``H = [p1 E1 - G (p0 E0); p0 B E0]`` in preconditioned
    coordinates, without materializing H."""

    def apply_H(X):
        X0s = p[0] * iwp.project_derivative(X, 0, n)
        ode_rows = p[1] * iwp.project_derivative(X, 1, n) - G @ X0s
        return torch.cat((ode_rows, cache.B @ X0s), dim=0)

    return apply_H


def _linearize(L, m_at):
    """EK1 linearization of a linear problem: (G, shift) = (L, 0)."""
    return L, torch.zeros_like(m_at)


def white_attempt_step(cache, mean, cov_sqrtm, t_next, dt, *, num_derivatives,
                       factorization=None):
    """One white-noise EK1 step of a linear problem.

    Returns ``(mean (n, d), cov_sqrtm (D, D), error_estimate (d,),
    reference (d,), diffusion_sq ())``. ``factorization`` is ``None`` (the
    fused pre-array QR), a hook with a ``.blocks`` attribute returning
    ``(posterior factor, L21, Sl)``, or a hook without one returning
    ``(posterior factor, gain, Sl)`` (the legacy gain contract).
    """
    n = num_derivatives + 1
    d = mean.shape[1]
    m_dim = d + cache.B.shape[0]
    p, p_inv = iwp.nordsieck_scales_1d(
        num_derivatives, dt, dtype=mean.dtype, device=mean.device
    )
    E_bc = cache.E_bc_sqrtm

    # [Precondition] and [Predict mean]
    M = mean * p_inv[:, None]
    Cl = iwp.scale_stack(p_inv, cov_sqrtm)
    Mp = cache.A1d @ M

    # [Linearize] at the predicted point; [Residual] z = H mp + [shift; 0]
    m_at = p[0] * Mp[0]
    G, shift = _linearize(cache.L, m_at)
    apply_H = _measurement_operator(cache, G, p, n)
    z = torch.cat((p[1] * Mp[1] - G @ m_at + shift, cache.B @ m_at))

    # [Error estimate] from S = H Q H^T + E E^T on the small (m, m) system
    HQl = apply_H(cache.Ql)
    S = HQl @ HQl.T + E_bc @ E_bc.T
    whitened = torch.cholesky_solve(z[:, None], torch.linalg.cholesky(S))[:, 0]
    sigma_squared = z @ whitened / m_dim
    error = dt * (torch.sqrt(torch.diagonal(S)) * torch.sqrt(sigma_squared))[:d]

    # [Predict + update covariance]: raw factor blocks (Cl_new, L21, Sl) with
    # S_xz = L21 Sl^T, so the gain L21 Sl^{-1} is never formed; a hook
    # without .blocks returns the gain K instead of L21
    ACl = iwp.apply_stack_matrix(cache.A1d, Cl)
    HACl = apply_H(ACl)
    K = None
    if factorization is None:
        Cl_new, L21, Sl = sqrt.fused_predict_update_blocks(HACl, ACl, HQl, cache.Ql, E_bc)
    elif hasattr(factorization, "blocks"):
        Cl_new, L21, Sl = factorization.blocks(HACl, ACl, HQl, cache.Ql, E_bc)
    else:
        Cl_new, K, Sl = factorization(HACl, ACl, HQl, cache.Ql, E_bc)

    # [Calibrate + mean update] whitened residual via the LOWER solve
    # Sl w = z (z^T S^{-1} z with S = Sl Sl^T, invariant to row signs)
    residual_white = torch.linalg.solve_triangular(Sl, z[:, None], upper=False)[:, 0]
    diffusion_sq = residual_white @ residual_white / m_dim
    correction = L21 @ residual_white if K is None else K @ z
    m_new_flat = iwp.mean_to_flat(Mp) - correction

    # [Un-precondition]
    M_new = iwp.flat_to_mean(m_new_flat, n) * p[:, None]
    C_new = iwp.scale_stack(p, Cl_new)
    return M_new, C_new, error, torch.abs(M_new[0]), diffusion_sq


def structured_init_y0(gram, chol_gram, y0, diffuse_scale, nugget, n):
    """Closed-form sqrt update of the Kronecker prior on the y0 observation.

    With ``S = s^2 G + nugget^2 I`` and ``W = s^2 G S^{-1}``, the posterior
    mean is ``W y0`` on derivative 0 and the posterior factor is
    derivative-block-diagonal: ``chol(nugget^2 W)`` on derivative 0 and
    ``s chol_gram`` on the others. Returns ``(u0 (d,), blocks)``.
    """
    s = float(diffuse_scale)
    S0 = s**2 * gram
    S0.diagonal().add_(nugget**2)
    S0_chol = torch.linalg.cholesky(S0)
    W = s**2 * torch.cholesky_solve(gram, S0_chol).T
    u0 = W @ y0
    C00 = nugget * torch.linalg.cholesky(0.5 * (W + W.T))
    return u0, [C00] + [s * chol_gram] * (n - 1)


def reduced_init_pde_update(blocks, HCsub, E_bc_nugget, z_pde, u0, update_blocks):
    """Initialization PDE update on the derivative-{0,1} sub-state.

    The init measurement touches only derivative blocks 0 and 1 of a
    derivative-block-diagonal prior factor, so the update runs on the
    ``(2d + m) x (m + 2d)`` sub-array and the higher derivative blocks pass
    through. ``update_blocks(HC, C, R) -> (posterior, L21, L1)``. Returns the
    point-major ``(m0_flat, C0)`` of the full state; C0 keeps the
    derivative-major column basis (only its Gram matters).
    """
    d_ = blocks[0].shape[0]
    n = len(blocks)
    Csub = torch.block_diag(blocks[0], blocks[1])
    C0sub, L21, L1 = update_blocks(HCsub, Csub, E_bc_nugget)
    corr = L21 @ torch.linalg.solve_triangular(L1, z_pde[:, None], upper=False)[:, 0]
    m0_dm = torch.cat(
        (u0 - corr[:d_], -corr[d_:], u0.new_zeros(d_ * (n - 2)))
    )
    bd = torch.block_diag(C0sub, *blocks[2:])
    perm = iwp.point_major_perm(n, d_, device=u0.device)
    return m0_dm[perm], bd[perm]


def point_major_blockdiag(blocks):
    """Per-derivative block-diagonal operator in the point-major layout:
    ``C[(i,k), (j,l)] = delta_kl blocks[k][i,j]``."""
    bd = torch.block_diag(*blocks)
    perm = iwp.point_major_perm(len(blocks), blocks[0].shape[0], device=bd.device)
    return bd[perm][:, perm]


def resolve_householder_hooks(d: int, *, pair_columns: bool = False):
    """(step factorization, init update) Householder-LQ hooks sized for a
    problem with ``d`` state points."""
    block = 256 if d >= 4096 else 128
    factorization = qr_householder.make_householder_lq_factorization(
        block=block, pair_columns=pair_columns
    )
    init_update = qr_householder.make_householder_update_from_products(block=block)
    return factorization, init_update


class LinearWhiteNoiseEK1(pdefilter.PDEFilter):
    """White-noise EK1 for linear evolution equations (Jx = L exactly).

    ``factorization``: ``None`` (fused pre-array ``torch.linalg.qr``),
    ``"householder"`` (the blocked Householder LQ with the CUDA panel
    kernel, for the step AND the initialization update), or a step hook
    (``make_householder_lq_factorization``, or the R-form
    ``make_householder_factorization`` with the CUDA leaf kernel, from
    :mod:`pnmol_tpu_torch.ops.qr_householder`); a hook leaves the
    initialization on the plain update, as in the JAX solver. The other
    options of the JAX solver raise ``NotImplementedError``.
    """

    def __init__(self, *args, meascov_dt_scaled=False, factorization=None,
                 fused=True, propagate_band=None, steady_state=False, **kwargs):
        super().__init__(*args, **kwargs)
        if meascov_dt_scaled:
            raise NotImplementedError(
                "meascov_dt_scaled is not ported yet (ROADMAP queue 1, item 10)"
            )
        if not fused or propagate_band is not None:
            raise NotImplementedError(
                "the two-QR pipeline (fused=False, propagate_band) is not "
                "ported yet (ROADMAP queue 1, item 12)"
            )
        if steady_state or isinstance(steady_state, dict):
            raise NotImplementedError(
                "steady-state mode is not ported yet (ROADMAP queue 1, item 15)"
            )
        self._factorization_spec = factorization
        self._factorization_d = None
        self.factorization = None if factorization == "householder" else factorization
        self._init_update = None
        self._cache = None

    def initialize(self, pde):
        n, d = self.num_derivatives + 1, pde.L.shape[0]
        if d >= 4096:
            raise NotImplementedError(
                "initialization at d >= 4096 needs the blocked triangular "
                "solves, which are not ported yet (ROADMAP queue 1, item 12)"
            )
        if self._factorization_spec == "householder" and self._factorization_d != d:
            self.factorization, self._init_update = resolve_householder_hooks(d)
            self._factorization_d = d
        update_blocks = (
            self._init_update.blocks
            if self._init_update is not None
            else sqrt.update_sqrt_from_products_blocks
        )

        y0 = pde.y0
        nugget = 1e-10  # conditioning nugget of the reference, for f64
        diffuse_scale = self.diffuse_prior_scale

        # prior Gram, its Cholesky factor, and the closed-form y0 update
        X = pde.mesh_spatial.points
        gram = self.spatial_kernel(X, X.T)
        chol_gram = torch.linalg.cholesky(gram)
        u0, y0_blocks = structured_init_y0(gram, chol_gram, y0, diffuse_scale, nugget, n)
        C00 = y0_blocks[0]

        # PDE measurement on the derivative-{0,1} sub-state. After the y0
        # update the mean is zero except on derivative 0, so the residual is
        # closed form: z = [-L u0; B u0].
        trans = iwp.IntegratedWienerTransition(
            num_derivatives=self.num_derivatives,
            wiener_process_dimension=d,
            wp_diffusion_sqrtm=chol_gram,
        )
        A1d = trans.preconditioned_discretize_1d[0]
        E_bc = torch.block_diag(pde.E_sqrtm, pde.R_sqrtm)
        B1 = diffuse_scale * chol_gram  # derivative >= 1 prior factor block
        L, B = pde.L, pde.B
        z_pde = torch.cat((-L @ u0, B @ u0))
        HCsub = torch.cat(
            (
                torch.cat((-L @ C00, B1), dim=1),
                torch.cat((B @ C00, u0.new_zeros((B.shape[0], d))), dim=1),
            ),
            dim=0,
        )
        E_bc_nugget = E_bc.clone()
        E_bc_nugget.diagonal().add_(nugget)
        m0, C0 = reduced_init_pde_update(
            [C00] + [B1] * (n - 1), HCsub, E_bc_nugget, z_pde, u0, update_blocks
        )

        self._cache = WhiteSolverCache(
            A1d=A1d, Ql=trans.process_noise_factor, L=L, B=B, E_bc_sqrtm=E_bc
        )
        self.iwp = trans
        return pdefilter.PDEFilterState(
            t=float(pde.t0),
            y=rv.MultivariateNormal(mean=iwp.flat_to_mean(m0, n), cov_sqrtm=C0),
            error_estimate=None,
            reference_state=None,
            diffusion_squared_local=m0.new_zeros(()),
        )

    def attempt_step(self, state, dt, t_next):
        mean, cov, error, reference, diff_sq = white_attempt_step(
            self._cache, state.y.mean, state.y.cov_sqrtm, t_next, dt,
            num_derivatives=self.num_derivatives,
            factorization=self.factorization,
        )
        new_state = pdefilter.PDEFilterState(
            t=t_next,
            y=rv.MultivariateNormal(mean=mean, cov_sqrtm=cov),
            error_estimate=error,
            reference_state=reference,
            diffusion_squared_local=diff_sq,
        )
        return new_state, dict(num_f_evaluations=1, num_df_evaluations=1)


class SemiLinearWhiteNoiseEK0:
    """Not ported yet (ROADMAP queue 1, item 10)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet: the semilinear solvers "
            "are ROADMAP queue 1, item 10"
        )


class SemiLinearWhiteNoiseEK1(SemiLinearWhiteNoiseEK0):
    """Not ported yet (ROADMAP queue 1, item 10)."""
