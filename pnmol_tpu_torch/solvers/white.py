"""White-noise EK1/EK0 PDE filters: the discretization error enters as
measurement noise.

Counterpart of :mod:`pnmol_tpu.solvers.white` for linear and semilinear
problems: the prior is the Gram-Cholesky IWP, the initialization is the
closed-form y0 update followed by one sqrt update on the PDE measurement,
and each step runs ONE fused pre-array factorization: ``torch.linalg.qr``
(``factorization=None``), the Householder LQ with the CUDA panel kernel
(``factorization="householder"``), or a hook such as the R-form Householder
QR with the CUDA leaf kernel
(:func:`pnmol_tpu_torch.ops.qr_householder.make_householder_factorization`);
or, with ``fused=False``, the two-QR pipeline: one propagate LQ and one
update LQ, the large-N form (optionally banded, ``propagate_band``).
The state lives in the point-major Nordsieck layout of
:mod:`pnmol_tpu_torch.ops.iwp`, so the measurement matrix ``H`` is never
materialized.
"""

import functools
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


def _linearize(pde_f, pde_df, L, t, m_at, linear: bool, ek_order: int = 1):
    """EK{0,1} linearization at the predicted point: ``(G, shift)``.

    Linear problems: ``(L, 0)``. EK1 linearizes ``f`` with its Jacobian,
    ``(Jx + L, Jx m - f(m))``; EK0 keeps the innovation mean but carries only
    ``L`` in the measurement operator, ``(L, -f(m))``, and never evaluates
    ``df``.
    """
    if linear:
        return L, torch.zeros_like(m_at)
    fx = pde_f(t, m_at)
    if ek_order == 0:
        return L, -fx
    Jx = pde_df(t, m_at)
    return Jx + L, Jx @ m_at - fx


def _predict_update(factorization, fused, propagate_band, apply_H, ACl, HQl, Ql, E, n):
    """Predict and update the covariance factor, as ``(posterior factor,
    L21, K, Sl)`` with exactly one of ``L21`` (raw blocks, ``S_xz = L21
    Sl^T``) and ``K`` (the legacy gain contract of a hook without
    ``.blocks``). The branches in the JAX step's order: a hook with
    ``.propagate`` and ``fused=False`` runs the two-QR pipeline (its
    propagate ``.interleaved`` or ``.banded`` where ``propagate_band`` asks,
    its update ``.blocks_banded`` for any band); any other hook the fused
    pre-array (``.blocks_banded`` for any band); no hook the fused
    ``torch.linalg.qr``, or with ``fused=False`` the plain propagate and
    plain update. ``n`` is the point block of the interleaving."""
    if factorization is not None and not fused and hasattr(factorization, "propagate"):
        prop = factorization.propagate
        if propagate_band == "interleaved" and hasattr(prop, "interleaved"):
            Clp = prop.interleaved(ACl, Ql, n)
        elif propagate_band is not None and hasattr(prop, "banded"):
            Clp = prop.banded(ACl, Ql)
        else:
            Clp = prop(ACl, Ql)
        HClp = apply_H(Clp)
        upd = factorization.update_from_products
        if propagate_band is not None and hasattr(upd, "blocks_banded"):
            blocks = upd.blocks_banded
        else:
            blocks = getattr(upd, "blocks", sqrt.update_sqrt_from_products_blocks)
        C, L21, Sl = blocks(HClp, Clp, E)
        return C, L21, None, Sl
    if factorization is not None:
        HACl = apply_H(ACl)
        if propagate_band is not None and hasattr(factorization, "blocks_banded"):
            blocks = factorization.blocks_banded
        else:
            blocks = getattr(factorization, "blocks", None)
        if blocks is None:
            C, K, Sl = factorization(HACl, ACl, HQl, Ql, E)
            return C, None, K, Sl
        C, L21, Sl = blocks(HACl, ACl, HQl, Ql, E)
        return C, L21, None, Sl
    if fused:
        C, L21, Sl = sqrt.fused_predict_update_blocks(apply_H(ACl), ACl, HQl, Ql, E)
    else:
        Clp = sqrt.propagate_cholesky_factor(ACl, Ql)
        C, L21, Sl = sqrt.update_sqrt_from_products_blocks(apply_H(Clp), Clp, E)
    return C, L21, None, Sl


def _calibrate_and_update(Mp, Cl_new, L21, K, Sl, z, p, n, m_dim):
    """Whitened residual via the LOWER solve ``Sl w = z`` (``z^T S^{-1} z``
    with ``S = Sl Sl^T``, invariant to row signs), the local diffusion, the
    mean update ``K z = L21 w`` and the un-preconditioning. Returns
    ``(mean (n, d'), cov factor, diffusion_sq)``."""
    residual_white = torch.linalg.solve_triangular(Sl, z[:, None], upper=False)[:, 0]
    diffusion_sq = residual_white @ residual_white / m_dim
    correction = L21 @ residual_white if K is None else K @ z
    m_new_flat = iwp.mean_to_flat(Mp) - correction
    M_new = iwp.flat_to_mean(m_new_flat, n) * p[:, None]
    return M_new, iwp.scale_stack(p, Cl_new), diffusion_sq


def white_attempt_step(cache, mean, cov_sqrtm, t_next, dt, *, num_derivatives,
                       f=None, df=None, linear=True, factorization=None, fused=True,
                       propagate_band=None, meascov_dt_scaled=False, ek_order=1):
    """One white-noise EK{0,1} step.

    Returns ``(mean (n, d), cov_sqrtm (D, D), error_estimate (d,),
    reference (d,), diffusion_sq ())``. ``f``/``df`` are the problem's
    nonlinearity and its Jacobian (unused when ``linear``), evaluated at
    ``t_next``. ``factorization`` is ``None`` (the fused pre-array QR), a
    hook with a ``.blocks`` attribute returning ``(posterior factor, L21,
    Sl)``, or a hook without one returning ``(posterior factor, gain, Sl)``
    (the legacy gain contract); ``fused`` and ``propagate_band`` choose the
    pipeline (see :func:`_predict_update`). ``meascov_dt_scaled`` uses the
    measurement noise factor ``sqrt(dt) E`` (the discretization error as a
    white noise in time).
    """
    n = num_derivatives + 1
    d = mean.shape[1]
    m_dim = d + cache.B.shape[0]
    p, p_inv = iwp.nordsieck_scales_1d(
        num_derivatives, dt, dtype=mean.dtype, device=mean.device
    )
    E_bc = cache.E_bc_sqrtm
    if meascov_dt_scaled:
        E_bc = dt**0.5 * E_bc

    # [Precondition] and [Predict mean]
    M = mean * p_inv[:, None]
    Cl = iwp.scale_stack(p_inv, cov_sqrtm)
    Mp = cache.A1d @ M

    # [Linearize] at the predicted point; [Residual] z = H mp + [shift; 0]
    m_at = p[0] * Mp[0]
    G, shift = _linearize(f, df, cache.L, t_next, m_at, linear, ek_order)
    apply_H = _measurement_operator(cache, G, p, n)
    z = torch.cat((p[1] * Mp[1] - G @ m_at + shift, cache.B @ m_at))

    # [Error estimate] from S = H Q H^T + E E^T on the small (m, m) system
    HQl = apply_H(cache.Ql)
    S = HQl @ HQl.T + E_bc @ E_bc.T
    whitened = torch.cholesky_solve(z[:, None], torch.linalg.cholesky(S))[:, 0]
    sigma_squared = z @ whitened / m_dim
    error = dt * (torch.sqrt(torch.diagonal(S)) * torch.sqrt(sigma_squared))[:d]

    # [Predict + update covariance]: the gain L21 Sl^{-1} is never formed
    ACl = iwp.apply_stack_matrix(cache.A1d, Cl)
    Cl_new, L21, K, Sl = _predict_update(factorization, fused, propagate_band, apply_H, ACl,
                                         HQl, cache.Ql, E_bc, n)

    # [Calibrate + mean update] and [Un-precondition]
    M_new, C_new, diffusion_sq = _calibrate_and_update(Mp, Cl_new, L21, K, Sl, z, p, n, m_dim)
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
    problem with ``d`` state points (the latent solvers pass 2d), as the JAX
    package sizes them: blocks of 256 rows from 4096 points on (else 128),
    leaves of 64 rows from 8192 on (else 32). The panel kernel takes 128-row
    blocks in one launch; 256-row blocks take the leaf route, one launch per
    leaf (:func:`pnmol_tpu_torch.ops.qr_householder.blocked_lq_l`)."""
    leaf = 64 if d >= 8192 else 32
    block = 256 if d >= 4096 else 128
    factorization = qr_householder.make_householder_lq_factorization(
        leaf=leaf, block=block, pair_columns=pair_columns
    )
    init_update = qr_householder.make_householder_update_from_products(leaf=leaf, block=block)
    return factorization, init_update


class FusedFactorizationFilter(pdefilter.PDEFilter):
    """The factorization options both solver families share.

    ``factorization``: ``None`` (``torch.linalg.qr``), ``"householder"``
    (the blocked Householder LQ with the CUDA panel kernel, for the step AND
    the initialization update, with the blocks and leaves of
    :func:`resolve_householder_hooks`), or a step hook
    (``make_householder_lq_factorization``, or the R-form
    ``make_householder_factorization`` with the CUDA leaf kernel, from
    :mod:`pnmol_tpu_torch.ops.qr_householder`); a hook leaves the
    initialization on the plain update, as in the JAX solvers.

    ``fused=False`` runs the two-QR pipeline: a propagate LQ and an update
    LQ through the hook's ``.propagate`` and ``.update_from_products``
    (``"householder"`` has both), or with no hook ``torch.linalg.qr`` of each.
    ``propagate_band`` ``"banded"`` windows both sweeps to the pre-arrays'
    triangular support; ``"interleaved"`` also interleaves the propagate's
    point blocks, for which ``initialize`` re-triangularizes the initial
    factor. With ``fused=True`` a band asks the hook for its banded fused
    pre-array. Steady-state mode raises ``NotImplementedError``.
    """

    def __init__(self, *args, factorization=None, fused=True, propagate_band=None,
                 steady_state=False, **kwargs):
        super().__init__(*args, **kwargs)
        if steady_state or isinstance(steady_state, dict):
            raise NotImplementedError(
                "steady-state mode is not ported yet (ROADMAP queue 1, item 15)"
            )
        self._factorization_spec = factorization
        self._factorization_d = None
        self.factorization = None if factorization == "householder" else factorization
        self.fused = fused
        self.propagate_band = propagate_band
        self._init_update = None
        self._cache = None
        self._step_fn = None

    def _init_update_blocks(self, d, hook_points):
        """Resolve ``"householder"`` for a problem of ``d`` points, with hooks
        sized for ``hook_points`` (the latent stack passes 2d), and return
        the initialization update ``(HC, C, R) -> (posterior, L21, L1)``."""
        if self._factorization_spec == "householder" and self._factorization_d != d:
            self.factorization, self._init_update = resolve_householder_hooks(hook_points)
            self._factorization_d = d
        if self._init_update is None:
            return sqrt.update_sqrt_from_products_blocks
        return self._init_update.blocks

    def _initial_factor(self, C0):
        """The initial factor; for the interleaved propagate of the two-QR
        pipeline a lower-triangular one with its Gram (its precondition):
        the hook's ``.tri``, else the transposed R of ``torch.linalg.qr(C0.T)``."""
        if self.propagate_band != "interleaved" or self.fused:
            return C0
        tri = getattr(self.factorization, "tri", None)
        return tri(C0) if tri is not None else torch.linalg.qr(C0.T, mode="r")[1].T

    def _step_function(self, pde):
        return self._step_fn


class _WhiteNoiseEK1Base(FusedFactorizationFilter):
    """Shared initialization and step plumbing of the white-noise solvers.

    ``meascov_dt_scaled=True`` uses the per-step measurement covariance
    ``dt E E^T``; for ``factorization`` see :class:`FusedFactorizationFilter`.
    """

    LINEAR: bool = True
    EK_ORDER: int = 1

    def __init__(self, *args, meascov_dt_scaled=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.meascov_dt_scaled = meascov_dt_scaled

    @property
    def E0(self):
        """Dense derivative-0 projection (d, D); experiments only."""
        return self.iwp.projection_matrix(0)

    @property
    def E1(self):
        return self.iwp.projection_matrix(1)

    def initialize(self, pde):
        n, d = self.num_derivatives + 1, pde.L.shape[0]
        update_blocks = self._init_update_blocks(d, d)
        f = getattr(pde, "f", None)
        df = getattr(pde, "df", None)

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
        # closed form: z = [-L u0 - f(u0); B u0].
        trans = iwp.IntegratedWienerTransition(
            num_derivatives=self.num_derivatives,
            wiener_process_dimension=d,
            wp_diffusion_sqrtm=chol_gram,
        )
        A1d = trans.preconditioned_discretize_1d[0]
        E_bc = torch.block_diag(pde.E_sqrtm, pde.R_sqrtm)
        B1 = diffuse_scale * chol_gram  # derivative >= 1 prior factor block
        L, B = pde.L, pde.B
        if self.LINEAR:
            G_lin, z_ode = L, -L @ u0
        else:
            G_lin = L if self.EK_ORDER == 0 else df(pde.t0, u0) + L
            z_ode = -L @ u0 - f(pde.t0, u0)
        z_pde = torch.cat((z_ode, B @ u0))
        HCsub = torch.cat(
            (
                torch.cat((-G_lin @ C00, B1), dim=1),
                torch.cat((B @ C00, u0.new_zeros((B.shape[0], d))), dim=1),
            ),
            dim=0,
        )
        E_bc_nugget = E_bc.clone()
        E_bc_nugget.diagonal().add_(nugget)
        m0, C0 = reduced_init_pde_update(
            [C00] + [B1] * (n - 1), HCsub, E_bc_nugget, z_pde, u0, update_blocks
        )
        C0 = self._initial_factor(C0)

        self._cache = WhiteSolverCache(
            A1d=A1d, Ql=trans.process_noise_factor, L=L, B=B, E_bc_sqrtm=E_bc
        )
        self._step_fn = functools.partial(
            white_attempt_step, self._cache,
            num_derivatives=self.num_derivatives, f=f, df=df, linear=self.LINEAR,
            factorization=self.factorization, fused=self.fused,
            propagate_band=self.propagate_band,
            meascov_dt_scaled=self.meascov_dt_scaled, ek_order=self.EK_ORDER,
        )
        self.iwp = trans
        return pdefilter.PDEFilterState(
            t=float(pde.t0),
            y=rv.MultivariateNormal(mean=iwp.flat_to_mean(m0, n), cov_sqrtm=C0),
            error_estimate=None,
            reference_state=None,
            diffusion_squared_local=m0.new_zeros(()),
        )


class LinearWhiteNoiseEK1(_WhiteNoiseEK1Base):
    """EK1 for linear evolution equations (Jx = L exactly)."""

    LINEAR = True


class SemiLinearWhiteNoiseEK0(_WhiteNoiseEK1Base):
    """EK0 for semilinear problems: the zeroth-order measurement model.

    Same innovation mean as EK1 (``z = u' - L u - f(u_pred)``), but the
    measurement operator carries only ``L`` and ``df`` is never evaluated.
    On linear problems EK0 == EK1 exactly.
    """

    LINEAR = False
    EK_ORDER = 0


class SemiLinearWhiteNoiseEK1(_WhiteNoiseEK1Base):
    """EK1 for semilinear evolution equations u_t = L u + f(u)."""

    LINEAR = False
