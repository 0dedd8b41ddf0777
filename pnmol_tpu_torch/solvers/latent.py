"""Latent-force EK1/EK0 PDE filters: the discretization error as an explicit
latent state.

Counterpart of :mod:`pnmol_tpu.solvers.latent`: a stacked state-space model
of two IWPs, the solution prior (Gram-Cholesky diffusion) and a latent-force
prior (``E_sqrtm`` diffusion), filtered with noise-free square-root updates.
Both halves share the Nordsieck order, so the stack is ONE IWP over ``2d``
points with the block-diagonal spatial factor
(:meth:`pnmol_tpu_torch.ops.stacked_ssm.StackedSSM.as_single_iwp`), and the
step is the white solver's fused pipeline with a latent-aware measurement
operator. The step carries an ``H Q H^T`` error estimate, so adaptive step
rules work here too. Its pre-array is twice the white one in both
dimensions; ``"householder"`` sizes its hooks for ``2d``. The two-QR
pipeline (``fused=False``, ``propagate_band``) and steady-state mode are the
white solver's; the latent steady state is converged without the doubling
seed (its DARE has no finite solution).
"""

import functools
from typing import NamedTuple

import torch

from pnmol_tpu_torch import config
from pnmol_tpu_torch.ops import iwp, rv, stacked_ssm
from pnmol_tpu_torch.solvers import pdefilter
from pnmol_tpu_torch.utils.profiling import annotate
from pnmol_tpu_torch.solvers.white import (
    FusedFactorizationFilter,
    _calibrate_and_update,
    _closed_loop_radius,
    _converge_steady_state,
    _frozen_gain_update,
    _linearize,
    _predict_update,
    reduced_init_pde_update,
    run_steady_convergence,
    structured_init_y0,
)


class LatentSolverCache(NamedTuple):
    """Per-problem constants of the latent-force step."""

    A1d: torch.Tensor  # (n, n)
    Ql: torch.Tensor  # (2D, 2D) kron(blockdiag(chol_gram, E_sqrtm), LQ1d)
    L: torch.Tensor  # (d, d)
    B: torch.Tensor  # (b, d)


def _measurement_operator_latent(cache, G, p, n, d):
    """X -> H @ X for ``H = [[p1 E1_s - G (p0 E0_s), -(p0 E0_eps)],
    [p0 B E0_s, 0]]`` over the stacked (state | latent) coordinates, without
    materializing H."""

    def apply_H(X):
        X0 = iwp.project_derivative(X, 0, n)  # (2d, K)
        X1 = iwp.project_derivative(X, 1, n)
        X0_state, X0_eps = X0[:d], X0[d:]
        ode_rows = p[1] * X1[:d] - G @ (p[0] * X0_state) - p[0] * X0_eps
        bc_rows = cache.B @ (p[0] * X0_state)
        return torch.cat((ode_rows, bc_rows), dim=0)

    return apply_H


def latent_attempt_step(cache, mean, cov_sqrtm, t_next, dt, *, num_derivatives,
                        f=None, df=None, linear=True, factorization=None, fused=True,
                        propagate_band=None, ek_order=1):
    """One latent-force EK{0,1} step: ``(mean (n, 2d), cov (2D, 2D), t_next,
    dt) -> (mean, cov, error (d,), reference (d,), diffusion_sq ())``, with
    the factorization hooks and pipelines of
    :func:`pnmol_tpu_torch.solvers.white.white_attempt_step` and a zero
    measurement-noise block."""
    n = num_derivatives + 1
    d = cache.L.shape[0]
    m_dim = d + cache.B.shape[0]
    p, p_inv = iwp.nordsieck_scales_1d(
        num_derivatives, dt, dtype=mean.dtype, device=mean.device
    )

    # [Precondition] (shared scales for both halves) and [Predict mean]
    M = mean * p_inv[:, None]
    Cl = iwp.scale_stack(p_inv, cov_sqrtm)
    Mp = cache.A1d @ M

    # [Linearize] at the predicted state half; [Residual] z = H mp + [shift; 0]
    state_at = p[0] * Mp[0, :d]
    eps_at = p[0] * Mp[0, d:]
    G, shift = _linearize(f, df, cache.L, t_next, state_at, linear, ek_order)
    apply_H = _measurement_operator_latent(cache, G, p, n, d)
    z = torch.cat((p[1] * Mp[1, :d] - G @ state_at - eps_at + shift,
                   cache.B @ state_at))

    # [Error estimate] S = H Q H^T over the stacked process noise (there is
    # no measurement noise), with the white solver's quasi-MLE sigma
    HQl = apply_H(cache.Ql)
    S_err = HQl @ HQl.T
    whitened = torch.cholesky_solve(z[:, None], torch.linalg.cholesky(S_err))[:, 0]
    sigma_sq = z @ whitened / m_dim
    error = dt * (torch.sqrt(torch.diagonal(S_err)) * torch.sqrt(sigma_sq))[:d]

    # [Predict + update covariance] (noise-free measurement)
    ACl = iwp.apply_stack_matrix(cache.A1d, Cl)
    zeros_R = ACl.new_zeros((m_dim, m_dim))
    Cl_new, L21, K, Sl = _predict_update(factorization, fused, propagate_band, apply_H, ACl,
                                         HQl, cache.Ql, zeros_R, n)

    # [Calibrate + mean update] and [Un-precondition]
    M_new, C_new, diffusion_sq = _calibrate_and_update(Mp, Cl_new, L21, K, Sl, z, p, n, m_dim)
    return M_new, C_new, error, torch.abs(M_new[0, :d]), diffusion_sq


def make_latent_step_fn(*, cache, num_derivatives, f=None, df=None, linear=True, fused=True,
                        factorization=None, propagate_band=None, ek_order=1):
    """Bind a cache to :func:`latent_attempt_step`: ``step(mean (n, 2d),
    cov (2D, 2D), t_next, dt)`` with the contract of
    :func:`pnmol_tpu_torch.solvers.white.make_white_step_fn`."""
    return functools.partial(
        latent_attempt_step, cache, num_derivatives=num_derivatives, f=f, df=df, linear=linear,
        fused=fused, factorization=factorization, propagate_band=propagate_band,
        ek_order=ek_order,
    )


def converge_latent_steady_state(cache, cov_sqrtm, dt, *, num_derivatives, fused=True,
                                 factorization=None, propagate_band=None, tol=1e-8,
                                 max_iters=200, harvest=True, row_sums=None):
    """Iterate the latent step's covariance recursion (noise-free update) to
    its fixed point: the latent analog of
    :func:`pnmol_tpu_torch.solvers.white.converge_white_steady_state`, with
    the same pipeline, stop rule, harvest and ``row_sums``."""
    n = num_derivatives + 1
    d = cache.L.shape[0]
    m_dim = d + cache.B.shape[0]
    p, p_inv = iwp.nordsieck_scales_1d(num_derivatives, dt, dtype=cov_sqrtm.dtype,
                                       device=cov_sqrtm.device)
    return _converge_steady_state(
        cache, cov_sqrtm, dt, p, p_inv, _measurement_operator_latent(cache, cache.L, p, n, d),
        cov_sqrtm.new_zeros((m_dim, m_dim)), num_derivatives=num_derivatives, fused=fused,
        factorization=factorization, propagate_band=propagate_band, tol=tol,
        max_iters=max_iters, harvest=harvest, row_sums=row_sums,
    )


def latent_dense_system(cache, dt, *, num_derivatives):
    """Dense ``(A, H, Q, R, p)`` of the preconditioned stacked recursion:
    transition ``kron(I_2d, A1d)``, the latent measurement operator applied
    to the identity, ``Q = Ql Ql^T`` and an exactly zero ``R``."""
    n = num_derivatives + 1
    d = cache.L.shape[0]
    Ql = cache.Ql
    p, _ = iwp.nordsieck_scales_1d(num_derivatives, dt, dtype=Ql.dtype, device=Ql.device)
    eye = torch.eye(Ql.shape[0], dtype=Ql.dtype, device=Ql.device)
    A = iwp.apply_stack_matrix(cache.A1d, eye)
    H = _measurement_operator_latent(cache, cache.L, p, n, d)(eye)
    m_dim = d + cache.B.shape[0]
    return A, H, Ql @ Ql.T, Ql.new_zeros((m_dim, m_dim)), p


def steady_closed_loop_radius(cache, steady, dt, *, num_derivatives, num_iters=256):
    """Spectral-radius estimate of the frozen latent closed loop (see
    :func:`pnmol_tpu_torch.solvers.white.steady_closed_loop_radius`). The
    latent force's integrator modes are undetectable and sit on the unit
    circle as Jordan blocks, so a healthy loop reads slightly above 1
    (``1 + O(nu log k / k)`` after k iterations)."""
    d = cache.L.shape[0]
    p, _ = iwp.nordsieck_scales_1d(num_derivatives, dt, dtype=cache.Ql.dtype,
                                   device=cache.Ql.device)
    apply_H = _measurement_operator_latent(cache, cache.L, p, num_derivatives + 1, d)
    return _closed_loop_radius(cache, steady, apply_H, num_iters)


def make_steady_state_latent_step(*, cache, steady, num_derivatives):
    """Mean-only latent step with frozen stationary factors: the contract of
    :func:`latent_attempt_step`, the covariance passed through unchanged."""
    n = num_derivatives + 1
    d = cache.L.shape[0]
    # the scales of a dt are built once: each build copies them host to device
    scales = functools.lru_cache(maxsize=4)(functools.partial(
        iwp.nordsieck_scales_1d, num_derivatives, dtype=steady.L21.dtype,
        device=steady.L21.device))

    def step(mean, cov, t_next, dt):
        p, p_inv = scales(dt)
        Mp = cache.A1d @ (mean * p_inv[:, None])
        state_at = p[0] * Mp[0, :d]
        z = torch.cat((p[1] * Mp[1, :d] - cache.L @ state_at - p[0] * Mp[0, d:],
                       cache.B @ state_at))
        M_new, error, diffusion_sq = _frozen_gain_update(steady, Mp, z, p, n)
        return M_new, cov, error, torch.abs(M_new[0, :d]), diffusion_sq

    return step


class _LatentForceEK1Base(FusedFactorizationFilter):
    """Shared initialization and plumbing of the latent-force solvers.

    ``factorization`` is as in the white solvers
    (:class:`pnmol_tpu_torch.solvers.white.FusedFactorizationFilter`);
    ``"householder"`` resolves its hooks for the stacked ``2d`` points.
    ``EK_ORDER`` selects the step's linearization (1 = EK1 Jacobian, 0 = EK0
    zeroth order).
    """

    EK_ORDER: int = 1
    LINEAR: bool = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.ssm = None
        self.state_iwp = None
        self.lf_iwp = None

    @property
    def E0(self):
        """Dense derivative-0 projection of one process half; experiments only."""
        return self.lf_iwp.projection_matrix(0)

    @property
    def E1(self):
        return self.lf_iwp.projection_matrix(1)

    def _initialize(self, pde):
        n, d = self.num_derivatives + 1, pde.L.shape[0]
        # hooks sized for the stacked dimension: the latent pre-array is the
        # white one at 2d points
        update_blocks = self._init_update_blocks(d, 2 * d)
        f = getattr(pde, "f", None)
        df = getattr(pde, "df", None)
        nugget = config.by_dtype(pde.y0.dtype, 1e-6, 1e-4)
        s = float(self.diffuse_prior_scale)

        # [Prior] Gram Cholesky and the closed-form y0 update of the state half
        with annotate("pnmol.init.prior_gram_cholesky_y0"):
            X = pde.mesh_spatial.points
            gram = self.spatial_kernel(X, X.T)
            chol_gram = torch.linalg.cholesky(gram)
            u0, y0_blocks = structured_init_y0(gram, chol_gram, pde.y0, s, nugget, n)
            C00 = y0_blocks[0]

        # [Measurement] stacked derivative-major factor blocks over the
        # (state | latent) points: derivative 0 = blockdiag(C00, s E), the
        # others blockdiag(s chol_gram, s E). The residual at t0 is closed
        # form: z_ode = -L u0 - f(u0), z_bc = B u0. (The EK0 solver
        # initializes with the Jacobian too, as the JAX package does.)
        with annotate("pnmol.init.measure_assembly"):
            L, B, E_sqrtm = pde.L, pde.B, pde.E_sqrtm
            B0 = torch.block_diag(C00, s * E_sqrtm)
            B1 = torch.block_diag(s * chol_gram, s * E_sqrtm)
            if self.LINEAR:
                G_lin, z_ode = L, -L @ u0
            else:
                G_lin, z_ode = df(pde.t0, u0) + L, -L @ u0 - f(pde.t0, u0)
            z_pde = torch.cat((z_ode, B @ u0))

            # H on the derivative-{0,1} sub-stack, columnwise on blockdiag(B0, B1):
            # ode rows = X1_state - G X0_state - X0_eps, bc rows = B X0_state
            b_rows = B.shape[0]
            HCsub = torch.cat(
                (
                    torch.cat((-G_lin @ C00, -s * E_sqrtm, s * chol_gram,
                               u0.new_zeros((d, d))), dim=1),
                    torch.cat((B @ C00, u0.new_zeros((b_rows, 3 * d))), dim=1),
                ),
                dim=0,
            )
            nugget_pde = nugget * torch.eye(d + b_rows, dtype=u0.dtype, device=u0.device)
        with annotate("pnmol.init.init_update_qr"):
            u0_stack = torch.cat((u0, torch.zeros_like(u0)))
            m0, C0 = reduced_init_pde_update(
                [B0] + [B1] * (n - 1), HCsub, nugget_pde, z_pde, u0_stack, update_blocks
            )
        C0 = self._initial_factor(C0)

        # [Step cache] the stacked prior as one IWP over 2d points
        with annotate("pnmol.init.aux_Ql"):
            self.state_iwp = iwp.IntegratedWienerTransition(
                num_derivatives=self.num_derivatives, wiener_process_dimension=d,
                wp_diffusion_sqrtm=chol_gram,
            )
            self.lf_iwp = iwp.IntegratedWienerTransition(
                num_derivatives=self.num_derivatives, wiener_process_dimension=d,
                wp_diffusion_sqrtm=E_sqrtm,
            )
            self.ssm = stacked_ssm.StackedSSM(processes=[self.state_iwp, self.lf_iwp])
            merged = self.ssm.as_single_iwp()
            self._cache = LatentSolverCache(
                A1d=merged.preconditioned_discretize_1d[0], Ql=merged.process_noise_factor,
                L=L, B=B,
            )
        opts = self._steady_options()
        if opts is None:
            self._step_fn = make_latent_step_fn(
                cache=self._cache, num_derivatives=self.num_derivatives, f=f, df=df,
                linear=self.LINEAR, factorization=self.factorization, fused=self.fused,
                propagate_band=self.propagate_band, ek_order=self.EK_ORDER,
            )
        else:
            # no doubling seed: the latent force's integrator modes are
            # undetectable, so the covariance grows like a random walk while
            # the gain converges; the recursion's Gram-diagonal stationarity
            # stands in for the gain's
            with annotate("pnmol.init.steady_riccati"):
                self.steady_cache = run_steady_convergence(
                    converge_latent_steady_state, self._cache, C0, float(self.steprule.dt),
                    opts, 1e-8 if m0.dtype == torch.float64 else 1e-5,
                    num_derivatives=self.num_derivatives, fused=self.fused,
                    factorization=self.factorization, propagate_band=self.propagate_band,
                )
                C0 = self.steady_cache.cov_inf
            self._step_fn = make_steady_state_latent_step(
                cache=self._cache, steady=self.steady_cache,
                num_derivatives=self.num_derivatives,
            )

        # point-major glue: [state (n, d) | latent (n, d)] along the last axis
        m0_state, m0_latent = torch.chunk(m0, 2)
        mean0 = torch.cat(
            (iwp.flat_to_mean(m0_state, n), iwp.flat_to_mean(m0_latent, n)), dim=1
        )
        return pdefilter.PDEFilterState(
            t=float(pde.t0),
            y=rv.MultivariateNormal(mean=mean0, cov_sqrtm=C0),
            error_estimate=None,
            reference_state=None,
            diffusion_squared_local=m0.new_zeros(()),
        )


class LinearLatentForceEK1(_LatentForceEK1Base):
    """Latent-force EK1 for linear evolution equations."""

    LINEAR = True


class SemiLinearLatentForceEK0(_LatentForceEK1Base):
    """EK0 latent-force filter: the zeroth-order measurement model in the
    step (see :class:`pnmol_tpu_torch.solvers.white.SemiLinearWhiteNoiseEK0`)."""

    LINEAR = False
    EK_ORDER = 0


class SemiLinearLatentForceEK1(_LatentForceEK1Base):
    """Latent-force EK1 for semilinear evolution equations."""

    LINEAR = False
