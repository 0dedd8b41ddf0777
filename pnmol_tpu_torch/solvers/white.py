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
Steady-state mode (``steady_state=True`` or an options dict, linear problems
at constant steps) converges the covariance recursion once at
initialization, from the doubling seed of :mod:`pnmol_tpu_torch.ops.dare`
through the same factorizations, and then steps the mean only.
The state lives in the point-major Nordsieck layout of
:mod:`pnmol_tpu_torch.ops.iwp`, so the measurement matrix ``H`` is never
materialized.
"""

import functools
from typing import NamedTuple, Optional

import torch

from pnmol_tpu_torch import config
from pnmol_tpu_torch.odetools import step as step_module
from pnmol_tpu_torch.ops import dare, iwp, qr_householder, rv, sqrt
from pnmol_tpu_torch.solvers import pdefilter
from pnmol_tpu_torch.utils import debug
from pnmol_tpu_torch.utils.profiling import annotate


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


def _meascov_factor(cache, dt, meascov_dt_scaled):
    """The measurement noise factor: ``sqrt(dt) E`` with ``meascov_dt_scaled``."""
    return dt**0.5 * cache.E_bc_sqrtm if meascov_dt_scaled else cache.E_bc_sqrtm


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
    white noise in time). Its four phases are spans inside the attempt's
    ``pnmol.step``: ``pnmol.step.predict``, ``.error``, ``.factorize`` and
    ``.update``.
    """
    n = num_derivatives + 1
    d = mean.shape[1]
    m_dim = d + cache.B.shape[0]
    with annotate("pnmol.step.predict"):
        p, p_inv = iwp.nordsieck_scales_1d(
            num_derivatives, dt, dtype=mean.dtype, device=mean.device
        )
        E_bc = _meascov_factor(cache, dt, meascov_dt_scaled)

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
    with annotate("pnmol.step.error"):
        HQl = apply_H(cache.Ql)
        S = HQl @ HQl.T + E_bc @ E_bc.T
        whitened = torch.cholesky_solve(z[:, None], torch.linalg.cholesky(S))[:, 0]
        sigma_squared = z @ whitened / m_dim
        error = dt * (torch.sqrt(torch.diagonal(S)) * torch.sqrt(sigma_squared))[:d]

    # [Predict + update covariance]: the gain L21 Sl^{-1} is never formed
    with annotate("pnmol.step.factorize"):
        ACl = iwp.apply_stack_matrix(cache.A1d, Cl)
        Cl_new, L21, K, Sl = _predict_update(factorization, fused, propagate_band, apply_H,
                                             ACl, HQl, cache.Ql, E_bc, n)

    # [Calibrate + mean update] and [Un-precondition]
    with annotate("pnmol.step.update"):
        M_new, C_new, diffusion_sq = _calibrate_and_update(Mp, Cl_new, L21, K, Sl, z, p, n,
                                                           m_dim)
    return M_new, C_new, error, torch.abs(M_new[0]), diffusion_sq


def make_white_step_fn(*, cache, num_derivatives, f=None, df=None, linear=True, fused=True,
                       factorization=None, meascov_dt_scaled=False, propagate_band=None,
                       ek_order=1):
    """Bind a cache to :func:`white_attempt_step`: ``step(mean (n, d), cov
    (D, D), t_next, dt) -> (mean, cov, error (d,), reference (d,),
    diffusion_sq ())``, the step of the solvers on a given cache (for
    example one cast to another dtype). The options are the step's."""
    return functools.partial(
        white_attempt_step, cache, num_derivatives=num_derivatives, f=f, df=df, linear=linear,
        fused=fused, factorization=factorization, meascov_dt_scaled=meascov_dt_scaled,
        propagate_band=propagate_band, ek_order=ek_order,
    )


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
    leaf (:func:`pnmol_tpu_torch.ops.qr_householder.blocked_lq_l`). The
    sizing is the same in f32, where one launch could take up to 240 rows
    (:func:`pnmol_tpu_torch.ops.qr_householder.panel_takes_rows`)."""
    leaf = 64 if d >= 8192 else 32
    block = 256 if d >= 4096 else 128
    factorization = qr_householder.make_householder_lq_factorization(
        leaf=leaf, block=block, pair_columns=pair_columns
    )
    init_update = qr_householder.make_householder_update_from_products(leaf=leaf, block=block)
    return factorization, init_update


# ---------------------------------------------------------------------------
# Steady-state mode: the Riccati fixed point, its doubling seed, and the
# mean-only step with the frozen blocks
# ---------------------------------------------------------------------------


class SteadyStateCache(NamedTuple):
    """Frozen factor blocks of the steady-state (stationary) step."""

    cov_inf: torch.Tensor  # (D, D) stationary posterior factor (unpreconditioned)
    L21: Optional[torch.Tensor]  # (D, m) stationary cross block (preconditioned)
    Sl: Optional[torch.Tensor]  # (m, m) stationary innovation factor (preconditioned)
    Sl_inv: Optional[torch.Tensor]  # (m, m) its inverse: the step whitens by a matvec
    err_vec: Optional[torch.Tensor]  # (d,) dt * sqrt(diag(S)), the error estimate's base
    iterations: int  # Riccati iterations run
    delta: float  # final relative change of the Gram diagonal


def _triangular_inverse(Sl):
    """Explicit inverse of a lower-triangular factor (one m-RHS solve)."""
    eye = torch.eye(Sl.shape[0], dtype=Sl.dtype, device=Sl.device)
    return torch.linalg.solve_triangular(Sl, eye, upper=False)


def _converge_steady_state(cache, cov_sqrtm, dt, p, p_inv, apply_H, E, *, num_derivatives,
                           fused, factorization, propagate_band, tol, max_iters, harvest,
                           row_sums=None):
    """The covariance recursion of one step, iterated from ``cov_sqrtm``
    while ``it < max_iters and (it < 2 or delta >= tol)``, ``delta`` the
    relative change of the Gram diagonal. Each iteration is the step's own
    predict and update (:func:`_predict_update`: the same pipeline and hook)
    with the measurement noise factor ``E``. ``harvest`` adds one more
    iteration from the last factor for the frozen blocks, the inverse
    innovation factor and the error-estimate base ``dt sqrt(diag(S))`` (row
    norms of ``H Ql`` and ``E``); without it those fields are None.

    ``row_sums`` completes the row sums of squares of column blocks (the
    Gram diagonal, ``diag(S)``): the identity by default, a sum over the
    ranks when the factor, ``Ql`` and ``E`` are each rank's columns."""
    row_sums = row_sums or (lambda x: x)
    n = num_derivatives + 1
    d = cache.L.shape[0]
    HQl = apply_H(cache.Ql)

    def cov_step(C_unpre):
        ACl = iwp.apply_stack_matrix(cache.A1d, iwp.scale_stack(p_inv, C_unpre))
        Cl_new, L21, K, Sl = _predict_update(factorization, fused, propagate_band, apply_H,
                                             ACl, HQl, cache.Ql, E, n)
        if K is not None:  # back out the cross block: S_xz = K S = L21 Sl^T
            L21 = K @ Sl
        return iwp.scale_stack(p, Cl_new), L21, Sl

    tiny = torch.finfo(cov_sqrtm.dtype).tiny
    C, it, delta = cov_sqrtm, 0, float("inf")
    diag = row_sums(torch.einsum("ij,ij->i", C, C))
    while it < max_iters and (it < 2 or delta >= tol):
        C = cov_step(C)[0]
        diag_new = row_sums(torch.einsum("ij,ij->i", C, C))
        delta = ((diag_new - diag).abs().max() / (diag_new.max() + tiny)).item()
        diag = diag_new
        it += 1
    if not harvest:
        return SteadyStateCache(cov_inf=C, L21=None, Sl=None, Sl_inv=None, err_vec=None,
                                iterations=it, delta=delta)
    C_inf, L21, Sl = cov_step(C)
    s_diag = row_sums(torch.einsum("ij,ij->i", HQl, HQl) + torch.einsum("ij,ij->i", E, E))
    return SteadyStateCache(cov_inf=C_inf, L21=L21, Sl=Sl, Sl_inv=_triangular_inverse(Sl),
                            err_vec=dt * torch.sqrt(s_diag)[:d], iterations=it, delta=delta)


def converge_white_steady_state(cache, cov_sqrtm, dt, *, num_derivatives, fused=True,
                                factorization=None, propagate_band=None,
                                meascov_dt_scaled=False, tol=1e-8, max_iters=200, harvest=True,
                                row_sums=None):
    """Iterate the white step's covariance recursion to its fixed point.

    For linear problems at constant ``dt`` the measurement operator is
    time-invariant, so the covariance half of the recursion is
    data-independent and converges to the square-root solution of the DARE.
    This runs that recursion through the step's own pipeline (the same QRs
    and hook) and returns a :class:`SteadyStateCache` with the frozen blocks
    of one more step from the converged factor (``harvest=False`` skips
    them). ``row_sums`` is :func:`_converge_steady_state`'s (column blocks
    of a sharded factor)."""
    n = num_derivatives + 1
    p, p_inv = iwp.nordsieck_scales_1d(num_derivatives, dt, dtype=cov_sqrtm.dtype,
                                       device=cov_sqrtm.device)
    return _converge_steady_state(
        cache, cov_sqrtm, dt, p, p_inv, _measurement_operator(cache, cache.L, p, n),
        _meascov_factor(cache, dt, meascov_dt_scaled), num_derivatives=num_derivatives,
        fused=fused, factorization=factorization, propagate_band=propagate_band, tol=tol,
        max_iters=max_iters, harvest=harvest, row_sums=row_sums,
    )


def white_dense_system(cache, dt, *, num_derivatives, meascov_dt_scaled=False):
    """Dense ``(A, H, Q, R, p)`` of the preconditioned step recursion:
    transition ``kron(I_d, A1d)``, the measurement operator applied to the
    identity, ``Q = Ql Ql^T`` and ``R = E E^T``. The Nordsieck scales cancel
    between consecutive steps, so the fixed point lives in these coordinates.
    Only the doubling seed materializes them."""
    n = num_derivatives + 1
    Ql = cache.Ql
    p, _ = iwp.nordsieck_scales_1d(num_derivatives, dt, dtype=Ql.dtype, device=Ql.device)
    E_bc = _meascov_factor(cache, dt, meascov_dt_scaled)
    eye = torch.eye(Ql.shape[0], dtype=Ql.dtype, device=Ql.device)
    A = iwp.apply_stack_matrix(cache.A1d, eye)
    H = _measurement_operator(cache, cache.L, p, n)(eye)
    del eye
    return A, H, Ql @ Ql.T, E_bc @ E_bc.T, p


def _factored_dare_residual(sigma, Wh, A1d, Ql):
    """The DARE residual of :func:`pnmol_tpu_torch.ops.dare.dare_residual`
    without dense ``A``, ``G`` or ``Q``: with ``sigma = C C^T`` and ``G =
    Wh^T Wh``, ``sigma (I + G sigma)^{-1} = Y^T Y`` for ``Y = Lm^{-1} C^T``,
    ``I + (Wh C)^T (Wh C) = Lm Lm^T``; the transition applies through its
    point blocks and the noise through its factor. A float; NaN where
    ``sigma`` has no Cholesky factor (as the JAX package's NaN factor makes
    it): a reported certificate, not a fallback."""
    tiny = torch.finfo(sigma.dtype).tiny
    sig = dare._symmetrized(sigma)
    shifted = sig.clone()
    shifted.diagonal().add_(16.0 * torch.finfo(sig.dtype).eps * sig.abs().max())
    C, info = torch.linalg.cholesky_ex(shifted)
    del shifted
    if info.item():
        return float("nan")
    Z = Wh @ C
    M = Z.T @ Z
    del Z
    M.diagonal().add_(1.0)
    Lm = torch.linalg.cholesky(dare._symmetrized(M))
    del M
    Y = torch.linalg.solve_triangular(Lm, C.T, upper=False)
    del C, Lm
    X = Y.T @ Y
    del Y
    # A X A^T = A (A X)^T for symmetric X
    T1 = iwp.apply_stack_matrix(A1d, X)
    del X
    F = iwp.apply_stack_matrix(A1d, T1.T)
    del T1
    F.addmm_(Ql, Ql.T)
    return ((sig - F).abs().max() / (sig.abs().max() + tiny)).item()


def sda_seed_from_dense(A, H, Q, R, p, *, meascov_sqrtm, residual_fn, bc_nugget=1e-6,
                        max_iters=64, tol=None, update_blocks=None):
    """The doubling seed over a dense ``(A, H, Q, R)`` system: ``(C0, info)``
    with ``C0`` the stationary POSTERIOR factor, unpreconditioned by ``p``.

    ``G0 = H^T R^{-1} H`` needs an invertible ``R``: its diagonal is floored
    at ``bc_nugget^2`` times the innovation scale (the larger of ``max
    diag(R)`` and ``max diag(H Q H^T)``), since Dirichlet rows carry exact
    measurements. The predicted fixed point of :func:`dare.sda` (``tol``
    1e-12 in f64, 1e-6 otherwise) is certified by ``residual_fn(sigma, Wh)``
    (``Wh = Lr^{-1} H``), factorized by Cholesky (retried once with an
    eps-scaled jitter where it fails), and updated once with the exact noise
    factor ``meascov_sqrtm`` by ``update_blocks(HC, C, R) -> (posterior,
    L21, L1)`` (default the plain :func:`sqrt.update_sqrt_from_products_blocks`),
    of which only the posterior is kept. ``info`` holds ``sda_iterations``,
    ``sda_delta`` and ``dare_residual``."""
    dtype = Q.dtype
    if tol is None:
        tol = 1e-12 if dtype == torch.float64 else 1e-6
    HQ_gram_diag = torch.einsum("ij,ij->i", H @ Q, H)
    scale = torch.maximum(torch.diagonal(R).max(), HQ_gram_diag.max())
    R_eps = R.clone()
    R_eps.diagonal().add_(bc_nugget**2 * scale)
    Lr = torch.linalg.cholesky(R_eps)
    del R_eps
    Wh = torch.linalg.solve_triangular(Lr, H, upper=False)
    del Lr
    G0 = Wh.T @ Wh
    debug.dump_live_arrays("pre_sda")
    res = dare.sda(A, G0, Q, tol=tol, max_iters=max_iters)
    del G0
    residual = residual_fn(res.sigma, Wh)
    del Wh
    sigma = dare._symmetrized(res.sigma)
    info = {"sda_iterations": res.iterations, "sda_delta": res.delta,
            "dare_residual": residual}
    del res
    # the PREDICTED fixed point is PD (sigma >= Q > 0); the filtered one is
    # rank-deficient along the exact boundary rows, so it comes from one
    # square-root update of the predicted factor
    C_pred, failed = torch.linalg.cholesky_ex(sigma)
    if failed.item():
        sigma.diagonal().add_(torch.finfo(dtype).eps * torch.diagonal(sigma).max())
        C_pred = torch.linalg.cholesky(sigma)
    del sigma
    update_blocks = update_blocks or sqrt.update_sqrt_from_products_blocks
    C_post = update_blocks(H @ C_pred, C_pred, meascov_sqrtm)[0]
    del C_pred
    return iwp.scale_stack(p, C_post), info


def steady_state_sda_seed(cache, dt, *, num_derivatives, meascov_dt_scaled=False,
                          bc_nugget=1e-6, max_iters=64, tol=None, update_blocks=None):
    """The white step's stationary posterior factor by doubling (SDA):
    ``(C0, info)`` from :func:`sda_seed_from_dense` on
    :func:`white_dense_system`, certified by :func:`_factored_dare_residual`.
    ``~log2(1/(lambda_min dt))`` doubling iterations replace the recursion's
    ``O(1/dt)``; the polish of :func:`run_steady_convergence` then derives
    the frozen blocks through the step's own pipeline."""
    A, H, Q, R, p = white_dense_system(cache, dt, num_derivatives=num_derivatives,
                                       meascov_dt_scaled=meascov_dt_scaled)
    return sda_seed_from_dense(
        A, H, Q, R, p, meascov_sqrtm=_meascov_factor(cache, dt, meascov_dt_scaled),
        residual_fn=lambda sigma, Wh: _factored_dare_residual(sigma, Wh, cache.A1d, cache.Ql),
        bc_nugget=bc_nugget, max_iters=max_iters, tol=tol, update_blocks=update_blocks,
    )


def _closed_loop_radius(cache, steady, apply_H, num_iters):
    """Power-iteration radius of ``T = (I - K H) A`` with the frozen gain,
    from a start vector of ``torch.Generator`` seed 0."""
    Ql = cache.Ql

    def apply_T(v):
        va = iwp.apply_stack_matrix(cache.A1d, v)
        return va - steady.L21 @ (steady.Sl_inv @ apply_H(va))

    generator = torch.Generator(device=Ql.device).manual_seed(0)
    v0 = torch.randn(Ql.shape[0], generator=generator, dtype=Ql.dtype, device=Ql.device)
    return dare.closed_loop_growth(apply_T, v0, num_iters)


def steady_closed_loop_radius(cache, steady, dt, *, num_derivatives, num_iters=256):
    """Spectral-radius estimate of the frozen white closed loop, on the
    operator the mean-only step applies (matvecs only): ``rho < 1``
    certifies the frozen-gain recursion stable."""
    p, _ = iwp.nordsieck_scales_1d(num_derivatives, dt, dtype=cache.Ql.dtype,
                                   device=cache.Ql.device)
    apply_H = _measurement_operator(cache, cache.L, p, num_derivatives + 1)
    return _closed_loop_radius(cache, steady, apply_H, num_iters)


def _torch_dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def run_steady_convergence(converge_fn, cache, C0, dt0, opts, default_tol, seed_fn=None,
                           diagnostics=None, **converge_kwargs):
    """The Riccati convergence of both solver families, in chunks.

    ``opts``: ``tol`` (``default_tol``), ``max_iters``, ``chunk_iters``,
    ``seed`` and ``dtype``. With a ``seed_fn(cache, dt) -> (C0, info)`` and
    ``seed`` not False, the doubling seed replaces ``C0`` (its ``info``
    merges into ``diagnostics``) and the recursion only polishes: by default
    at most 4 iterations in chunks of 2; unseeded, 200 in chunks of 50 (10
    when promoting). Each chunk is one :func:`converge_fn` call with
    ``harvest=False`` (each runs at least ``min(2, chunk)`` iterations), and
    convergence is checked between chunks; one last call with
    ``max_iters=0`` harvests the frozen blocks from the final factor.

    ``dtype`` (e.g. ``"float64"`` on an f32 problem) runs the recursion in
    that type on a cast of the cache, on the plain two-QR pipeline and the
    plain seed update, at ``default_tol`` 1e-8, and casts the blocks back.
    """
    out_dtype = C0.dtype
    ric_dtype = opts.get("dtype")
    promote = ric_dtype is not None and _torch_dtype(ric_dtype) != out_dtype
    if promote:
        ric_dtype = _torch_dtype(ric_dtype)
        converge_kwargs = dict(converge_kwargs, factorization=None, fused=False,
                               propagate_band=None)
        if seed_fn is not None:
            seed_fn = functools.partial(seed_fn, update_blocks=None)
        cache = type(cache)(*(x.to(ric_dtype) for x in cache))
        C0 = C0.to(ric_dtype)
        default_tol = 1e-8

    use_seed = seed_fn is not None and opts.get("seed", True)
    max_iters = opts.get("max_iters", 4 if use_seed else 200)
    if max_iters < 1:
        raise ValueError(f"steady_state max_iters must be at least 1, got {max_iters}")
    chunk = min(opts.get("chunk_iters", 2 if use_seed else (10 if promote else 50)), max_iters)
    tol = opts.get("tol", default_tol)
    if use_seed:
        debug.dump_live_arrays("pre_seed")
        C0, seed_info = seed_fn(cache, dt0)
        if diagnostics is not None:
            diagnostics.update(seed_info)

    converge = functools.partial(converge_fn, cache, dt=dt0, tol=tol, **converge_kwargs)
    total_iters, delta, C_cur = 0, float("inf"), C0
    while total_iters < max_iters and (total_iters == 0 or delta >= tol):
        sc = converge(C_cur, max_iters=chunk, harvest=False)
        C_cur, delta = sc.cov_inf, sc.delta
        total_iters += sc.iterations
    sc = converge(C_cur, max_iters=0, harvest=True)._replace(iterations=total_iters, delta=delta)
    if promote:
        sc = sc._replace(**{k: v.to(out_dtype) for k, v in sc._asdict().items()
                            if isinstance(v, torch.Tensor)})
    return sc


def _frozen_gain_update(steady, Mp, z, p, n):
    """The mean update with the frozen blocks: the residual whitened by the
    matvec ``Sl^{-1} z``, the local diffusion, ``K z = L21 (Sl^{-1} z)`` and
    the un-preconditioning. Returns ``(mean (n, d'), error, diffusion_sq)``."""
    residual_white = steady.Sl_inv @ z
    diffusion_sq = residual_white @ residual_white / z.shape[0]
    m_new_flat = iwp.mean_to_flat(Mp) - steady.L21 @ residual_white
    M_new = iwp.flat_to_mean(m_new_flat, n) * p[:, None]
    return M_new, steady.err_vec * torch.sqrt(diffusion_sq), diffusion_sq


def make_steady_state_white_step(*, cache, steady, num_derivatives):
    """Mean-only white step with frozen stationary factors: the contract of
    :func:`white_attempt_step`, the covariance passed through unchanged.
    Each step is three matvecs (``L m``, ``Sl^{-1} z``, ``L21 w``) and no
    factorization."""
    n = num_derivatives + 1
    # the scales of a dt are built once: each build copies them host to device
    scales = functools.lru_cache(maxsize=4)(functools.partial(
        iwp.nordsieck_scales_1d, num_derivatives, dtype=steady.L21.dtype,
        device=steady.L21.device))

    def step(mean, cov, t_next, dt):
        p, p_inv = scales(dt)
        Mp = cache.A1d @ (mean * p_inv[:, None])
        m_at = p[0] * Mp[0]
        z = torch.cat((p[1] * Mp[1] - cache.L @ m_at, cache.B @ m_at))
        M_new, error, diffusion_sq = _frozen_gain_update(steady, Mp, z, p, n)
        return M_new, cov, error, torch.abs(M_new[0]), diffusion_sq

    return step


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
    pre-array.

    ``steady_state`` (``True``, or a dict of :func:`run_steady_convergence`
    options; an empty dict means on) freezes the stationary covariance at
    initialization, for LINEAR solvers with a ``Constant`` rule: the steps
    then update the mean only (:attr:`steady_cache`,
    :attr:`steady_diagnostics`).
    """

    def __init__(self, *args, factorization=None, fused=True, propagate_band=None,
                 steady_state=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.steady_state = steady_state
        self.steady_cache = None
        self.steady_diagnostics = None
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
        the hook's ``.tri``, else the transposed R of ``torch.linalg.qr(C0.T)``,
        in a ``pnmol.init.interleave_retriangularize`` span."""
        if self.propagate_band != "interleaved" or self.fused:
            return C0
        tri = getattr(self.factorization, "tri", None)
        with annotate("pnmol.init.interleave_retriangularize"):
            return tri(C0) if tri is not None else sqrt.triu_qr(C0.T).T

    def _steady_options(self):
        """None when steady-state mode is off, else its options, after the
        guards of the JAX package: a LINEAR solver and a Constant rule."""
        if not (self.steady_state or isinstance(self.steady_state, dict)):
            return None
        if not self.LINEAR:
            raise ValueError(
                "steady_state mode requires a LINEAR solver: the covariance recursion is "
                "data-dependent for EK1-linearized problems."
            )
        if not isinstance(self.steprule, step_module.Constant):
            raise ValueError(
                "steady_state mode requires a Constant step rule (the stationary factors "
                "are specific to one dt)."
            )
        self.steady_diagnostics = {}
        return self.steady_state if isinstance(self.steady_state, dict) else {}

    def initialize(self, pde):
        """The initial state, in one ``pnmol.init`` span; the solver's
        ``_initialize`` marks its phases with spans inside it, named
        ``pnmol.init.<phase>`` after the JAX package's phases."""
        with annotate("pnmol.init"):
            return self._initialize(pde)

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

    def _initialize(self, pde):
        n, d = self.num_derivatives + 1, pde.L.shape[0]
        update_blocks = self._init_update_blocks(d, d)
        f = getattr(pde, "f", None)
        df = getattr(pde, "df", None)

        y0 = pde.y0
        # the reference's 1e-10 falls below f32's resolution and NaNs the path
        nugget = config.by_dtype(y0.dtype, 1e-10, 1e-5)
        diffuse_scale = self.diffuse_prior_scale

        # prior Gram, its Cholesky factor, and the closed-form y0 update
        with annotate("pnmol.init.prior_gram_cholesky_y0"):
            X = pde.mesh_spatial.points
            gram = self.spatial_kernel(X, X.T)
            chol_gram = torch.linalg.cholesky(gram)
            u0, y0_blocks = structured_init_y0(gram, chol_gram, y0, diffuse_scale, nugget, n)
            C00 = y0_blocks[0]

        # PDE measurement on the derivative-{0,1} sub-state. After the y0
        # update the mean is zero except on derivative 0, so the residual is
        # closed form: z = [-L u0 - f(u0); B u0].
        with annotate("pnmol.init.measure_assembly"):
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
        with annotate("pnmol.init.init_update_qr"):
            E_bc_nugget.diagonal().add_(nugget)
            m0, C0 = reduced_init_pde_update(
                [C00] + [B1] * (n - 1), HCsub, E_bc_nugget, z_pde, u0, update_blocks
            )
        del gram, y0_blocks, C00, B1, HCsub, E_bc_nugget  # not held through a steady seed
        C0 = self._initial_factor(C0)

        with annotate("pnmol.init.aux_Ql_Ebc"):
            self._cache = WhiteSolverCache(
                A1d=A1d, Ql=trans.process_noise_factor, L=L, B=B, E_bc_sqrtm=E_bc
            )
        opts = self._steady_options()
        if opts is None:
            self._step_fn = make_white_step_fn(
                cache=self._cache, num_derivatives=self.num_derivatives, f=f, df=df,
                linear=self.LINEAR, factorization=self.factorization, fused=self.fused,
                propagate_band=self.propagate_band,
                meascov_dt_scaled=self.meascov_dt_scaled, ek_order=self.EK_ORDER,
            )
        else:
            with annotate("pnmol.init.steady_riccati"):
                # the doubling seed's posterior update runs the init update hook
                seed_fn = functools.partial(
                    steady_state_sda_seed, num_derivatives=self.num_derivatives,
                    meascov_dt_scaled=self.meascov_dt_scaled, update_blocks=update_blocks,
                    **{k: opts[k] for k in ("bc_nugget",) if k in opts},
                )
                self.steady_cache = run_steady_convergence(
                    converge_white_steady_state, self._cache, C0, float(self.steprule.dt),
                    opts, 1e-8 if m0.dtype == torch.float64 else 1e-5, seed_fn=seed_fn,
                    diagnostics=self.steady_diagnostics, num_derivatives=self.num_derivatives,
                    fused=self.fused, factorization=self.factorization,
                    propagate_band=self.propagate_band,
                    meascov_dt_scaled=self.meascov_dt_scaled,
                )
                C0 = self.steady_cache.cov_inf
            self._step_fn = make_steady_state_white_step(
                cache=self._cache, steady=self.steady_cache,
                num_derivatives=self.num_derivatives,
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
