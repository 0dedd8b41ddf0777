"""Classical ODE-filter baseline: EK1 with constant diffusion (counterpart
of :mod:`pnmol_tpu.odetools.ek1`), the method-of-lines (MOL) side of the
comparisons with the PDE filters. Consumes an
:class:`pnmol_tpu_torch.odetools.ivp.InitialValueProblem`, e.g. from
``pde.to_ivp()``.

The state is point-major Nordsieck (:mod:`pnmol_tpu_torch.ops.iwp`). Each
step runs one QR for the predict and one for the noise-free update, both
``torch.linalg.qr`` as the JAX package takes XLA's QR; the process-noise
factor ``kron(I_d, L_Q1d)`` is built once per solve. Constant steps follow
the host schedule of :func:`pnmol_tpu_torch.solvers.pdefilter.constant_step_schedule`;
adaptive steps run the JAX package's accept/reject loop.
"""

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional

import torch

from pnmol_tpu_torch.odetools import init as init_module
from pnmol_tpu_torch.odetools import step as step_module
from pnmol_tpu_torch.ops import iwp, rv, sqrt
from pnmol_tpu_torch.solvers import pdefilter as pdefilter_module


class ODEFilterState(NamedTuple):
    t: float
    y: rv.MultivariateNormal
    error_estimate: Optional[torch.Tensor]
    reference_state: Optional[torch.Tensor]
    diffusion_squared_local: torch.Tensor


@dataclasses.dataclass
class ODESolution:
    t: torch.Tensor
    mean: torch.Tensor
    cov_sqrtm: torch.Tensor
    info: Dict


def ek1_attempt_step(A1d, Ql, mean, cov_sqrtm, t_next, dt, *, f, df, num_derivatives):
    """One EK1 attempt step from the mean (n, d) and the covariance factor
    (D, D). Returns ``(mean (n, d), cov_sqrtm (D, D), error (d,), reference
    (d,), diffusion_sq ())``."""
    n = num_derivatives + 1
    d = mean.shape[1]
    p, p_inv = iwp.nordsieck_scales_1d(num_derivatives, dt, dtype=mean.dtype,
                                       device=mean.device)

    # precondition + predict mean
    M = mean * p_inv[:, None]
    Mp = A1d @ M

    # EK1 linearization at the predicted point
    m_at = p[0] * Mp[0]
    fx = f(t_next, m_at)
    Jx = df(t_next, m_at)

    def apply_H(X):
        X0 = iwp.project_derivative(X, 0, n)
        X1 = iwp.project_derivative(X, 1, n)
        return p[1] * X1 - Jx @ (p[0] * X0)

    z = p[1] * Mp[1] - fx

    # predict covariance
    Cl = iwp.scale_stack(p_inv, cov_sqrtm)
    ACl = iwp.apply_stack_matrix(A1d, Cl)
    Clp = sqrt.propagate_cholesky_factor(ACl, Ql)

    # noise-free update
    HClp = apply_H(Clp)
    Cl_new, K, Sl = sqrt.update_sqrt_no_meascov_from_products(HClp, Clp)
    m_new_flat = iwp.mean_to_flat(Mp) - K @ z

    # local diffusion + error estimate (constant-diffusion calibration); the
    # lower solve is the true Mahalanobis distance
    residual_white = torch.linalg.solve_triangular(Sl, z[:, None], upper=False)[:, 0]
    sigma_sq_local = residual_white @ residual_white / d
    error = torch.sqrt(torch.sum(Sl**2, dim=1)) * torch.sqrt(sigma_sq_local) * dt

    M_new = iwp.flat_to_mean(m_new_flat, n) * p[:, None]
    C_new = iwp.scale_stack(p, Cl_new)
    return M_new, C_new, error, torch.abs(M_new[0]), sigma_sq_local


def make_ek1_step_fn(*, f, df, num_derivatives: int, dtype, device, d: int):
    """Bind the system matrices to :func:`ek1_attempt_step`: the process-noise
    factor ``kron(I_d, L_Q1d)`` is assembled here, once, never in the loop.
    Returns ``(mean, cov_sqrtm, t_next, dt) -> step outputs``."""
    A1d, LQ1d = iwp.system_matrices_1d(num_derivatives, dtype=dtype, device=device)
    Ql = iwp.kron_point_major(torch.eye(d, dtype=dtype, device=device), LQ1d)
    return functools.partial(
        ek1_attempt_step, A1d, Ql, f=f, df=df, num_derivatives=num_derivatives
    )


class ReferenceEK1ConstantDiffusion:
    """EK1 ODE filter with quasi-MLE constant diffusion calibration."""

    def __init__(self, *, num_derivatives=4, steprule=None, initialization=None):
        self.num_derivatives = num_derivatives
        self.steprule = steprule or step_module.Adaptive()
        self.initialization = initialization or init_module.TaylorMode()
        self.iwp = None

    def initialize(self, ivp):
        y0 = ivp.y0
        d = y0.shape[0]
        dtype, device = y0.dtype, y0.device
        self.iwp = iwp.IntegratedWienerTransition(
            num_derivatives=self.num_derivatives,
            wiener_process_dimension=d,
            wp_diffusion_sqrtm=torch.eye(d, dtype=dtype, device=device),
        )
        m0, sc0 = self.initialization(
            f=ivp.f,
            df=ivp.df,
            y0=y0,
            t0=ivp.t0,
            num_derivatives=self.num_derivatives,
            wp_diffusion_sqrtm=torch.eye(1, dtype=dtype, device=device),
        )
        # per-dimension Nordsieck covariance sc0 (n, n) -> kron over points
        C0 = iwp.kron_point_major(torch.eye(d, dtype=dtype, device=device), sc0)
        self._step_fn = make_ek1_step_fn(
            f=ivp.f, df=ivp.df, num_derivatives=self.num_derivatives, dtype=dtype,
            device=device, d=d,
        )
        return ODEFilterState(
            t=float(ivp.t0),
            y=rv.MultivariateNormal(mean=m0, cov_sqrtm=C0),
            error_estimate=None,
            reference_state=None,
            diffusion_squared_local=m0.new_zeros(()),
        )

    # -- entry points --------------------------------------------------------

    def solve(self, ivp, progressbar=False):
        """Full trajectory. Returns ``(ODESolution, sigma_squared_calibrated)``."""
        if isinstance(self.steprule, step_module.Constant):
            return self._solve_constant(ivp)
        return self._solve_adaptive(ivp)

    def simulate_final_state(self, ivp, progressbar=False):
        """Final state with the calibrated covariance. Returns ``(state, info)``."""
        if isinstance(self.steprule, step_module.Constant):
            state, sigma_sq = self._solve_constant(ivp, keep_trajectory=False)
            final = state._replace(
                y=state.y._replace(cov_sqrtm=state.y.cov_sqrtm * torch.sqrt(sigma_sq))
            )
            return final, dict(num_steps=self._last_num_steps)
        sol, sigma_sq = self._solve_adaptive(ivp)
        final = ODEFilterState(
            t=float(sol.t[-1]),
            y=rv.MultivariateNormal(
                mean=sol.mean[-1], cov_sqrtm=sol.cov_sqrtm[-1] * torch.sqrt(sigma_sq)
            ),
            error_estimate=None,
            reference_state=None,
            diffusion_squared_local=sigma_sq,
        )
        return final, sol.info

    def _solve_constant(self, ivp, keep_trajectory=True):
        """Constant steps on the host schedule; without ``keep_trajectory``
        returns the final state in place of the solution."""
        state0 = self.initialize(ivp)
        ts_prev, dts = pdefilter_module.constant_step_schedule(
            ivp.t0, ivp.tmax, self.steprule.dt
        )
        ts_next = (ts_prev + dts).tolist()
        self._last_num_steps = len(dts)

        mean, cov = state0.y.mean, state0.y.cov_sqrtm
        sig_sum = mean.new_zeros(())
        means, covs = [mean], [cov]
        for t_next, dt in zip(ts_next, dts.tolist()):
            mean, cov, _, _, sig = self._step_fn(mean, cov, t_next, dt)
            sig_sum = sig_sum + sig
            if keep_trajectory:
                means.append(mean)
                covs.append(cov)
        sigma_sq = sig_sum / len(dts)
        if not keep_trajectory:
            final = ODEFilterState(
                t=ts_next[-1],
                y=rv.MultivariateNormal(mean=mean, cov_sqrtm=cov),
                error_estimate=None,
                reference_state=None,
                diffusion_squared_local=sigma_sq,
            )
            return final, sigma_sq
        sol = ODESolution(
            t=torch.tensor([float(ivp.t0)] + ts_next, dtype=mean.dtype, device=mean.device),
            mean=torch.stack(means),
            cov_sqrtm=torch.stack(covs),
            info=dict(num_steps=len(dts), num_attempted_steps=len(dts)),
        )
        return sol, sigma_sq

    def _solve_adaptive(self, ivp):
        """Adaptive solve: the accept/reject loop, one host read per attempt."""
        state = self.initialize(ivp)
        mean, cov = state.y.mean, state.y.cov_sqrtm
        ts, means, covs, sigmas = [state.t], [mean], [cov], []
        dt = float(step_module.propose_first_dt(ivp.f, ivp.t0, ivp.y0))
        info = dict(num_steps=0, num_attempted_steps=0)
        rate = self.num_derivatives + 1
        t, tmax = float(ivp.t0), float(ivp.tmax)
        while t < tmax:
            new_mean, new_cov, err, ref, sig = self._step_fn(mean, cov, t + dt, dt)
            info["num_attempted_steps"] += 1
            scaled = self.steprule.scale_error_estimate(dt * err, ref)
            accepted = bool(self.steprule.is_accepted(scaled))
            suggested = float(
                self.steprule.suggest(dt, scaled, local_convergence_rate=rate)
            )
            if accepted:
                t += dt
                mean, cov = new_mean, new_cov
                info["num_steps"] += 1
                ts.append(t)
                means.append(mean)
                covs.append(cov)
                sigmas.append(sig)
            dt = min(suggested, tmax - t)
            if dt <= 0 and t < tmax:
                dt = tmax - t
        sigma_sq = torch.stack(sigmas).mean()
        sol = ODESolution(
            t=torch.tensor(ts, dtype=mean.dtype, device=mean.device),
            mean=torch.stack(means),
            cov_sqrtm=torch.stack(covs),
            info=info,
        )
        return sol, sigma_sq


# Convenience alias matching the generic name.
ReferenceEK1 = ReferenceEK1ConstantDiffusion
