"""Initialization routines of the ODE filter (counterpart of
:mod:`pnmol_tpu.odetools.init`).

* :class:`TaylorMode`: the exact derivatives of the solution at t0, by
  nested ``torch.func.jvp`` along the autonomized vector field.
* :class:`Stack`: ``[y0, f(y0), df(y0) f(y0), 0, ...]`` with a large
  variance on the unknown rows.
* :class:`RungeKutta`: the Nordsieck stack fitted to a few fixed
  Dormand-Prince(5) steps by a 1-D preconditioned Kalman filter and a
  square-root smoother. The forward and backward passes are Python loops,
  as in the JAX package.

Every routine returns ``(mean (nu + 1, d), cov_sqrtm (nu + 1, nu + 1))``
on the device of ``y0``.
"""

import abc

import numpy as np
import torch
from torch.func import jvp

from pnmol_tpu_torch.ops import iwp, kalman, sqrt


class InitializationRoutine(abc.ABC):
    @abc.abstractmethod
    def __call__(self, f, df, y0, t0, num_derivatives, wp_diffusion_sqrtm):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Taylor-mode initialization
# ---------------------------------------------------------------------------


class TaylorMode(InitializationRoutine):
    def __call__(self, f, df, y0, t0, num_derivatives, wp_diffusion_sqrtm=None):
        m0 = TaylorMode.taylor_mode(fun=f, y0=y0, t0=t0, num_derivatives=num_derivatives)
        return m0, y0.new_zeros((num_derivatives + 1, num_derivatives + 1))

    def __repr__(self):
        return f"{self.__class__.__name__}()"

    @staticmethod
    def taylor_mode(fun, y0, t0, num_derivatives):
        """Exact derivatives ``d^k y / dt^k`` at t0, k = 0..nu, shape (nu + 1, d).

        The state is extended with time, ``z = (y, t)``, so the field
        ``g(z) = (f(t, y), 1)`` is autonomous. Then ``F_0(z) = y`` and
        ``F_{k+1}(z) = jvp(F_k, (z,), (g(z),))``, the Lie derivative along g,
        and ``F_k(z0)`` is the k-th derivative. Where the JAX package
        propagates Taylor coefficients with ``jax.experimental.jet``, this
        nests ``torch.func.jvp``: about ``2^k`` evaluations of ``f`` for the
        k-th derivative, fine for nu <= 4 at the sizes the filter runs.
        """
        t0 = torch.as_tensor(t0, dtype=y0.dtype, device=y0.device)
        z0 = torch.cat((y0.reshape(-1), t0.reshape(1)))
        one = z0.new_ones((1,))

        def field(z):
            y, t = z[:-1].reshape(y0.shape), z[-1]
            return torch.cat((fun(t, y).reshape(-1), one))

        def lie(F):
            def derivative(z):
                return jvp(F, (z,), (field(z),))[1]

            return derivative

        derivs, F = [], lambda z: z[:-1].reshape(y0.shape)
        for _ in range(num_derivatives + 1):
            derivs.append(F(z0))
            F = lie(F)
        return torch.stack(derivs)


# ---------------------------------------------------------------------------
# Stack initialization
# ---------------------------------------------------------------------------


class Stack(InitializationRoutine):
    def __init__(self, use_df=True):
        self.use_df = use_df

    def __call__(self, f, df, y0, t0, num_derivatives, wp_diffusion_sqrtm=None):
        d = y0.shape[0]
        n = num_derivatives + 1
        fy = f(t0, y0)
        rows = [y0, fy, df(t0, y0) @ fy] if self.use_df else [y0, fy]
        known = len(rows)
        mean = torch.stack(rows + [y0.new_zeros(d)] * (n - known))
        cov_sqrtm = torch.diag(torch.tensor([0.0] * known + [1e3] * (n - known),
                                            dtype=y0.dtype, device=y0.device))
        return mean, cov_sqrtm


# ---------------------------------------------------------------------------
# Runge-Kutta initialization
# ---------------------------------------------------------------------------

# Dormand-Prince 5(4) Butcher tableau (the classic RK45 pair's 5th-order row),
# as host numpy constants.
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DP_A = np.array(
    [
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [1 / 5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [3 / 40, 9 / 40, 0.0, 0.0, 0.0, 0.0, 0.0],
        [44 / 45, -56 / 15, 32 / 9, 0.0, 0.0, 0.0, 0.0],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0.0, 0.0, 0.0],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0.0, 0.0],
        [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0],
    ]
)
_DP_B = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])


def dp_stages(f, t, y, dt):
    """The seven Dormand-Prince stage slopes at ``(t, y)``, stacked (7, d)."""
    ks = []
    for i in range(7):
        yi = y
        for j, k in enumerate(ks):
            yi = yi + dt * _DP_A[i, j] * k
        ks.append(f(t + _DP_C[i] * dt, yi))
    return torch.stack(ks)


def rk_step_dopri5(f, t, y, dt):
    """One fixed-step Dormand-Prince(5) step."""
    k_stack = dp_stages(f, t, y, dt)
    weights = torch.as_tensor(_DP_B, dtype=y.dtype, device=y.device)
    return y + dt * (weights @ k_stack)


class RungeKutta(InitializationRoutine):
    def __init__(self, dt=0.01, method="RK45", use_df=True):
        self.dt = dt
        self.method = method  # kept for API parity; dopri5 is always used
        self.stack_initvals = Stack(use_df=use_df)

    def __repr__(self):
        return f"{self.__class__.__name__}(dt={self.dt}, method={self.method})"

    def __call__(self, f, df, y0, t0, num_derivatives, wp_diffusion_sqrtm):
        num_steps = num_derivatives + 1
        ts, ys = self.rk_data(f=f, t0=t0, dt=self.dt, num_steps=num_steps, y0=y0)
        m, sc = self.stack_initvals(
            f=f, df=df, y0=y0, t0=t0, num_derivatives=num_derivatives
        )
        return RungeKutta.rk_init_improve(
            m=m, sc=sc, t0=t0, ts=ts, ys=ys, wp_diffusion_sqrtm=wp_diffusion_sqrtm
        )

    @staticmethod
    def rk_data(f, t0, dt, num_steps, y0):
        """Fixed-step Dormand-Prince trajectory at t0 + k dt, k = 0..num_steps-1:
        ``(ts (num_steps,), ys (num_steps, d))``."""
        ts = t0 + dt * torch.arange(num_steps, dtype=y0.dtype, device=y0.device)
        ys = [y0]
        for t in ts[:-1]:
            ys.append(rk_step_dopri5(f, t, ys[-1], dt))
        return ts, torch.stack(ys)

    @staticmethod
    def rk_init_improve(m, sc, t0, ts, ys, wp_diffusion_sqrtm):
        """Fit the Nordsieck stack to RK data: a 1-D preconditioned Kalman
        filter forward, a square-root smoother backward."""
        num_derivatives = m.shape[0] - 1
        prior = iwp.IntegratedWienerTransition(
            num_derivatives=num_derivatives,
            wiener_process_dimension=m.shape[1] // 2,
            wp_diffusion_sqrtm=wp_diffusion_sqrtm,
        )
        phi_1d, sq_1d = prior.preconditioned_discretize_1d

        # Forward filtering pass, keeping all intermediates for smoothing.
        filter_res = [(m, sc, None, None, None, None, None, None)]
        t_loc = t0
        for t, y in zip(ts[1:], ys[1:]):
            dt = t - t_loc
            p_raw, p_inv_raw = prior.nordsieck_preconditioner_1d_raw(dt)
            m, sc, m_pred, sc_pred, sgain, x = RungeKutta._forward_filter_step(
                y, sc, m, sq_1d, p_raw, p_inv_raw, phi_1d
            )
            filter_res.append((m, sc, sgain, m_pred, sc_pred, x, p_raw, p_inv_raw))
            t_loc = t

        # Backward smoothing pass.
        m_fut, sc_fut, sgain_fut, m_pred, _, x, p_raw, p_inv_raw = filter_res[-1]
        for entry in reversed(filter_res[:-1]):
            m_, sc_ = entry[0], entry[1]
            m_pre, sc_pre = p_inv_raw[:, None] * m_, p_inv_raw[:, None] * sc_
            m_fut_pre = p_inv_raw[:, None] * m_fut
            sc_fut_pre = p_inv_raw[:, None] * sc_fut

            m_sm, sc_sm = kalman.smoother_step_sqrt(
                mean=m_pre,
                cov_l=sc_pre,
                mean_next=m_fut_pre,
                cov_l_next=sc_fut_pre,
                smoothing_gain=sgain_fut,
                proc_noise_l=sq_1d,
                mean_pred=m_pred,
                transited_l=x,
            )
            m_fut, sc_fut = p_raw[:, None] * m_sm, p_raw[:, None] * sc_sm
            _, _, sgain_fut, m_pred, _, x, p_raw, p_inv_raw = entry

        return m_fut, sc_fut

    @staticmethod
    def _forward_filter_step(y, sc, m, sq_1d, p_raw, p_inv_raw, phi_1d):
        """One preconditioned predict + observe-0th-derivative update, batched
        over the state dimension by broadcasting."""
        # into preconditioned coordinates
        m = p_inv_raw[:, None] * m
        sc = p_inv_raw[:, None] * sc

        # predict
        m_pred = phi_1d @ m
        x = phi_1d @ sc
        sc_pred = sqrt.propagate_cholesky_factor(x, sq_1d)

        # smoothing gain
        cross = sc @ x.T
        sgain = torch.cholesky_solve(cross.T, sc_pred, upper=False).T

        # observe the 0th derivative in non-preconditioned coordinates
        sc_pred_np = p_raw[:, None] * sc_pred
        h_sc_pred = sc_pred_np[0, :]
        s = h_sc_pred @ h_sc_pred
        cross_obs = sc_pred @ h_sc_pred
        kgain = cross_obs / s
        z = (p_raw[:, None] * m_pred)[0]

        m_loc = m_pred - kgain[:, None] * (z - y)[None, :]
        sc_loc = sc_pred - kgain[:, None] * h_sc_pred[None, :]

        # back to non-preconditioned coordinates
        return (
            p_raw[:, None] * m_loc,
            p_raw[:, None] * sc_loc,
            m_pred,
            sc_pred,
            sgain,
            x,
        )
