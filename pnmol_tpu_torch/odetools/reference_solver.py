"""Non-probabilistic reference integrators (counterpart of
:mod:`pnmol_tpu.odetools.reference_solver`).

:func:`solve_ivp_dopri5` is the adaptive Dormand-Prince 5(4) with dense
output on a fixed evaluation grid. Where the JAX package runs one
``lax.while_loop``, this runs a Python loop with one host read per attempt
(the error norm), under the same controller: the step clamped to ``tmax -
t``, the factor ``clip(0.9 norm^-0.2, 0.2, 10)`` applied after rejected
steps too, the cubic Hermite fill of the evaluation points each accepted
step passes, NaN at points never reached and ``max_steps`` attempts at most.
So it takes the JAX version's number of attempts.

:func:`solve_ivp_stiff` is scipy's LSODA on the host, for stiff systems;
``f`` and ``jac`` run on the device of ``y0``.
"""

from typing import NamedTuple

import numpy as np
import torch

from pnmol_tpu_torch.odetools.init import _DP_B, dp_stages

# 4th-order embedded weights of the Dormand-Prince pair.
_DP_B4 = np.array(
    [
        5179 / 57600,
        0.0,
        7571 / 16695,
        393 / 640,
        -92097 / 339200,
        187 / 2100,
        1 / 40,
    ]
)


class IVPSolution(NamedTuple):
    t: torch.Tensor
    y: torch.Tensor
    num_steps: int


def _dp_step(f, t, y, dt):
    """One Dormand-Prince step: 5th-order solution, error estimate, first
    and last slope."""
    k_stack = dp_stages(f, t, y, dt)
    y5 = y + dt * (torch.as_tensor(_DP_B, dtype=y.dtype, device=y.device) @ k_stack)
    y4 = y + dt * (torch.as_tensor(_DP_B4, dtype=y.dtype, device=y.device) @ k_stack)
    return y5, y5 - y4, k_stack[0], k_stack[-1]


def _hermite(t_q, t, dt, y_old, y_new, f_old, f_new):
    """Cubic Hermite interpolation on [t, t + dt] at the points ``t_q`` (q,)."""
    s = ((t_q - t) / dt)[:, None]
    h00 = (1 + 2 * s) * (1 - s) ** 2
    h10 = s * (1 - s) ** 2
    h01 = s**2 * (3 - 2 * s)
    h11 = s**2 * (s - 1)
    return h00 * y_old + h10 * dt * f_old + h01 * y_new + h11 * dt * f_new


def solve_ivp_dopri5(f, t_span, y0, t_eval, rtol=1e-8, atol=1e-10, max_steps=100_000):
    """Adaptive DP5(4) with dense output on the grid ``t_eval``.

    Returns ``IVPSolution(t_eval, y_at_t_eval (len(t_eval), d), num_steps)``
    with the number of attempts (accepted and rejected) in ``num_steps``.
    """
    t0, tmax = float(t_span[0]), float(t_span[1])
    t_eval_host = np.asarray(
        t_eval.cpu() if isinstance(t_eval, torch.Tensor) else t_eval, dtype=np.float64
    ).reshape(-1)
    t_eval = torch.as_tensor(t_eval_host, dtype=y0.dtype, device=y0.device)

    def error_norm(err, y_old, y_new):
        scale = atol + rtol * torch.maximum(torch.abs(y_old), torch.abs(y_new))
        return torch.sqrt(torch.mean((err / scale) ** 2))

    f0 = f(t0, y0)
    dt = 0.01 * float(torch.linalg.norm(y0)) / (float(torch.linalg.norm(f0)) + 1e-30)
    if not (np.isfinite(dt) and dt > 0):
        dt = 1e-6

    # NaN where the step budget runs out before tmax (a visible failure);
    # points at or below t0 take the initial value
    out = torch.full((t_eval.shape[0], y0.shape[0]), float("nan"), dtype=y0.dtype,
                     device=y0.device)
    out[torch.as_tensor(t_eval_host <= t0, device=y0.device)] = y0

    t, y, steps = t0, y0, 0
    while t < tmax and steps < max_steps:
        dt_clamped = min(dt, tmax - t)
        y_new, err, f_old, f_new = _dp_step(f, t, y, dt_clamped)
        norm = float(error_norm(err, y, y_new))
        t_next = t + dt_clamped
        if norm <= 1.0:
            window = np.nonzero((t_eval_host > t) & (t_eval_host <= t_next))[0]
            if window.size:
                index = torch.as_tensor(window, device=y0.device)
                out[index] = _hermite(t_eval[index], t, dt_clamped, y, y_new, f_old, f_new)
            t, y = t_next, y_new
        with np.errstate(divide="ignore"):
            factor = np.clip(0.9 * np.float64(norm) ** -0.2, 0.2, 10.0)
        dt = dt_clamped * float(factor)
        steps += 1
    return IVPSolution(t=t_eval, y=out, num_steps=steps)


def solve_ivp_stiff(f, t_span, y0, t_eval, rtol=1e-10, atol=1e-10, jac=None):
    """Stiff reference integrator: scipy's LSODA on the host.

    ``f`` (and ``jac``, a callable ``(t, y) -> (d, d)`` that spares LSODA
    its d extra evaluations of ``f`` per Jacobian) run on the device of
    ``y0``, with one host transfer each way per call. Same ``IVPSolution``
    contract as :func:`solve_ivp_dopri5`, with the number of ``f``
    evaluations in ``num_steps``.
    """
    from scipy.integrate import solve_ivp as scipy_solve_ivp

    dtype, device = y0.dtype, y0.device

    def on_device(y):
        return torch.as_tensor(y, dtype=dtype, device=device)

    kwargs = {}
    if jac is not None:
        kwargs["jac"] = lambda t, y: jac(t, on_device(y)).cpu().numpy()
    sol = scipy_solve_ivp(
        lambda t, y: f(t, on_device(y)).cpu().numpy(),
        (float(t_span[0]), float(t_span[1])),
        y0.cpu().numpy(),
        method="LSODA",
        rtol=rtol,
        atol=atol,
        t_eval=np.asarray(t_eval.cpu() if isinstance(t_eval, torch.Tensor) else t_eval),
        **kwargs,
    )
    if not sol.success:  # pragma: no cover - scipy failure surface
        raise RuntimeError(f"LSODA reference solve failed: {sol.message}")
    return IVPSolution(t=on_device(sol.t), y=on_device(sol.y.T), num_steps=int(sol.nfev))
