"""Failure detection and recovery for long solves.

Counterpart of :mod:`pnmol_tpu.utils.resilience`: periodic checkpoints
(:mod:`pnmol_tpu_torch.utils.checkpoint`), NaN and inf detection at step
(constant rules) or attempt (adaptive rules) granularity, and a restart
from the last checkpoint with a smaller step.
"""

import dataclasses
import math
import pathlib
from typing import Optional

import torch

from pnmol_tpu_torch.odetools import step as step_module
from pnmol_tpu_torch.solvers import pdefilter
from pnmol_tpu_torch.utils import checkpoint as checkpoint_module


@dataclasses.dataclass
class ResilienceReport:
    num_steps: int = 0
    num_checkpoints: int = 0
    num_failures: int = 0
    num_restarts: int = 0
    final_dt: Optional[float] = None


def _finite(*tensors):
    return all(bool(torch.isfinite(x).all()) for x in tensors)


def solve_resilient(solver, pde, *, checkpoint_dir, checkpoint_every=50, max_restarts=3,
                    dt_backoff=0.5):
    """Run ``solver`` on ``pde`` to ``tmax`` with checkpoint and restart.

    Every ``checkpoint_every`` accepted steps the state (and dt) is written
    to ``checkpoint_dir/latest.npz``. A non-finite state, or for adaptive
    rules a non-finite attempt (state, suggested dt or error estimate: a
    NaN attempt is always rejected and its state masked back, so only the
    controller's outputs show it), reloads the last checkpoint on the
    state's device and restarts with ``dt * dt_backoff``; more than
    ``max_restarts`` failures raise ``FloatingPointError``. Adaptive
    attempts go through :func:`pnmol_tpu_torch.solvers.pdefilter.
    adaptive_attempt`, the controller of every driver. Returns
    ``(final_state, ResilienceReport)``, the factor scaled by the mean of
    the accepted steps' local diffusions. Rules other than ``Constant`` and
    ``Adaptive`` raise ``NotImplementedError``. A failure that the step
    deferred (:func:`pnmol_tpu_torch.solvers.pdefilter.raise_deferred_failure`)
    raises at the attempt's own check, before a checkpoint can hold its state.
    """
    adaptive = isinstance(solver.steprule, step_module.Adaptive)
    if not adaptive and not isinstance(solver.steprule, step_module.Constant):
        raise NotImplementedError("solve_resilient requires a Constant or Adaptive step rule.")
    if adaptive and not solver.supports_adaptive_steps:
        raise ValueError(f"{type(solver).__name__} has no error estimate.")

    checkpoint_dir = pathlib.Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    ckpt_path = checkpoint_dir / "latest"
    report = ResilienceReport()

    state = solver.initialize(pde)
    device = state.y.mean.device
    step_fn = solver._step_function(pde)
    if adaptive:
        dt = float(solver.steprule.first_dt(pde))
        rate = solver.num_derivatives + 1
    else:
        dt = float(solver.steprule.dt)

    def save():
        checkpoint_module.save_state(ckpt_path, state,
                                     extra={"dt": torch.tensor(dt, dtype=torch.float64)})
        report.num_checkpoints += 1

    save()
    diffusions = []
    restarts = steps_since_ckpt = 0
    tmax = float(pde.tmax)
    t_eps = 1e-12 * max(1.0, abs(tmax))

    while tmax - state.t > t_eps:
        this_dt = min(dt, tmax - state.t)
        failed = False
        if adaptive:
            # one ACCEPTED step, the NaN check on every attempt
            t_c, mean_c, cov_c, dt_c = state.t, state.y.mean, state.y.cov_sqrtm, this_dt
            while True:
                t_c, mean_c, cov_c, dt_c, accepted, error, ref, diff_sq, _ = (
                    pdefilter.adaptive_attempt(step_fn, solver.steprule, rate, t_c, mean_c,
                                               cov_c, dt_c, tmax))
                if not (math.isfinite(dt_c) and _finite(mean_c, cov_c, error)):
                    failed = True
                    break
                if accepted:
                    break
            if not failed:
                proposed = pdefilter.PDEFilterState(
                    t=t_c, y=state.y._replace(mean=mean_c, cov_sqrtm=cov_c),
                    error_estimate=error, reference_state=ref, diffusion_squared_local=diff_sq)
                next_dt = dt_c
        else:
            proposed, _ = solver.attempt_step(state, this_dt, pde)
            next_dt = dt
            pdefilter.raise_deferred_failure(step_fn)  # the adaptive loop reads it per attempt
            failed = not _finite(proposed.y.mean, proposed.y.cov_sqrtm)

        if failed:
            report.num_failures += 1
            if restarts >= max_restarts:
                raise FloatingPointError(
                    f"Solve diverged at t={state.t:.6g} after {max_restarts} restarts.")
            restarts += 1
            report.num_restarts += 1
            state, extra = checkpoint_module.load_state(ckpt_path, device=device)
            dt = float(extra["dt"]) * dt_backoff
            steps_since_ckpt = 0
            continue

        state, dt = proposed, next_dt
        report.num_steps += 1
        diffusions.append(proposed.diffusion_squared_local)
        steps_since_ckpt += 1
        if steps_since_ckpt >= checkpoint_every:
            save()
            steps_since_ckpt = 0

    report.final_dt = dt
    diffusion = torch.stack(diffusions).mean() if diffusions else state.y.mean.new_ones(())
    final = state._replace(y=state.y._replace(cov_sqrtm=state.y.cov_sqrtm * torch.sqrt(diffusion)))
    return final, report
