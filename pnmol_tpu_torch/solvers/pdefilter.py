"""PDE-filter state containers, the step controller and the solve loop.

Counterpart of :mod:`pnmol_tpu.solvers.pdefilter`. Where the JAX package
runs a jitted ``lax.scan`` (constant steps) or ``lax.while_loop`` (adaptive
steps), the port runs ONE Python loop, :meth:`PDEFilter.solution_generator`,
which ``solve`` and ``simulate_final_state`` consume. Constant steps follow
the closed-form host schedule of the scan; every other step goes through
the one controller :func:`adaptive_attempt`. Both call the solver's single
step function ``(mean, cov, t_next, dt) -> (mean, cov, error, reference,
diffusion_sq)``.
"""

import dataclasses
import math
from abc import ABC, abstractmethod
from typing import Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch

from pnmol_tpu_torch import kernels
from pnmol_tpu_torch.odetools import step as step_module
from pnmol_tpu_torch.ops import rv
from pnmol_tpu_torch.utils.profiling import annotate


class PDEFilterState(NamedTuple):
    """Filter state at one time point."""

    t: float
    y: rv.MultivariateNormal
    error_estimate: Optional[torch.Tensor]
    reference_state: Optional[torch.Tensor]
    diffusion_squared_local: torch.Tensor


@dataclasses.dataclass
class PDESolution:
    t: torch.Tensor
    mean: torch.Tensor
    cov_sqrtm: torch.Tensor
    info: Dict
    diffusion_squared_calibrated: torch.Tensor


def _empty_info():
    return dict(
        num_f_evaluations=0,
        num_df_evaluations=0,
        num_df_diagonal_evaluations=0,
        num_steps=0,
        num_attempted_steps=0,
    )


def constant_step_schedule(t0, tmax, dt):
    """Host-side step schedule for constant steps, landing exactly on tmax.

    Built in closed form: float accumulation can leave a ~1e-16 residual
    step, and the Nordsieck preconditioner scales by ``dt^-(nu+1/2)``.
    Returns ``(ts_prev, dts)``.
    """
    t0, tmax, dt = float(t0), float(tmax), float(dt)
    num_steps = max(1, int(np.ceil((tmax - t0) / dt - 1e-12)))
    ts = t0 + dt * np.arange(num_steps)
    dts = np.full(num_steps, dt)
    dts[-1] = tmax - ts[-1]
    # merge a roundoff-sized final sliver (never a genuine remainder step)
    if num_steps > 1 and dts[-1] < 1e-8 * dt:
        ts = ts[:-1]
        dts = dts[:-1]
        dts[-1] = tmax - ts[-1]
    return ts, dts


def adaptive_attempt(step_fn, steprule, rate, t, mean, cov, dt, tmax):
    """One attempt and its step-control decision: the one controller of
    every non-scheduled step (adaptive rules, and constant rules with time
    stops).

    ``t``, ``dt`` and ``tmax`` are Python floats; the decision comes to the
    host once (``accepted``). Returns ``(t_new, mean_new, cov_new, dt_new,
    accepted, error, ref, diff_sq, scaled_error)``: the state outputs are
    those of the attempt if it is accepted and the inputs otherwise,
    ``error``/``ref``/``diff_sq`` are the attempt's own. The attempt is one
    ``pnmol.step`` span, the decision and its host reads a
    ``pnmol.step.control`` span inside it.
    """
    with annotate("pnmol.step"):
        new_mean, new_cov, error, ref, diff_sq = step_fn(mean, cov, t + dt, dt)
        with annotate("pnmol.step.control"):
            scaled = steprule.scale_error_estimate(dt * error, ref)
            accepted = bool(steprule.is_accepted(scaled))
            suggested = float(steprule.suggest(dt, scaled, local_convergence_rate=rate))
            if accepted:
                t, mean, cov = t + dt, new_mean, new_cov
            dt_new = min(suggested, tmax - t)
    return t, mean, cov, dt_new, accepted, error, ref, diff_sq, scaled


class _TimeStopper:
    """Clamp dt so the solver lands exactly on requested output times."""

    def __init__(self, locations: Iterable):
        self._locations = iter(locations)
        self._next_location = next(self._locations)

    def adjust_dt_to_time_stops(self, t, dt):
        if t >= self._next_location:
            try:
                self._next_location = next(self._locations)
            except StopIteration:
                self._next_location = np.inf
        if t + dt > self._next_location:
            dt = self._next_location - t
        return dt


class _ProgressBar:
    def __init__(self, tmax, steps=100):
        import tqdm

        self._tmax = float(tmax)
        self._increment = self._tmax / steps
        self._threshold = self._increment
        self._bar = tqdm.tqdm(total=steps)

    def advance_to(self, t, dt):
        while t + dt >= self._threshold:
            self._bar.update()
            self._threshold += self._increment
        self._bar.set_description(f"t={t:.4f}, dt={dt:.2E}")

    def close(self, t, dt):
        self._bar.update()
        self._bar.set_description(f"t={t:.4f}, dt={dt:.2E}")
        self._bar.close()


def _make_progressbar(enabled, tmax):
    if not enabled:
        return None
    try:
        return _ProgressBar(tmax)
    except ImportError:
        return None


class PDEFilter(ABC):
    """Filtering-based PDE solver interface."""

    def __init__(self, *, steprule=None, num_derivatives=2, spatial_kernel=None,
                 diffuse_prior_scale=1e0):
        self.steprule = steprule or step_module.Adaptive()
        self.num_derivatives = num_derivatives
        self.spatial_kernel = (
            spatial_kernel
            if spatial_kernel is not None
            else kernels.Matern52() + kernels.WhiteNoise()
        )
        self.diffuse_prior_scale = diffuse_prior_scale
        self.iwp = None  # filled by initialize()

    @abstractmethod
    def initialize(self, pde) -> PDEFilterState:
        raise NotImplementedError

    @abstractmethod
    def _step_function(self, pde):
        """The step ``(mean, cov, t_next, dt) -> (mean, cov, error,
        reference, diffusion_sq)``; valid after ``initialize``."""
        raise NotImplementedError

    @property
    def supports_adaptive_steps(self):
        return True

    def attempt_step(self, state, dt, pde, t_next=None):
        """One attempt ``state -> (state at t_next, info)``, one
        ``pnmol.step`` span; ``t_next`` defaults to ``state.t + dt``."""
        t_next = state.t + dt if t_next is None else t_next
        with annotate("pnmol.step"):
            mean, cov, error, reference, diff_sq = self._step_function(pde)(
                state.y.mean, state.y.cov_sqrtm, t_next, dt
            )
        new_state = PDEFilterState(
            t=t_next,
            y=rv.MultivariateNormal(mean=mean, cov_sqrtm=cov),
            error_estimate=error,
            reference_state=reference,
            diffusion_squared_local=diff_sq,
        )
        return new_state, dict(num_f_evaluations=1, num_df_evaluations=1)

    def solution_generator(self, pde, /, *, stop_at=None, progressbar=False):
        """Yield ``(state, info)``: the initial state, then one per accepted
        step. The one loop behind ``solve`` and ``simulate_final_state``."""
        time_stopper = _TimeStopper(stop_at) if stop_at is not None else None
        state = self.initialize(pde)
        info = _empty_info()
        yield state, info

        tmax = float(pde.tmax)
        dt = float(self.steprule.first_dt(pde))
        schedule = None
        if isinstance(self.steprule, step_module.Constant) and stop_at is None:
            ts_prev, dts = constant_step_schedule(pde.t0, tmax, dt)
            schedule = iter(zip((ts_prev + dts).tolist(), dts.tolist()))
        pbar = _make_progressbar(progressbar, tmax)
        # epsilon guard: a residual step of ~1e-16 would blow up the
        # dt^-(nu+1/2) preconditioner (see constant_step_schedule)
        t_eps = 1e-12 * max(1.0, abs(tmax))
        while tmax - state.t > t_eps:
            if pbar is not None:
                pbar.advance_to(state.t, dt=dt)
            if schedule is not None:
                t_next, dt = next(schedule)
                state, step_info = self.attempt_step(state, dt, pde, t_next)
                step_info["num_attempted_steps"] = 1
            else:
                if time_stopper is not None:
                    dt = time_stopper.adjust_dt_to_time_stops(state.t, dt)
                state, dt, step_info = self.perform_full_step(state, dt, pde)
            info["num_steps"] += 1
            for key, value in step_info.items():
                info[key] += value
            yield state, info

        if pbar is not None:
            pbar.close(state.t, dt=dt)

    def perform_full_step(self, state, initial_dt, pde):
        """One accepted step, including the attempt/reject loop, through
        :func:`adaptive_attempt`. Returns ``(state, next dt, step_info)``."""
        step_fn = self._step_function(pde)
        rate = self.num_derivatives + 1
        tmax = float(pde.tmax)
        step_info = dict(num_f_evaluations=0, num_df_evaluations=0,
                         num_attempted_steps=0)
        t, mean, cov, dt = state.t, state.y.mean, state.y.cov_sqrtm, float(initial_dt)
        accepted = False
        while not accepted:
            t, mean, cov, dt, accepted, error, ref, diff_sq, _ = adaptive_attempt(
                step_fn, self.steprule, rate, t, mean, cov, dt, tmax
            )
            for key in step_info:
                step_info[key] += 1
            if not math.isfinite(dt):
                # a NaN attempt is always rejected (NaN error compares
                # False) and the state stays finite: the non-finite
                # suggested dt is the divergence signal
                raise FloatingPointError(
                    f"Adaptive solve diverged at t={t:.6g}: the attempted step "
                    "produced a non-finite error estimate (step size suggestion "
                    "is NaN). Reduce dt/tolerances."
                )
        new_state = PDEFilterState(
            t=t,
            y=rv.MultivariateNormal(mean=mean, cov_sqrtm=cov),
            error_estimate=error,
            reference_state=ref,
            diffusion_squared_local=diff_sq,
        )
        return new_state, dt, step_info

    def solve(self, pde, /, *, stop_at=None, progressbar=False, max_steps=None):
        """Full trajectory; keeps every accepted step's covariance factor.

        With an ``Adaptive`` rule and no ``stop_at``, ``max_steps`` bounds the
        number of accepted steps, as the JAX package's preallocated buffer
        does: the solve raises if it needs more.
        """
        bounded = (
            max_steps is not None
            and stop_at is None
            and isinstance(self.steprule, step_module.Adaptive)
        )
        t_eps = 1e-12 * max(1.0, abs(float(pde.tmax)))
        times, means, covs, diffusions = [], [], [], []
        for state, info in self.solution_generator(
            pde, stop_at=stop_at, progressbar=progressbar
        ):
            times.append(state.t)
            means.append(state.y.mean)
            covs.append(state.y.cov_sqrtm)
            if info["num_steps"]:
                diffusions.append(state.diffusion_squared_local)
            if (bounded and info["num_steps"] >= max_steps
                    and float(pde.tmax) - state.t > t_eps):
                raise RuntimeError(
                    f"Adaptive solve needed more than max_steps={max_steps} "
                    f"accepted steps (reached t={state.t:.6g} of {pde.tmax}); "
                    "raise max_steps or use simulate_final_state/solution_generator."
                )
        return PDESolution(
            t=torch.tensor(times, dtype=means[0].dtype, device=means[0].device),
            mean=torch.stack(means),
            cov_sqrtm=torch.stack(covs),
            info=info,
            diffusion_squared_calibrated=_calibrated(diffusions, means[0]),
        )

    def simulate_final_state(self, pde, /, *, stop_at=None, progressbar=False):
        """Final state with the covariance scaled by the calibrated diffusion
        (the mean of the accepted steps' local diffusions; 1 if no step)."""
        diffusions = []
        for state, info in self.solution_generator(
            pde, stop_at=stop_at, progressbar=progressbar
        ):
            if info["num_steps"]:
                diffusions.append(state.diffusion_squared_local)
        diffusion = _calibrated(diffusions, state.y.mean)
        final = PDEFilterState(
            t=state.t,
            y=state.y._replace(cov_sqrtm=state.y.cov_sqrtm * torch.sqrt(diffusion)),
            error_estimate=None,
            reference_state=None,
            diffusion_squared_local=diffusion,
        )
        return final, info


def _calibrated(diffusions, like):
    """Mean of the local diffusions; 1 when no step was taken (tmax within
    epsilon of t0): no calibration data, the covariance stays unscaled."""
    if not diffusions:
        return like.new_ones(())
    return torch.stack(diffusions).mean()
