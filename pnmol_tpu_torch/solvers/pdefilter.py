"""PDE-filter state containers and the constant-step solve loops.

Counterpart of :mod:`pnmol_tpu.solvers.pdefilter` on the ``Constant`` step
path. Where the JAX package runs a jitted ``lax.scan`` over the host step
schedule, the port runs a Python loop over the same schedule; ``solve``,
``simulate_final_state`` and ``solution_generator`` all consume it.
"""

import dataclasses
from abc import ABC, abstractmethod
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from pnmol_tpu_torch import kernels
from pnmol_tpu_torch.odetools import step as step_module
from pnmol_tpu_torch.ops import rv


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


class PDEFilter(ABC):
    """Filtering-based PDE solver interface (constant steps)."""

    def __init__(self, *, steprule=None, num_derivatives=2, spatial_kernel=None,
                 diffuse_prior_scale=1e0):
        if not isinstance(steprule, step_module.Constant):
            raise NotImplementedError(
                "only Constant step rules are ported; adaptive steps are "
                "ROADMAP queue 1, item 9"
            )
        self.steprule = steprule
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
    def attempt_step(self, state, dt, t_next):
        """One step ``state -> (state at t_next, info)``."""
        raise NotImplementedError

    def solution_generator(self, pde):
        """Yield ``(state, info)``: the initial state, then one per step."""
        state = self.initialize(pde)
        info = _empty_info()
        yield state, info
        ts_prev, dts = constant_step_schedule(
            pde.t0, pde.tmax, self.steprule.first_dt(pde)
        )
        for t_prev, dt in zip(ts_prev, dts):
            state, step_info = self.attempt_step(state, float(dt), float(t_prev + dt))
            info["num_steps"] += 1
            info["num_attempted_steps"] += 1
            for key, value in step_info.items():
                info[key] += value
            yield state, info

    def solve(self, pde):
        """Full trajectory; keeps every step's covariance factor."""
        times, means, covs, diffusions = [], [], [], []
        for state, info in self.solution_generator(pde):
            times.append(state.t)
            means.append(state.y.mean)
            covs.append(state.y.cov_sqrtm)
            diffusions.append(state.diffusion_squared_local)
        return PDESolution(
            t=torch.tensor(times, dtype=means[0].dtype, device=means[0].device),
            mean=torch.stack(means),
            cov_sqrtm=torch.stack(covs),
            info=info,
            diffusion_squared_calibrated=torch.stack(diffusions[1:]).mean(),
        )

    def simulate_final_state(self, pde):
        """Final state with the covariance scaled by the calibrated diffusion."""
        diff_sum, num_steps = 0.0, 0
        for state, info in self.solution_generator(pde):
            if info["num_steps"]:
                diff_sum = diff_sum + state.diffusion_squared_local
                num_steps += 1
        diffusion = diff_sum / num_steps
        final = PDEFilterState(
            t=state.t,
            y=state.y._replace(cov_sqrtm=state.y.cov_sqrtm * torch.sqrt(diffusion)),
            error_estimate=None,
            reference_state=None,
            diffusion_squared_local=diffusion,
        )
        return final, info
