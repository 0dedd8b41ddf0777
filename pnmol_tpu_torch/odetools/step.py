"""Step-size rules (counterpart of :mod:`pnmol_tpu.odetools.step`).

``Constant`` steps and the proportional ``Adaptive`` controller. Rules are
frozen dataclasses; their decisions take the step's error estimate as a
tensor and return tensors, which the shared controller
:func:`pnmol_tpu_torch.solvers.pdefilter.adaptive_attempt` brings to the
host once per attempt.
"""

import abc
import dataclasses
import math
from typing import Tuple

import torch


class StepRule(abc.ABC):
    """Step-size selection rule."""

    @abc.abstractmethod
    def suggest(self, previous_dt, scaled_error_estimate, local_convergence_rate=None):
        raise NotImplementedError

    @abc.abstractmethod
    def is_accepted(self, scaled_error_estimate):
        raise NotImplementedError

    def scale_error_estimate(self, unscaled_error_estimate, reference_state):
        raise NotImplementedError

    def first_dt(self, discretized_pde):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Constant(StepRule):
    """Fixed step size."""

    dt: float
    min_step: float = 1e-15
    max_step: float = 1e15

    def suggest(self, previous_dt, scaled_error_estimate, local_convergence_rate=None):
        return self.dt

    def is_accepted(self, scaled_error_estimate):
        return True

    def scale_error_estimate(self, unscaled_error_estimate, reference_state):
        # Constant steps never consult the error estimate.
        return None

    def first_dt(self, discretized_pde):
        return self.dt


@dataclasses.dataclass(frozen=True)
class Adaptive(StepRule):
    """Proportional step control on the RMS-normalized, tolerance-scaled error.

    Accept iff the scaled error is below 1; the next step is scaled by
    ``safety * (1 / error)^(1 / rate)`` clamped into ``max_changes``.
    """

    abstol: float = 1e-4
    reltol: float = 1e-2
    max_changes: Tuple[float, float] = (0.2, 10.0)
    safety_scale: float = 0.95
    min_step: float = 1e-15
    max_step: float = 1e15

    def suggest(self, previous_dt, scaled_error_estimate, local_convergence_rate=None):
        if local_convergence_rate is None:
            raise ValueError("Please provide a local convergence rate.")
        small, large = self.max_changes
        change = self.safety_scale * (1.0 / scaled_error_estimate) ** (
            1.0 / local_convergence_rate
        )
        return torch.clamp(torch.as_tensor(change), small, large) * previous_dt

    def is_accepted(self, scaled_error_estimate):
        return scaled_error_estimate < 1

    def scale_error_estimate(self, unscaled_error_estimate, reference_state):
        tolerance = self.abstol + self.reltol * reference_state
        ratio = unscaled_error_estimate / tolerance
        dim = ratio.numel() if ratio.ndim > 0 else 1
        return torch.linalg.norm(ratio) / math.sqrt(dim)

    def first_dt(self, discretized_pde):
        from pnmol_tpu_torch.models import mixins

        if not isinstance(discretized_pde, mixins.NonLinearMixIn):
            return propose_first_dt_linear(
                discretized_pde.L, discretized_pde.t0, discretized_pde.y0
            )
        return propose_first_dt(discretized_pde.f, discretized_pde.t0, discretized_pde.y0)


def propose_first_dt(f, t0, y0):
    """Heuristic first step: ``0.01 * ||y0|| / ||f(t0, y0)||``."""
    return 0.01 * torch.linalg.norm(y0) / torch.linalg.norm(f(t0, y0))


def propose_first_dt_linear(L, _, y0):
    """Linear-PDE special case of :func:`propose_first_dt` using ``L @ y0``."""
    return 0.01 * torch.linalg.norm(y0) / torch.linalg.norm(L @ y0)
