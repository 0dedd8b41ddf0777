"""Initial-value-problem container and two classic ODE test problems
(counterpart of :mod:`pnmol_tpu.odetools.ivp`).

``f(t, y)`` is a torch function that ``torch.func`` can trace (no Python
branching on tensor values); ``df`` is ``torch.func.jacfwd(f, argnums=1)``.
"""

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import jacfwd

from pnmol_tpu_torch import config


@dataclasses.dataclass(frozen=True)
class InitialValueProblem:
    r"""IVP :math:`\dot y = f(t, y),\ y(t_0) = y_0` with optional Jacobian."""

    f: Callable
    y0: torch.Tensor
    t0: float
    tmax: float
    df: Optional[Callable] = None
    df_diagonal: Optional[Callable] = None

    @property
    def dimension(self):
        return self.y0.shape[0] if self.y0.ndim > 0 else 1

    @property
    def t_span(self):
        return self.t0, self.tmax


def threebody(*, device, tmax=17.0652165601579625588917206249):
    """Restricted three-body problem (standard ODE-filter test problem)."""

    def f(_, Y):
        y1, y2, dy1, dy2 = Y
        mu = 0.012277471
        mp = 1.0 - mu
        D1 = ((y1 + mu) ** 2 + y2**2) ** 1.5
        D2 = ((y1 - mp) ** 2 + y2**2) ** 1.5
        ddy1 = y1 + 2.0 * dy2 - mp * (y1 + mu) / D1 - mu * (y1 - mp) / D2
        ddy2 = y2 - 2.0 * dy1 - mp * y2 / D1 - mu * y2 / D2
        return torch.stack([dy1, dy2, ddy1, ddy2])

    y0 = torch.tensor([0.994, 0.0, 0.0, -2.00158510637908252240537862224],
                      dtype=config.default_dtype(), device=device)
    return InitialValueProblem(f=f, df=jacfwd(f, argnums=1), y0=y0, t0=0.0, tmax=tmax)


def vanderpol(*, device, t0=0.0, tmax=30.0, y0=None, stiffness_constant=1e1):
    """Van der Pol oscillator."""

    def f(_, Y):
        return torch.stack([Y[1], stiffness_constant * ((1.0 - Y[0] ** 2) * Y[1] - Y[0])])

    y0 = torch.as_tensor([2.0, 0.0] if y0 is None else y0, dtype=config.default_dtype(),
                         device=device)
    return InitialValueProblem(f=f, df=jacfwd(f, argnums=1), y0=y0, t0=t0, tmax=tmax)
