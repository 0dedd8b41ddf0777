"""ODE-solver utilities: step-size rules."""

from pnmol_tpu_torch.odetools import step

__all__ = ["step"]
