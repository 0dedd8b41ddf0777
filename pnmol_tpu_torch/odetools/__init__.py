"""ODE-solver utilities: step-size rules (constant and adaptive)."""

from pnmol_tpu_torch.odetools import step

__all__ = ["step"]
