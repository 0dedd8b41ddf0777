"""ODE-solver utilities: step-size rules, the IVP container and test
problems, the initialization routines, the reference integrators and the
MOL baseline EK1 ODE filter."""

from pnmol_tpu_torch.odetools import step
from pnmol_tpu_torch.odetools import ek1, init, ivp, reference_solver

__all__ = ["ek1", "init", "ivp", "reference_solver", "step"]
