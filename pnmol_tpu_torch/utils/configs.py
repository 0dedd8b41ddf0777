"""Typed experiment and solver configuration.

Counterpart of :mod:`pnmol_tpu.utils.configs`: frozen dataclasses bundle
the problem recipe, the solver and the run; ``build(device=...)``
materializes the port's ``(pde, solver)``. The defaults are the JAX
package's.
"""

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    family: str = "heat"  # heat | spruce | sir | lotka_volterra
    dx: float = 0.05
    t0: float = 0.0
    tmax: float = 5.0
    bcond: str = "dirichlet"
    stencil_size_interior: int = 3
    stencil_size_boundary: int = 3
    nugget_gram_matrix_fd: float = 0.0
    extra: Tuple[Tuple[str, float], ...] = ()

    def build(self, *, device):
        """The discretized problem of ``family`` on ``device``."""
        from pnmol_tpu_torch.models import examples

        kwargs = dict(
            device=device,
            dx=self.dx,
            t0=self.t0,
            tmax=self.tmax,
            stencil_size_interior=self.stencil_size_interior,
            stencil_size_boundary=self.stencil_size_boundary,
            nugget_gram_matrix_fd=self.nugget_gram_matrix_fd,
            **dict(self.extra),
        )
        if self.family == "heat":
            return examples.heat_1d_discretized(bcond=self.bcond, **kwargs)
        if self.family == "spruce":
            return examples.spruce_budworm_1d_discretized(bcond=self.bcond, **kwargs)
        if self.family == "sir":
            return examples.sir_1d_discretized(**kwargs)
        if self.family == "lotka_volterra":
            return examples.lotka_volterra_1d_discretized(**kwargs)
        raise ValueError(f"Unknown problem family: {self.family!r}")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    method: str = "white"  # white | latent
    linearity: str = "linear"  # linear | semilinear
    num_derivatives: int = 2
    diffuse_prior_scale: float = 1.0
    # step rule
    steprule: str = "adaptive"  # adaptive | constant
    dt: Optional[float] = None  # required for constant
    abstol: float = 1e-4
    reltol: float = 1e-2
    # spatial prior kernel
    prior_kernel: str = "matern52+white"  # matern52+white | matern52 | sqexp
    prior_input_scale: float = 1.0
    prior_duplicates: int = 1  # >1 for PDE systems

    def _kernel(self):
        from pnmol_tpu_torch import kernels

        base = {
            "matern52+white": lambda: kernels.Matern52(input_scale=self.prior_input_scale)
            + kernels.WhiteNoise(),
            "matern52": lambda: kernels.Matern52(input_scale=self.prior_input_scale),
            "sqexp": lambda: kernels.SquareExponential(input_scale=self.prior_input_scale),
        }[self.prior_kernel]()
        if self.prior_duplicates > 1:
            return kernels.duplicate(base, self.prior_duplicates)
        return base

    def _steprule(self):
        from pnmol_tpu_torch.odetools import step

        if self.steprule == "constant":
            if self.dt is None:
                raise ValueError("Constant steps require dt.")
            return step.Constant(self.dt)
        return step.Adaptive(abstol=self.abstol, reltol=self.reltol)

    def build(self):
        """The solver (it makes no tensor before ``initialize``)."""
        from pnmol_tpu_torch.solvers import latent, white

        cls = {
            ("white", "linear"): white.LinearWhiteNoiseEK1,
            ("white", "semilinear"): white.SemiLinearWhiteNoiseEK1,
            ("latent", "linear"): latent.LinearLatentForceEK1,
            ("latent", "semilinear"): latent.SemiLinearLatentForceEK1,
        }[(self.method, self.linearity)]
        return cls(
            num_derivatives=self.num_derivatives,
            steprule=self._steprule(),
            spatial_kernel=self._kernel(),
            diffuse_prior_scale=self.diffuse_prior_scale,
        )


@dataclasses.dataclass(frozen=True)
class RunConfig:
    problem: ProblemConfig = ProblemConfig()
    solver: SolverConfig = SolverConfig()

    def build(self, *, device):
        """``(pde, solver)``, the problem on ``device``."""
        return self.problem.build(device=device), self.solver.build()
