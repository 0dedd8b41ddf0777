"""PDE base class and the mixin-composed problem classes (counterpart of
:mod:`pnmol_tpu.models.problems`, with the same compositions)."""

import numpy as np

from pnmol_tpu_torch.models import mixins


class PDE:
    """Spatial PDE description plus (optional) discretization products."""

    def __init__(self, *, diffop, diffop_scale, bbox, **kwargs):
        self.diffop = diffop
        self.diffop_scale = diffop_scale
        self.bbox = bbox

        # Filled in by the discretization mixins.
        self.L = None
        self.E_sqrtm = None
        self.mesh_spatial = None
        super().__init__(**kwargs)

    @property
    def is_discretized(self):
        return self.L is not None

    @property
    def dimension(self):
        return np.asarray(self.bbox).ndim


class LinearEvolutionDirichlet(
    mixins.IVPMixIn,
    mixins.IVPConversionLinearMixIn,
    mixins.DiscretizationMixIn,
    mixins.DirichletMixIn,
    PDE,
):
    """Linear, time-dependent evolution equation with Dirichlet boundaries."""


class LinearEvolutionNeumann(
    mixins.IVPMixIn,
    mixins.IVPConversionLinearMixIn,
    mixins.DiscretizationMixIn,
    mixins.NeumannMixIn,
    PDE,
):
    """Linear, time-dependent evolution equation with Neumann boundaries."""


class SystemLinearPDENeumann(mixins.SystemDiscretizationMixIn, mixins.NeumannMixIn, PDE):
    """Systems of linear PDEs with Neumann boundaries (testing)."""


class SystemSemiLinearEvolutionNeumann(
    mixins.IVPMixIn,
    mixins.NonLinearMixIn,
    mixins.IVPConversionSemiLinearMixIn,
    mixins.SystemDiscretizationMixIn,
    mixins.SystemNeumannMixIn,
    PDE,
):
    """Systems of semilinear, time-dependent PDEs with Neumann boundaries."""


class SemiLinearEvolutionNeumann(
    mixins.IVPMixIn,
    mixins.NonLinearMixIn,
    mixins.IVPConversionSemiLinearMixIn,
    mixins.DiscretizationMixIn,
    mixins.NeumannMixIn,
    PDE,
):
    """Semilinear evolution equation with Neumann boundaries."""


class SemiLinearEvolutionDirichlet(
    mixins.IVPMixIn,
    mixins.NonLinearMixIn,
    mixins.IVPConversionSemiLinearMixIn,
    mixins.DiscretizationMixIn,
    mixins.DirichletMixIn,
    PDE,
):
    """Semilinear evolution equation with Dirichlet boundaries."""
