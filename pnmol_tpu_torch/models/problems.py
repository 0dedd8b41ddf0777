"""PDE base class and the mixin-composed problem class of the heat equation
(counterpart of :mod:`pnmol_tpu.models.problems`)."""

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


class LinearEvolutionDirichlet(
    mixins.IVPMixIn,
    mixins.DiscretizationMixIn,
    mixins.DirichletMixIn,
    PDE,
):
    """Linear, time-dependent evolution equation with Dirichlet boundaries."""
