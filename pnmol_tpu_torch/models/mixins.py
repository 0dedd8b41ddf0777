"""Composable PDE-problem capabilities (counterpart of
:mod:`pnmol_tpu.models.mixins`, the parts the Dirichlet heat problem uses)."""

import torch

from pnmol_tpu_torch import discretize


class DiscretizationMixIn:
    """Probabilistic spatial discretization of scalar PDEs:
    ``scheme="fd"`` (localized probabilistic finite differences) or
    ``scheme="collocation"`` (dense global collocation, with the JAX
    package's nuggets)."""

    def discretize(self, *, mesh_spatial, kernel, stencil_size_interior,
                   stencil_size_boundary, nugget_gram_matrix=0.0, scheme="fd"):
        if not isinstance(self, DirichletMixIn):
            raise NotImplementedError(
                "only Dirichlet boundaries are ported; Neumann boundaries are "
                "ROADMAP queue 1, item 10"
            )
        if scheme == "fd":
            L, E_sqrtm = discretize.fd_probabilistic(
                self.diffop,
                mesh_spatial=mesh_spatial,
                kernel=kernel,
                stencil_size_interior=stencil_size_interior,
                stencil_size_boundary=stencil_size_boundary,
                nugget_gram_matrix=nugget_gram_matrix,
            )
        elif scheme == "collocation":
            L, E_sqrtm = discretize.collocation_global(
                self.diffop,
                mesh_spatial=mesh_spatial,
                kernel=kernel,
                nugget_gram_matrix=max(nugget_gram_matrix, 1e-12),
                nugget_cholesky_E=1e-12,
                symmetrize_cholesky_E=True,
            )
        else:
            raise ValueError(f"Unknown discretization scheme: {scheme!r}")
        self.L = self.diffop_scale * L
        self.E_sqrtm = self.diffop_scale * E_sqrtm
        self.mesh_spatial = mesh_spatial

        self.B = mesh_spatial.boundary_projection_matrix
        b = self.B.shape[0]
        self.R_sqrtm = torch.zeros((b, b), dtype=self.B.dtype, device=self.B.device)

        if isinstance(self, IVPMixIn):
            # scalar initial value: slice the zeroth dimension
            self.y0 = self.y0_fun(mesh_spatial.points)[:, 0]


class IVPMixIn:
    """Evolution-equation structure: time span plus initial-value function."""

    def __init__(self, *, t0, tmax, y0_fun, **kwargs):
        self.t0 = t0
        self.tmax = tmax
        self.y0_fun = y0_fun
        self.y0 = None  # filled by discretize()
        super().__init__(**kwargs)


class DirichletMixIn:
    """Zero-value boundaries: the boundary operator ``B`` selects the
    boundary points, with zero noise ``R_sqrtm``."""

    def __init__(self, **kwargs):
        self.B = None
        self.R_sqrtm = None
        super().__init__(**kwargs)
