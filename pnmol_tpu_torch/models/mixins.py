"""Composable PDE-problem capabilities: discretization, IVP structure,
the method-of-lines conversion, boundary conditions, nonlinearities
(counterpart of :mod:`pnmol_tpu.models.mixins`)."""

import functools

import torch
from torch.func import jacfwd

from pnmol_tpu_torch import discretize


def _boundary_operator(pde, mesh_spatial, kernel, stencil_size_boundary,
                       nugget_gram_matrix):
    """``(B, R_sqrtm)`` of one scalar field: the kernel-FD outward normal
    derivative for Neumann boundaries, the boundary rows of the identity
    with zero noise for Dirichlet ones."""
    if isinstance(pde, (NeumannMixIn, SystemNeumannMixIn)):
        if pde.dimension > 1:
            return discretize.fd_probabilistic_neumann(
                mesh_spatial=mesh_spatial, kernel=kernel,
                stencil_size=stencil_size_boundary,
                nugget_gram_matrix=nugget_gram_matrix,
            )
        return discretize.fd_probabilistic_neumann_1d(
            mesh_spatial=mesh_spatial, kernel=kernel, stencil_size=2,
            nugget_gram_matrix=nugget_gram_matrix,
        )
    B = mesh_spatial.boundary_projection_matrix
    return B, B.new_zeros((B.shape[0], B.shape[0]))


class DiscretizationMixIn:
    """Probabilistic spatial discretization of scalar PDEs:
    ``scheme="fd"`` (localized probabilistic finite differences) or
    ``scheme="collocation"`` (dense global collocation, with the JAX
    package's nuggets)."""

    def discretize(self, *, mesh_spatial, kernel, stencil_size_interior,
                   stencil_size_boundary, nugget_gram_matrix=0.0, scheme="fd"):
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

        if isinstance(self, _BoundaryConditionMixInInterface):
            self.B, self.R_sqrtm = _boundary_operator(
                self, mesh_spatial, kernel, stencil_size_boundary, nugget_gram_matrix
            )

        if isinstance(self, IVPMixIn):
            # scalar initial value: slice the zeroth dimension
            self.y0 = self.y0_fun(mesh_spatial.points)[:, 0]


class SystemDiscretizationMixIn:
    """Discretization for systems of PDEs: per-species FD, block-diagonal
    ``L``, ``E_sqrtm``, ``B`` and ``R_sqrtm``."""

    def discretize_system(self, *, mesh_spatial, kernel, stencil_size_interior,
                          stencil_size_boundary, nugget_gram_matrix=0.0):
        fd = functools.partial(
            discretize.fd_probabilistic,
            mesh_spatial=mesh_spatial,
            kernel=kernel,
            stencil_size_interior=stencil_size_interior,
            stencil_size_boundary=stencil_size_boundary,
            nugget_gram_matrix=nugget_gram_matrix,
        )
        blocks = [
            (scale * L, scale * E)
            for scale, (L, E) in zip(self.diffop_scale, map(fd, self.diffop))
        ]
        self.L = torch.block_diag(*[L for L, _ in blocks])
        self.E_sqrtm = torch.block_diag(*[E for _, E in blocks])
        self.mesh_spatial = mesh_spatial

        if isinstance(self, _BoundaryConditionMixInInterface):
            B, R_sqrtm = _boundary_operator(
                self, mesh_spatial, kernel, stencil_size_boundary, nugget_gram_matrix
            )
            n = len(self.diffop)
            self.B = torch.block_diag(*([B] * n))
            self.R_sqrtm = torch.block_diag(*([R_sqrtm] * n))

        if isinstance(self, IVPMixIn):
            self.y0 = self.y0_fun(mesh_spatial.points).squeeze()


class IVPMixIn:
    """Evolution-equation structure: time span plus initial-value function."""

    def __init__(self, *, t0, tmax, y0_fun, **kwargs):
        self.t0 = t0
        self.tmax = tmax
        self.y0_fun = y0_fun
        self.y0 = None  # filled by discretize()
        super().__init__(**kwargs)

    @property
    def t_span(self):
        return self.t0, self.tmax


class _IVPConversionMixInInterface:
    """Interface for method-of-lines conversion mixins."""

    def to_ivp(self):
        raise NotImplementedError

    # Drop-in name compatibility with the reference API.
    def to_tornadox_ivp(self):
        return self.to_ivp()

    def _check_ivp_conversion_conditions(self):
        if not isinstance(self, _BoundaryConditionMixInInterface):
            raise Exception(
                "Conversion to an IVP requires boundary condition functionality."
            )
        if not isinstance(self, IVPMixIn):
            raise Exception("Conversion to an IVP requires IVP functionality.")
        if self.L is None:
            raise AttributeError("Conversion to an IVP requires prior discretization.")
        if self.dimension > 1:
            raise NotImplementedError(
                "IVP conversion beyond one spatial dimension is not supported."
            )

    def _ivp(self, f_new):
        """The IVP of the interior points: ``df`` is ``jacfwd`` of ``f_new``."""
        from pnmol_tpu_torch.odetools import ivp as ivp_module

        return ivp_module.InitialValueProblem(
            f=f_new,
            df=jacfwd(f_new, argnums=1),
            df_diagonal=None,
            y0=self.bc_remove_pad(self.y0),
            t0=self.t0,
            tmax=self.tmax,
        )


class IVPConversionLinearMixIn(_IVPConversionMixInInterface):
    """Method-of-lines conversion for linear PDEs: the boundary rows are
    eliminated through the boundary condition's padding."""

    def to_ivp(self):
        self._check_ivp_conversion_conditions()

        def f_new(_, x):
            return self.bc_remove_pad(self.L @ self.bc_pad(x))

        return self._ivp(f_new)


class IVPConversionSemiLinearMixIn(_IVPConversionMixInInterface):
    """Method-of-lines conversion for semilinear PDEs."""

    def to_ivp(self):
        self._check_ivp_conversion_conditions()

        def f_new(t, x):
            x_padded = self.bc_pad(x)
            return self.bc_remove_pad(self.L @ x_padded + self.f(t, x_padded))

        return self._ivp(f_new)


class _BoundaryConditionMixInInterface:
    def __init__(self, **kwargs):
        self.B = None
        self.R_sqrtm = None
        super().__init__(**kwargs)

    def bc_pad(self, x):
        raise NotImplementedError

    def bc_remove_pad(self, x):
        raise NotImplementedError


class NeumannMixIn(_BoundaryConditionMixInInterface):
    """Zero-flux boundaries: pad with edge values."""

    def bc_pad(self, x):
        return torch.cat((x[:1], x, x[-1:]))

    def bc_remove_pad(self, x):
        return x[1:-1]


class DirichletMixIn(_BoundaryConditionMixInInterface):
    """Zero-value boundaries: pad with zeros."""

    def bc_pad(self, x):
        zero = x.new_zeros((1,))
        return torch.cat((zero, x, zero))

    def bc_remove_pad(self, x):
        return x[1:-1]


class _SystemBoundaryConditionMixinInterface(_BoundaryConditionMixInInterface):
    """Apply a scalar BC rule to each species of a system."""

    def __init__(self, *, bc, **kwargs):
        self.bc = bc
        super().__init__(**kwargs)

    def bc_pad(self, x):
        per_species = x.reshape((len(self.diffop), -1))
        return torch.cat([self.bc.bc_pad(row) for row in per_species])

    def bc_remove_pad(self, x):
        per_species = x.reshape((len(self.diffop), -1))
        return torch.cat([self.bc.bc_remove_pad(row) for row in per_species])


class SystemNeumannMixIn(_SystemBoundaryConditionMixinInterface):
    def __init__(self, **kwargs):
        super().__init__(bc=NeumannMixIn(), **kwargs)


class SystemDirichletMixIn(_SystemBoundaryConditionMixinInterface):
    def __init__(self, **kwargs):
        super().__init__(bc=DirichletMixIn(), **kwargs)


class NonLinearMixIn:
    """Semilinear right-hand side: f, its Jacobian, and optionally its diagonal."""

    def __init__(self, *, f, df, df_diagonal, **kwargs):
        self.f = f
        self.df = df
        self.df_diagonal = df_diagonal
        super().__init__(**kwargs)
