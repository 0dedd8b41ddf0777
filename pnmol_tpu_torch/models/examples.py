"""Example PDE recipes: heat (1-D and 2-D), advection-diffusion (any
dimension), SIR, Lotka-Volterra, spruce budworm and Fisher-KPP 2-D
(counterpart of :mod:`pnmol_tpu.models.examples`, with the same default
hyperparameters).

Each ``*_discretized`` recipe takes ``device=``. The n-D recipes keep their
bounding box as a nested list (dim, 2), so ``PDE.dimension`` is 2 and
Neumann boundaries take the n-D operator
(``discretize.fd_probabilistic_neumann``). The semilinear right-hand sides
``f(t, x)`` are closed forms in torch and their Jacobians ``df`` are
``torch.func.jacfwd`` of them, as the JAX package takes ``jax.jacfwd``.
"""

import functools
import math

import torch
from torch.func import jacfwd

from pnmol_tpu_torch import diffops, kernels, mesh
from pnmol_tpu_torch.models import problems


def gaussian_bell_1d_centered(x, bbox, width=1.0):
    midpoint = 0.5 * (bbox[1] + bbox[0])
    return torch.exp(-((x - midpoint) ** 2) / width**2)


def gaussian_bell_1d(x):
    return torch.exp(-(x**2))


def sin_bell_1d(x):
    return 0.1 * torch.sin(math.pi * x)


def _bbox_1d(bbox):
    return [0.0, 1.0] if bbox is None else [float(b) for b in bbox]


def _choose(classes, bcond):
    cls = classes.get(bcond)
    if cls is None:
        raise ValueError(f"Unknown boundary condition: {bcond!r}")
    return cls


def _mesh_1d(bbox, dx, device):
    return mesh.RectangularMesh.from_bbox_1d(bbox, step=dx, device=device)


# ---------------------------------------------------------------------------
# Heat equation (linear)
# ---------------------------------------------------------------------------


def heat_1d(*, bbox=None, t0=0.0, tmax=5.0, y0_fun=None, diffusion_rate=0.05,
            bcond="dirichlet"):
    """1-D heat equation u_t = diffusion_rate * Laplace(u)."""
    bbox = _bbox_1d(bbox)
    if y0_fun is None:
        bell = functools.partial(gaussian_bell_1d_centered, bbox=bbox)

        def y0_fun(x):
            return bell(x) * sin_bell_1d(x)

    cls = _choose({"dirichlet": problems.LinearEvolutionDirichlet,
                   "neumann": problems.LinearEvolutionNeumann}, bcond)
    return cls(
        diffop=diffops.laplace(),
        diffop_scale=diffusion_rate,
        bbox=bbox,
        t0=t0,
        tmax=tmax,
        y0_fun=y0_fun,
    )


def heat_1d_discretized(*, device, bbox=None, dx=0.05, stencil_size_interior=3,
                        stencil_size_boundary=3, t0=0.0, tmax=5.0, y0_fun=None,
                        diffusion_rate=0.05, nugget_gram_matrix_fd=0.0,
                        kernel=None, bcond="dirichlet"):
    """The heat equation discretized on a uniform 1-D mesh on ``device``."""
    heat = heat_1d(
        bbox=bbox, t0=t0, tmax=tmax, y0_fun=y0_fun,
        diffusion_rate=diffusion_rate, bcond=bcond,
    )
    heat.discretize(
        mesh_spatial=_mesh_1d(heat.bbox, dx, device),
        kernel=kernel if kernel is not None else kernels.SquareExponential(),
        stencil_size_interior=stencil_size_interior,
        stencil_size_boundary=stencil_size_boundary,
        nugget_gram_matrix=nugget_gram_matrix_fd,
    )
    return heat


def _bbox_nd(bbox, dim=2):
    """The (dim, 2) box as a nested list; the unit box by default."""
    if bbox is None:
        return [[0.0, 1.0]] * dim
    return [[float(lo), float(hi)] for lo, hi in bbox]


def _sin_bump_nd(x):
    """prod_i sin(pi x_i), as a column (N, 1)."""
    return torch.prod(torch.sin(math.pi * x), dim=-1)[..., None]


def heat_2d(*, bbox=None, t0=0.0, tmax=5.0, y0_fun=None, diffusion_rate=0.05,
            bcond="dirichlet"):
    """2-D heat equation with Dirichlet or Neumann boundaries."""
    cls = _choose({"dirichlet": problems.LinearEvolutionDirichlet,
                   "neumann": problems.LinearEvolutionNeumann}, bcond)
    return cls(
        diffop=diffops.laplace(),
        diffop_scale=diffusion_rate,
        bbox=_bbox_nd(bbox),
        t0=t0,
        tmax=tmax,
        y0_fun=y0_fun if y0_fun is not None else _sin_bump_nd,
    )


def heat_2d_discretized(*, device, bbox=None, num_points=(12, 12), stencil_size_interior=9,
                        stencil_size_boundary=5, t0=0.0, tmax=5.0, y0_fun=None,
                        diffusion_rate=0.05, nugget_gram_matrix_fd=1e-12, kernel=None,
                        bcond="dirichlet"):
    """The 2-D heat equation on a ``num_points`` tensor grid on ``device``."""
    heat = heat_2d(bbox=bbox, t0=t0, tmax=tmax, y0_fun=y0_fun,
                   diffusion_rate=diffusion_rate, bcond=bcond)
    heat.discretize(
        mesh_spatial=mesh.RectangularMesh.from_bbox_2d(heat.bbox, nums=num_points,
                                                       device=device),
        kernel=kernel if kernel is not None else kernels.SquareExponential(),
        stencil_size_interior=stencil_size_interior,
        stencil_size_boundary=stencil_size_boundary,
        nugget_gram_matrix=nugget_gram_matrix_fd,
    )
    return heat


# ---------------------------------------------------------------------------
# Advection-diffusion (linear, any dimension)
# ---------------------------------------------------------------------------


def advection_diffusion(*, dim=2, bbox=None, t0=0.0, tmax=1.0, y0_fun=None,
                        diffusion_rate=0.05, velocity=None):
    """Linear advection-diffusion ``u_t = kappa lap(u) - v . grad(u)`` with
    Dirichlet boundaries, from the diffop algebra."""
    if velocity is None:
        velocity = [1.0] * dim
    diffop = diffops.scalar_mult(diffusion_rate).compose_with(
        diffops.laplace()
    ) - diffops.directional_derivative(velocity)
    return problems.LinearEvolutionDirichlet(
        diffop=diffop,
        diffop_scale=1.0,
        bbox=_bbox_nd(bbox, dim),
        t0=t0,
        tmax=tmax,
        y0_fun=y0_fun if y0_fun is not None else _sin_bump_nd,
    )


def advection_diffusion_discretized(*, device, dim=2, bbox=None, num_points=None,
                                    stencil_size_interior=None, stencil_size_boundary=None,
                                    t0=0.0, tmax=1.0, y0_fun=None, diffusion_rate=0.05,
                                    velocity=None, nugget_gram_matrix_fd=1e-12, kernel=None):
    """Advection-diffusion in ``dim`` dimensions on a tensor grid on
    ``device``; the stencil sizes default to the tensor grid's neighbour
    shells."""
    if num_points is None:
        num_points = (12,) * dim
    if stencil_size_interior is None:
        stencil_size_interior = {1: 3, 2: 9, 3: 11}.get(dim, 2 * dim + 1)
    if stencil_size_boundary is None:
        stencil_size_boundary = {1: 3, 2: 5, 3: 7}.get(dim, dim + 2)
    pde = advection_diffusion(dim=dim, bbox=bbox, t0=t0, tmax=tmax, y0_fun=y0_fun,
                              diffusion_rate=diffusion_rate, velocity=velocity)
    pde.discretize(
        mesh_spatial=mesh.RectangularMesh.from_bbox_nd(pde.bbox, nums=num_points,
                                                       device=device),
        kernel=kernel if kernel is not None else kernels.SquareExponential(),
        stencil_size_interior=stencil_size_interior,
        stencil_size_boundary=stencil_size_boundary,
        nugget_gram_matrix=nugget_gram_matrix_fd,
    )
    return pde


# ---------------------------------------------------------------------------
# SIR reaction-diffusion system (3 species, semilinear)
# ---------------------------------------------------------------------------


def sir_1d(*, bbox=None, t0=0.0, tmax=50.0, diffusion_rate_S=0.1,
           diffusion_rate_I=0.1, diffusion_rate_R=0.1, beta=0.3, gamma=0.07,
           N=1000.0):
    """Spatial SIR model: diffusing susceptible/infectious/recovered."""
    bbox = _bbox_1d(bbox)

    def y0_fun(x):
        infectious0 = 200.0 * gaussian_bell_1d_centered(x, bbox, width=0.5) + 1.0
        s0 = N * torch.ones_like(infectious0) - infectious0
        return torch.cat((s0, infectious0, torch.zeros_like(infectious0)))

    def f(t, x):
        s, i, r = torch.chunk(x, 3)
        total = s + i + r
        infections = beta * s * i / total
        recoveries = gamma * i
        return torch.cat((-infections, infections - recoveries, recoveries))

    lap = diffops.laplace()
    return problems.SystemSemiLinearEvolutionNeumann(
        diffop=(lap, lap, lap),
        diffop_scale=(diffusion_rate_S, diffusion_rate_I, diffusion_rate_R),
        bbox=bbox,
        t0=t0,
        tmax=tmax,
        y0_fun=y0_fun,
        f=f,
        df=jacfwd(f, argnums=1),
        df_diagonal=None,
    )


def sir_1d_discretized(*, device, bbox=None, dx=0.05, t0=0.0, tmax=50.0, beta=0.3,
                       gamma=0.07, N=1000.0, diffusion_rate_S=0.1,
                       diffusion_rate_I=0.1, diffusion_rate_R=0.1, kernel=None,
                       nugget_gram_matrix_fd=0.0, stencil_size_interior=3,
                       stencil_size_boundary=3):
    sir = sir_1d(
        bbox=bbox, t0=t0, tmax=tmax, diffusion_rate_S=diffusion_rate_S,
        diffusion_rate_I=diffusion_rate_I, diffusion_rate_R=diffusion_rate_R,
        beta=beta, gamma=gamma, N=N,
    )
    sir.discretize_system(
        mesh_spatial=_mesh_1d(sir.bbox, dx, device),
        kernel=kernel if kernel is not None else kernels.SquareExponential(),
        stencil_size_interior=stencil_size_interior,
        stencil_size_boundary=stencil_size_boundary,
        nugget_gram_matrix=nugget_gram_matrix_fd,
    )
    return sir


# ---------------------------------------------------------------------------
# Lotka-Volterra reaction-diffusion system (2 species, semilinear)
# ---------------------------------------------------------------------------


def lotka_volterra_1d(*, bbox=None, t0=0.0, tmax=10.0, a=0.5, b=0.05, c=0.05,
                      d=0.5, diffusion_scale_u=0.1, diffusion_scale_v=0.1):
    """Spatial predator-prey dynamics with diffusion."""
    bbox = _bbox_1d(bbox)

    def y0_fun(x):
        prey0 = 5.0 * torch.ones_like(x)
        predator0 = 20.0 * gaussian_bell_1d(x)
        return torch.cat((prey0, predator0))

    def f(_, x):
        u, v = torch.chunk(x, 2)
        return torch.cat((a * u - b * u * v, c * u * v - d * v))

    lap = diffops.laplace()
    return problems.SystemSemiLinearEvolutionNeumann(
        diffop=(lap, lap),
        diffop_scale=(diffusion_scale_u, diffusion_scale_v),
        bbox=bbox,
        t0=t0,
        tmax=tmax,
        y0_fun=y0_fun,
        f=f,
        df=jacfwd(f, argnums=1),
        df_diagonal=None,
    )


def lotka_volterra_1d_discretized(*, device, dx=0.05, kernel=None,
                                  nugget_gram_matrix_fd=0.0,
                                  stencil_size_interior=3,
                                  stencil_size_boundary=3, **kwargs):
    pde = lotka_volterra_1d(**kwargs)
    pde.discretize_system(
        mesh_spatial=_mesh_1d(pde.bbox, dx, device),
        kernel=kernel if kernel is not None else kernels.SquareExponential(),
        stencil_size_interior=stencil_size_interior,
        stencil_size_boundary=stencil_size_boundary,
        nugget_gram_matrix=nugget_gram_matrix_fd,
    )
    return pde


# ---------------------------------------------------------------------------
# Spruce budworm / Fisher-KPP (scalar, semilinear)
# ---------------------------------------------------------------------------


def spruce_budworm_1d(*, bbox=None, t0=0.0, tmax=10.0, diffusion_rate=0.1,
                      y0_fun=None, bcond="dirichlet", growth_rate=1.0):
    """Fisher-KPP logistic reaction-diffusion equation."""
    bbox = _bbox_1d(bbox)
    if y0_fun is None:
        y0_fun = sin_bell_1d

    def f(_, x):
        return growth_rate * x * (1.0 - x)

    cls = _choose({"dirichlet": problems.SemiLinearEvolutionDirichlet,
                   "neumann": problems.SemiLinearEvolutionNeumann}, bcond)
    return cls(
        t0=t0,
        tmax=tmax,
        y0_fun=y0_fun,
        bbox=bbox,
        diffop=diffops.laplace(),
        diffop_scale=diffusion_rate,
        f=f,
        df=jacfwd(f, argnums=1),
        df_diagonal=None,
    )


def spruce_budworm_1d_discretized(*, device, bbox=None, t0=0.0, tmax=10.0,
                                  diffusion_rate=1.0, y0_fun=None, dx=0.1,
                                  kernel=None, nugget_gram_matrix_fd=0.0,
                                  stencil_size_interior=3, stencil_size_boundary=3,
                                  bcond="dirichlet", growth_rate=1.0):
    spruce = spruce_budworm_1d(
        bbox=bbox, t0=t0, tmax=tmax, diffusion_rate=diffusion_rate,
        y0_fun=y0_fun, bcond=bcond, growth_rate=growth_rate,
    )
    spruce.discretize(
        mesh_spatial=_mesh_1d(spruce.bbox, dx, device),
        kernel=kernel if kernel is not None else kernels.SquareExponential(),
        stencil_size_interior=stencil_size_interior,
        stencil_size_boundary=stencil_size_boundary,
        nugget_gram_matrix=nugget_gram_matrix_fd,
    )
    return spruce


def fisher_kpp_2d(*, bbox=None, t0=0.0, tmax=5.0, y0_fun=None, diffusion_rate=0.05,
                  growth_rate=1.0, bcond="dirichlet"):
    """2-D Fisher-KPP: the logistic growth of :func:`spruce_budworm_1d` with
    2-D diffusion."""
    if y0_fun is None:

        def y0_fun(x):
            return 0.5 * _sin_bump_nd(x)

    def f(_, x):
        return growth_rate * x * (1.0 - x)

    cls = _choose({"dirichlet": problems.SemiLinearEvolutionDirichlet,
                   "neumann": problems.SemiLinearEvolutionNeumann}, bcond)
    return cls(
        t0=t0,
        tmax=tmax,
        y0_fun=y0_fun,
        bbox=_bbox_nd(bbox),
        diffop=diffops.laplace(),
        diffop_scale=diffusion_rate,
        f=f,
        df=jacfwd(f, argnums=1),
        df_diagonal=None,
    )


def fisher_kpp_2d_discretized(*, device, bbox=None, num_points=(12, 12),
                              stencil_size_interior=9, stencil_size_boundary=5, t0=0.0,
                              tmax=5.0, y0_fun=None, diffusion_rate=0.05, growth_rate=1.0,
                              nugget_gram_matrix_fd=1e-12, kernel=None, bcond="dirichlet"):
    pde = fisher_kpp_2d(bbox=bbox, t0=t0, tmax=tmax, y0_fun=y0_fun,
                        diffusion_rate=diffusion_rate, growth_rate=growth_rate, bcond=bcond)
    pde.discretize(
        mesh_spatial=mesh.RectangularMesh.from_bbox_2d(pde.bbox, nums=num_points,
                                                       device=device),
        kernel=kernel if kernel is not None else kernels.SquareExponential(),
        stencil_size_interior=stencil_size_interior,
        stencil_size_boundary=stencil_size_boundary,
        nugget_gram_matrix=nugget_gram_matrix_fd,
    )
    return pde
