"""The 1-D heat equation recipe (counterpart of
:func:`pnmol_tpu.models.examples.heat_1d` and ``heat_1d_discretized``)."""

import functools
import math

import torch

from pnmol_tpu_torch import diffops, kernels, mesh
from pnmol_tpu_torch.models import problems


def gaussian_bell_1d_centered(x, bbox, width=1.0):
    midpoint = 0.5 * (bbox[1] + bbox[0])
    return torch.exp(-((x - midpoint) ** 2) / width**2)


def sin_bell_1d(x):
    return 0.1 * torch.sin(math.pi * x)


def heat_1d(*, bbox=None, t0=0.0, tmax=5.0, y0_fun=None, diffusion_rate=0.05,
            bcond="dirichlet"):
    """1-D heat equation u_t = diffusion_rate * Laplace(u)."""
    if bcond != "dirichlet":
        raise NotImplementedError(
            f"bcond={bcond!r} is not ported yet; Neumann boundaries are "
            "ROADMAP queue 1, item 10"
        )
    if bbox is None:
        bbox = [0.0, 1.0]
    bbox = [float(b) for b in bbox]

    if y0_fun is None:
        bell = functools.partial(gaussian_bell_1d_centered, bbox=bbox)

        def y0_fun(x):
            return bell(x) * sin_bell_1d(x)

    return problems.LinearEvolutionDirichlet(
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
        mesh_spatial=mesh.RectangularMesh.from_bbox_1d(heat.bbox, step=dx, device=device),
        kernel=kernel if kernel is not None else kernels.SquareExponential(),
        stencil_size_interior=stencil_size_interior,
        stencil_size_boundary=stencil_size_boundary,
        nugget_gram_matrix=nugget_gram_matrix_fd,
    )
    return heat
