"""The port's n-D problem recipes against the JAX package: heat 2-D
(Dirichlet and Neumann), advection-diffusion in 2-D and 3-D, and Fisher-KPP
2-D (Dirichlet and Neumann), at the JAX tests' sizes and the JAX defaults.

``L`` is held to 1e-7 of its largest entry: at the JAX defaults
(``SquareExponential()``, 9- and 11-point interior stencils) the stencil
Grams are near-singular, and LAPACK's and XLA's Cholesky solves part in
their last bits (measured 7.9e-9 on the 8 x 8 heat, 7.2e-9 on the 10 x 10
advection, 1.0e-10 on 6^3, 2.3e-10 on Fisher-KPP). ``E_sqrtm``, ``B`` and
``R_sqrtm`` are held to 1e-11 of their largest entry (measured 3.9e-12 at
most), ``y0`` to 1e-15."""

import functools

import numpy as np
import pytest
import torch

from pnmol_tpu.models import examples as jexamples
import pnmol_tpu_torch as pt

torch.set_num_threads(1)

CPU = "cpu"
TOLERANCES = {"L": 1e-7, "E_sqrtm": 1e-11, "B": 1e-11, "R_sqrtm": 1e-11, "y0": 1e-15}
FKPP = dict(diffusion_rate=0.01, growth_rate=3.0)

# name: (recipe name, keyword arguments, boundary, number of grid points)
PROBLEMS = {
    "heat-2d-dirichlet": ("heat_2d_discretized", dict(num_points=(8, 8), tmax=0.4),
                          "dirichlet", 64),
    "heat-2d-neumann": ("heat_2d_discretized",
                        dict(num_points=(8, 8), tmax=0.4, bcond="neumann"), "neumann", 64),
    "advection-2d": ("advection_diffusion_discretized",
                     dict(dim=2, num_points=(10, 10), tmax=0.1, velocity=[1.0, 0.0],
                          diffusion_rate=0.02), "dirichlet", 100),
    "advection-3d": ("advection_diffusion_discretized",
                     dict(dim=3, num_points=(6, 6, 6), tmax=0.05, velocity=[1.0, 0.5, 0.0],
                          diffusion_rate=0.05), "dirichlet", 216),
    "fisher-kpp-dirichlet": ("fisher_kpp_2d_discretized",
                             dict(num_points=(8, 8), tmax=0.5, **FKPP), "dirichlet", 64),
    "fisher-kpp-neumann": ("fisher_kpp_2d_discretized",
                           dict(num_points=(6, 6), tmax=0.2, bcond="neumann"), "neumann", 36),
}


@functools.lru_cache(maxsize=None)
def built(name):
    """(JAX problem, port problem), discretized once per test process."""
    recipe, kwargs, _, _ = PROBLEMS[name]
    return (getattr(jexamples, recipe)(**kwargs),
            getattr(pt.examples, recipe)(device=CPU, **kwargs))


@pytest.mark.parametrize("attr", sorted(TOLERANCES))
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_discretization_products_match_jax(name, attr):
    jpde, tpde = built(name)
    want, got = np.asarray(getattr(jpde, attr)), getattr(tpde, attr)
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOLERANCES[attr] * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_shapes_dimension_and_boundary_operator(name):
    jpde, tpde = built(name)
    _, kwargs, boundary, N = PROBLEMS[name]
    mesh = tpde.mesh_spatial
    b = int(mesh.boundary[1].sum())
    assert tpde.dimension == jpde.dimension == 2
    assert mesh.dimension == kwargs.get("dim", 2) and len(mesh) == N
    assert tpde.L.shape == tpde.E_sqrtm.shape == (N, N) and tpde.y0.shape == (N,)
    assert tpde.B.shape == (b, N) and tpde.R_sqrtm.shape == (b, b)
    assert not torch.isnan(tpde.L).any()
    if boundary == "dirichlet":
        # the boundary rows of the identity, with no noise
        np.testing.assert_array_equal(tpde.B.numpy(), np.eye(N)[mesh.boundary[2].numpy()])
        np.testing.assert_array_equal(tpde.R_sqrtm.numpy(), 0.0)
    else:
        # the n-D Neumann operator: each row a stencil along the outward normal
        assert (tpde.B.numpy() != 0).sum(axis=1).max() == 5
        assert float(torch.diag(tpde.R_sqrtm).min()) > 0.0
    with pytest.raises(NotImplementedError, match="one spatial dimension"):
        tpde.to_ivp()


@pytest.mark.parametrize("name", ["fisher-kpp-dirichlet", "fisher-kpp-neumann"])
def test_fisher_kpp_nonlinearity_matches_jax(name):
    jpde, tpde = built(name)
    u = np.random.default_rng(0).uniform(-0.5, 1.5, size=tpde.y0.shape[0])
    np.testing.assert_allclose(tpde.f(0.0, torch.tensor(u)).numpy(),
                               np.asarray(jpde.f(0.0, u)), rtol=1e-15, atol=0)
    np.testing.assert_allclose(tpde.df(0.0, torch.tensor(u)).numpy(),
                               np.asarray(jpde.df(0.0, u)), rtol=1e-15, atol=0)
    z = torch.zeros_like(tpde.y0)
    assert float(tpde.f(0.0, z).abs().max()) == 0.0
    growth = PROBLEMS[name][1].get("growth_rate", 1.0)
    assert float(tpde.f(0.0, z + 0.5)[0]) == growth / 4


def test_heat_2d_laplacian_quality():
    """L applied to the sin x sin bump approximates -2 pi^2 times it inside."""
    _, heat = built("heat-2d-dirichlet")
    pts = heat.mesh_spatial.points
    bump = torch.sin(np.pi * pts[:, 0]) * torch.sin(np.pi * pts[:, 1])
    lap = (heat.L / heat.diffop_scale) @ bump
    truth = -2.0 * np.pi**2 * bump
    inside = heat.mesh_spatial.interior[1]
    rel = (lap - truth).abs()[inside] / truth.abs()[inside]
    assert float(rel.median()) < 0.2


@pytest.mark.parametrize("recipe", ["heat_2d", "fisher_kpp_2d"])
def test_unknown_boundary_condition_raises(recipe):
    with pytest.raises(ValueError, match="boundary condition"):
        getattr(pt.examples, recipe)(bcond="periodic")


@pytest.mark.parametrize("recipe", ["heat_2d_discretized", "advection_diffusion_discretized",
                                    "fisher_kpp_2d_discretized"])
def test_recipes_require_a_device(recipe):
    with pytest.raises(TypeError, match="device"):
        getattr(pt.examples, recipe)(num_points=(4, 4))
