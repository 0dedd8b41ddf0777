"""The port's method-of-lines conversion and ODE test problems against the
JAX package's: ``f`` and ``df`` at ``y0`` and at a seeded point, for
problems the port's example constructors build with JAX's arguments. From
the port's own discretization they agree to the FD weights' 1e-11 relative
(tests/test_torch_problems.py: the stencil solves of two linear-algebra
libraries); with JAX's ``L`` and ``y0`` handed to the port's problem, the
conversion itself is held to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import ivp as jivp
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.odetools import ivp

torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-12
FD_RTOL = 1e-11
PROBLEMS = {
    "heat-dirichlet": ("heat_1d_discretized", dict(dx=0.1, tmax=1.0)),
    "heat-neumann": ("heat_1d_discretized", dict(dx=0.1, tmax=1.0, bcond="neumann")),
    "spruce-budworm": ("spruce_budworm_1d_discretized", dict(dx=0.1)),
    "lotka-volterra": ("lotka_volterra_1d_discretized", dict(dx=0.2, tmax=1.0)),
}


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def check_ivp(got, want, seed, tol=TOL):
    """y0, the span, and f and df at y0 and at a seeded point."""
    assert (got.t0, got.tmax) == (want.t0, want.tmax)
    close(got.y0, want.y0)
    x = np.random.default_rng(seed).standard_normal(want.y0.shape) + np.asarray(want.y0)
    for point in (np.asarray(want.y0), x):
        t = torch.tensor(point)
        close(got.f(0.3, t), want.f(0.3, jnp.asarray(point)), tol)
        close(got.df(0.3, t), want.df(0.3, jnp.asarray(point)), tol)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_to_ivp_matches_jax(name):
    factory, kwargs = PROBLEMS[name]
    jpde = getattr(jexamples, factory)(**kwargs)
    want = jpde.to_ivp()
    pde = getattr(pt.examples, factory)(**kwargs, device=CPU)
    got = pde.to_ivp()
    assert isinstance(got, ivp.InitialValueProblem) and got.df_diagonal is None
    assert got.dimension == want.dimension == pde.L.shape[0] - pde.B.shape[0]
    check_ivp(got, want, len(name), FD_RTOL)
    pde.L, pde.y0 = torch.tensor(np.asarray(jpde.L)), torch.tensor(np.asarray(jpde.y0))
    check_ivp(pde.to_ivp(), want, len(name))
    check_ivp(pde.to_tornadox_ivp(), want, len(name))


def test_problem_handed_over_from_jax_converts():
    """interop.discretized_problem builds the composed classes, so a problem
    made from JAX's arrays converts too (scalar Dirichlet)."""
    jpde = jexamples.heat_1d_discretized(dx=0.1, tmax=1.0)
    pde = interop.discretized_problem(
        L=np.asarray(jpde.L), E_sqrtm=np.asarray(jpde.E_sqrtm), B=np.asarray(jpde.B),
        R_sqrtm=np.asarray(jpde.R_sqrtm), y0=np.asarray(jpde.y0),
        points=np.asarray(jpde.mesh_spatial.points), t0=jpde.t0, tmax=jpde.tmax, device=CPU,
    )
    check_ivp(pde.to_ivp(), jpde.to_ivp(), 1)


def test_conversion_needs_a_discretized_problem():
    heat = pt.examples.heat_1d()
    with pytest.raises(AttributeError, match="prior discretization"):
        heat.to_ivp()


@pytest.mark.parametrize("name", ["threebody", "vanderpol"])
def test_ode_problems_match_jax(name):
    got = getattr(ivp, name)(device=CPU)
    want = getattr(jivp, name)()
    assert got.dimension == want.dimension and got.t_span == want.t_span
    check_ivp(got, want, 7)


def test_vanderpol_takes_its_arguments():
    got = ivp.vanderpol(device=CPU, t0=0.5, tmax=2.0, y0=[1.0, 3.0], stiffness_constant=1.0)
    want = jivp.vanderpol(t0=0.5, tmax=2.0, y0=jnp.asarray([1.0, 3.0]), stiffness_constant=1.0)
    check_ivp(got, want, 8)
