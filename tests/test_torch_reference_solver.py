"""The port's reference integrators against the JAX package's: the adaptive
DP5 takes exactly JAX's number of attempts and lands on its values to
1e-10; LSODA on the host agrees to 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import ivp as jivp
from pnmol_tpu.odetools import reference_solver as jref
import pnmol_tpu_torch as pt
from pnmol_tpu_torch.odetools import ivp, reference_solver

torch.set_num_threads(1)

CPU = "cpu"


def rel_close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


def heat_ivps():
    heat = pt.examples.heat_1d_discretized(dx=0.1, tmax=1.0, device=CPU)
    jheat = jexamples.heat_1d_discretized(dx=0.1, tmax=1.0)
    # the same L on both sides: the conversion is compared in test_torch_ivp
    heat.L = torch.tensor(np.asarray(jheat.L))
    return heat.to_ivp(), jheat.to_ivp()


# (port and JAX IVPs, t_eval, tolerances) of each case
DP5_CASES = {
    "vanderpol": (lambda: (ivp.vanderpol(device=CPU, stiffness_constant=1.0, tmax=5.0),
                           jivp.vanderpol(stiffness_constant=1.0, tmax=5.0)),
                  np.linspace(0.0, 5.0, 11), dict(rtol=1e-10, atol=1e-12)),
    "heat": (heat_ivps, np.array([0.0, 0.37, 1.0]), dict(rtol=1e-10, atol=1e-12)),
    "vanderpol-loose": (lambda: (ivp.vanderpol(device=CPU, tmax=3.0), jivp.vanderpol(tmax=3.0)),
                        np.linspace(0.0, 3.0, 7), dict(rtol=1e-6, atol=1e-8)),
}


@pytest.mark.parametrize("name", sorted(DP5_CASES))
def test_dopri5_matches_jax(name):
    make, t_eval, tols = DP5_CASES[name]
    got_ivp, want_ivp = make()
    got = reference_solver.solve_ivp_dopri5(got_ivp.f, got_ivp.t_span, got_ivp.y0, t_eval,
                                            **tols)
    want = jref.solve_ivp_dopri5(want_ivp.f, want_ivp.t_span, want_ivp.y0,
                                 jnp.asarray(t_eval), **tols)
    assert got.num_steps == int(want.num_steps)
    assert got.y.shape == want.y.shape == (len(t_eval), got_ivp.dimension)
    rel_close(got.y, want.y, 1e-10)
    rel_close(got.t, want.t, 0)


def test_dopri5_leaves_unreached_points_nan():
    """With the step budget spent before tmax the points not reached stay
    NaN, as in the JAX version."""
    problem = ivp.vanderpol(device=CPU, tmax=5.0)
    t_eval = np.array([0.0, 0.001, 4.0])
    got = reference_solver.solve_ivp_dopri5(problem.f, problem.t_span, problem.y0, t_eval,
                                            max_steps=3)
    jproblem = jivp.vanderpol(tmax=5.0)
    want = jref.solve_ivp_dopri5(jproblem.f, jproblem.t_span, jproblem.y0,
                                 jnp.asarray(t_eval), max_steps=3)
    assert got.num_steps == int(want.num_steps) == 3
    np.testing.assert_array_equal(np.isnan(got.y.numpy()), np.isnan(np.asarray(want.y)))
    assert torch.isnan(got.y[2]).all() and not torch.isnan(got.y[:2]).any()
    rel_close(got.y[:2], np.asarray(want.y)[:2], 1e-12)


@pytest.mark.parametrize("with_jac", [True, False], ids=["jac", "no-jac"])
def test_lsoda_matches_jax(with_jac):
    """Lotka-Volterra at dx = 0.2 (d = 8 interior unknowns), with JAX's L."""
    jpde = jexamples.lotka_volterra_1d_discretized(dx=0.2, tmax=1.0)
    pde = pt.examples.lotka_volterra_1d_discretized(dx=0.2, tmax=1.0, device=CPU)
    pde.L = torch.tensor(np.asarray(jpde.L))
    got_ivp, want_ivp = pde.to_ivp(), jpde.to_ivp()
    t_eval = np.array([0.5, 1.0])
    got = reference_solver.solve_ivp_stiff(got_ivp.f, got_ivp.t_span, got_ivp.y0, t_eval,
                                           jac=got_ivp.df if with_jac else None)
    want = jref.solve_ivp_stiff(want_ivp.f, want_ivp.t_span, want_ivp.y0, jnp.asarray(t_eval),
                                jac=want_ivp.df if with_jac else None)
    assert got.y.shape == (2, 8) and got.num_steps > 0
    rel_close(got.y, want.y, 1e-8)
