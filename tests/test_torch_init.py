"""The port's ODE-filter initialization routines against the JAX package's:
TaylorMode (nested jvp) against JAX's ``jet`` at nu = 4 (1e-10 relative),
Stack, the Dormand-Prince data (1e-13) and the RK fit.

The RK fit is ill-conditioned where it starts: Stack's initial factor is
``diag(0, 0, 0, 1e3, 1e3)``, so the first predicted factor's diagonal spans
4e6 to 0.04 at vanderpol(10), nu = 4, and the smoothing gain solves its
Gram (condition ~1e16). The last bits of XLA's and LAPACK's QRs of the same
stack then move that gain by 17 %; the fitted rows 3 and 4 end 2.1e-5 and
4.3e-8 apart, 1 % of the fit's own distance from the exact derivatives
(1.8e-3 and 6.0e-2). The rows Stack fixes agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.odetools import init as jinit
from pnmol_tpu.odetools import ivp as jivp
from pnmol_tpu_torch.odetools import init, ivp

torch.set_num_threads(1)

CPU = "cpu"


def rel_close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def problems(name, **kwargs):
    return getattr(ivp, name)(device=CPU, **kwargs), getattr(jivp, name)(**kwargs)


@pytest.mark.parametrize("name, kwargs", [("vanderpol", dict(stiffness_constant=1.0)),
                                          ("threebody", {})], ids=["vanderpol", "threebody"])
def test_taylor_mode_matches_jet(name, kwargs):
    got_ivp, want_ivp = problems(name, **kwargs)
    got = init.TaylorMode.taylor_mode(fun=got_ivp.f, y0=got_ivp.y0, t0=got_ivp.t0,
                                      num_derivatives=4)
    want = jinit.TaylorMode.taylor_mode(fun=want_ivp.f, y0=want_ivp.y0, t0=want_ivp.t0,
                                        num_derivatives=4)
    assert got.shape == want.shape == (5, got_ivp.dimension)
    for k in range(5):  # each derivative on its own scale
        rel_close(got[k], want[k], 1e-10)


def test_taylor_mode_routine_and_low_orders():
    got_ivp, want_ivp = problems("vanderpol", stiffness_constant=1.0)
    m, sc = init.TaylorMode()(f=got_ivp.f, df=got_ivp.df, y0=got_ivp.y0, t0=0.0,
                              num_derivatives=3)
    assert m.shape == (4, 2) and torch.equal(sc, torch.zeros(4, 4, dtype=torch.float64))
    assert init.TaylorMode.taylor_mode(got_ivp.f, got_ivp.y0, 0.0, 0).shape == (1, 2)
    m1 = init.TaylorMode.taylor_mode(got_ivp.f, got_ivp.y0, 0.0, 1)
    rel_close(m1[1], want_ivp.f(0.0, want_ivp.y0), 1e-15)


@pytest.mark.parametrize("use_df", [True, False])
def test_stack_matches_jax(use_df):
    got_ivp, want_ivp = problems("vanderpol", stiffness_constant=1.0)
    m, sc = init.Stack(use_df=use_df)(f=got_ivp.f, df=got_ivp.df, y0=got_ivp.y0, t0=0.0,
                                      num_derivatives=4)
    jm, jsc = jinit.Stack(use_df=use_df)(f=want_ivp.f, df=want_ivp.df, y0=want_ivp.y0,
                                         t0=0.0, num_derivatives=4)
    rel_close(m, jm, 1e-15)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


def test_rk_data_matches_jax():
    got_ivp, want_ivp = problems("vanderpol", stiffness_constant=10.0)
    ts, ys = init.RungeKutta.rk_data(f=got_ivp.f, t0=0.0, dt=0.01, num_steps=9, y0=got_ivp.y0)
    jts, jys = jinit.RungeKutta.rk_data(f=want_ivp.f, t0=0.0, dt=0.01, num_steps=9,
                                        y0=want_ivp.y0)
    rel_close(ts, jts, 1e-15)
    rel_close(ys, jys, 1e-13)


def test_rk_init_improve_matches_jax():
    """vanderpol(10), nu = 4, 2 nu + 1 data points: the setup of the JAX
    package's RK test. Rows 0-2 to 1e-12; the fitted rows 3-4 to 2 % of the
    fit's distance from TaylorMode's exact derivatives, and the covariance
    Gram to 1e-3 (measured 3.5e-4), for the conditioning of the module
    docstring."""
    got_ivp, want_ivp = problems("vanderpol", stiffness_constant=10.0)
    nu = 4
    jts, jys = jinit.RungeKutta.rk_data(f=want_ivp.f, t0=0.0, dt=0.01, num_steps=2 * nu + 1,
                                        y0=want_ivp.y0)
    jm0, jsc0 = jinit.Stack(use_df=True)(f=want_ivp.f, df=want_ivp.df, y0=want_ivp.y0, t0=0.0,
                                         num_derivatives=nu)
    want_m, want_sc = jinit.RungeKutta.rk_init_improve(
        m=jm0, sc=jsc0, t0=0.0, ts=jts, ys=jys, wp_diffusion_sqrtm=jnp.eye(1))
    m, sc = init.RungeKutta.rk_init_improve(
        m=torch.tensor(np.asarray(jm0)), sc=torch.tensor(np.asarray(jsc0)), t0=0.0,
        ts=torch.tensor(np.asarray(jts)), ys=torch.tensor(np.asarray(jys)),
        wp_diffusion_sqrtm=torch.eye(1, dtype=torch.float64))
    exact = np.asarray(jinit.TaylorMode.taylor_mode(want_ivp.f, want_ivp.y0, 0.0, nu))
    for k in range(3):
        rel_close(m[k], want_m[k], 1e-12)
    for k in range(3, nu + 1):
        fit_error = np.abs(np.asarray(want_m[k]) - exact[k]).max() / np.abs(exact[k]).max()
        assert fit_error < 0.1  # the JAX package's own bound
        rel_close(m[k], want_m[k], 0.02 * fit_error)
    G, jG = sc @ sc.T, np.asarray(want_sc) @ np.asarray(want_sc).T
    rel_close(G, jG, 1e-3)


def test_runge_kutta_routine_matches_jax():
    """vanderpol(1), nu = 3 through ``__call__``: the fitted row 3 agrees to
    1.0e-10 (better conditioned than nu = 4), pinned at 1e-9."""
    got_ivp, want_ivp = problems("vanderpol", stiffness_constant=1.0)
    m, sc = init.RungeKutta(dt=0.01)(f=got_ivp.f, df=got_ivp.df, y0=got_ivp.y0, t0=0.0,
                                     num_derivatives=3,
                                     wp_diffusion_sqrtm=torch.eye(1, dtype=torch.float64))
    jm, jsc = jinit.RungeKutta(dt=0.01)(f=want_ivp.f, df=want_ivp.df, y0=want_ivp.y0, t0=0.0,
                                        num_derivatives=3, wp_diffusion_sqrtm=jnp.eye(1))
    for k in range(3):
        rel_close(m[k], jm[k], 1e-12)
    rel_close(m[3], jm[3], 1e-9)
    assert torch.isfinite(sc).all()
