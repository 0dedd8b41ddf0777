"""The port's semilinear white-noise EK1/EK0 solvers against the JAX package
on spruce budworm (Dirichlet and Neumann), Lotka-Volterra and SIR (Neumann
systems with a ``duplicate`` prior): initialize, one step from the same
state, and whole constant-step solves, through all three factorizations.

The JAX problem's arrays go to the port through ``interop`` together with
the port's own ``f``/``df``, so both packages run the same problem."""

import numpy as np
import pytest
import torch

from pnmol_tpu import kernels as jkernels
from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.solvers import white as jwhite
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.ops import qr_householder as tq

torch.set_num_threads(1)

CPU = "cpu"
DT = 0.05

# name: (JAX problem, the port's undiscretized recipe (for f, df), boundary,
# species)
PROBLEMS = {
    "spruce-dirichlet": (
        lambda: jexamples.spruce_budworm_1d_discretized(dx=0.1, tmax=0.2, bcond="dirichlet"),
        lambda: pt.examples.spruce_budworm_1d(bcond="dirichlet"), "dirichlet", 1),
    "spruce-neumann": (
        lambda: jexamples.spruce_budworm_1d_discretized(dx=0.1, tmax=0.2, bcond="neumann"),
        lambda: pt.examples.spruce_budworm_1d(bcond="neumann"), "neumann", 1),
    "lotka-volterra": (
        lambda: jexamples.lotka_volterra_1d_discretized(dx=0.1, tmax=0.2),
        lambda: pt.examples.lotka_volterra_1d(), "neumann", 2),
    "sir": (lambda: jexamples.sir_1d_discretized(dx=0.25, tmax=0.2),
            lambda: pt.examples.sir_1d(), "neumann", 3),
}
SOLVERS = {
    "ek1": (jwhite.SemiLinearWhiteNoiseEK1, pt.white.SemiLinearWhiteNoiseEK1),
    "ek0": (jwhite.SemiLinearWhiteNoiseEK0, pt.white.SemiLinearWhiteNoiseEK0),
}
FACTORIZATIONS = {
    "qr": lambda: None,
    "householder": lambda: "householder",
    "r-form": tq.make_householder_factorization,
}


def port_problem(jpde, recipe, boundary):
    """The JAX problem's arrays with the port recipe's f and df."""
    return interop.discretized_problem(
        L=np.asarray(jpde.L), E_sqrtm=np.asarray(jpde.E_sqrtm), B=np.asarray(jpde.B),
        R_sqrtm=np.asarray(jpde.R_sqrtm), y0=np.asarray(jpde.y0),
        points=np.asarray(jpde.mesh_spatial.points), t0=jpde.t0, tmax=jpde.tmax,
        device=CPU, boundary=boundary, f=recipe.f, df=recipe.df,
    )


def priors(species):
    jprior = jkernels.Matern52() + jkernels.WhiteNoise()
    prior = pt.kernels.Matern52() + pt.kernels.WhiteNoise()
    if species == 1:
        return jprior, prior
    return jkernels.duplicate(jprior, species), pt.duplicate(prior, species)


def gram(C):
    C = np.asarray(C)
    return C @ C.T


def assert_state_close(mean, cov, jmean, jcov, diff=None, jdiff=None):
    """Means to 1e-9 and covariance Grams to 1e-10 of their largest entry,
    the diffusion to 1e-8 relative. Measured: means <= 4e-14, Grams <= 2e-15,
    diffusions <= 2e-14 relative."""
    jmean = np.asarray(jmean)
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=0, atol=1e-9 * np.abs(jmean).max())
    G = gram(jcov)
    np.testing.assert_allclose(gram(cov), G, rtol=0, atol=1e-10 * np.abs(G).max())
    if diff is not None:
        np.testing.assert_allclose(float(diff), float(jdiff), rtol=1e-8)


@pytest.fixture(scope="module", params=[(p, s) for p in PROBLEMS for s in SOLVERS],
                ids=lambda ps: f"{ps[0]}-{ps[1]}")
def jax_runs(request):
    """JAX's initial state, its first step and its whole solve."""
    name, solver = request.param
    jmake, recipe, boundary, species = PROBLEMS[name]
    jcls, tcls = SOLVERS[solver]
    jpde = jmake()
    jprior, prior = priors(species)
    jsolver = jcls(steprule=jstep.Constant(DT), spatial_kernel=jprior)
    jstate = jsolver.initialize(jpde)
    jstep_out = jsolver._step_fn(jstate.y.mean, jstate.y.cov_sqrtm, DT, np.float64(DT))
    jsol = jcls(steprule=jstep.Constant(DT), spatial_kernel=jprior).solve(jpde)
    return dict(
        pde=port_problem(jpde, recipe(), boundary), tcls=tcls, prior=prior,
        jsolver=jsolver, jstate=jstate, jstep=[np.asarray(x) for x in jstep_out], jsol=jsol,
    )


def make(run, factorization, **kwargs):
    return run["tcls"](steprule=pt.odetools.step.Constant(DT), spatial_kernel=run["prior"],
                       factorization=FACTORIZATIONS[factorization](), **kwargs)


@pytest.mark.parametrize("factorization", sorted(FACTORIZATIONS))
def test_initialize_matches_jax(jax_runs, factorization):
    state = make(jax_runs, factorization).initialize(jax_runs["pde"])
    jstate = jax_runs["jstate"]
    assert_state_close(state.y.mean, state.y.cov_sqrtm, jstate.y.mean, jstate.y.cov_sqrtm)


@pytest.mark.parametrize("factorization", sorted(FACTORIZATIONS))
def test_one_step_from_the_same_state_matches_jax(jax_runs, factorization):
    solver = make(jax_runs, factorization)
    solver.initialize(jax_runs["pde"])  # resolves "householder" for this d
    jcache = jax_runs["jsolver"]._cache
    cache = interop.white_cache(**{k: np.asarray(v) for k, v in jcache._asdict().items()},
                                device=CPU)
    jstate = jax_runs["jstate"]
    state = interop.filter_state(t=0.0, mean=np.asarray(jstate.y.mean),
                                 cov_sqrtm=np.asarray(jstate.y.cov_sqrtm), device=CPU)
    pde = jax_runs["pde"]
    mean, cov, error, ref, diff = pt.white.white_attempt_step(
        cache, state.y.mean, state.y.cov_sqrtm, DT, DT, num_derivatives=2, f=pde.f,
        df=pde.df, linear=False, factorization=solver.factorization,
        ek_order=solver.EK_ORDER,
    )
    jmean, jcov, jerror, jref, jdiff = jax_runs["jstep"]
    assert_state_close(mean, cov, jmean, jcov, diff, jdiff)
    np.testing.assert_allclose(ref.numpy(), jref, rtol=0, atol=1e-9 * np.abs(jref).max())
    np.testing.assert_allclose(error.numpy(), jerror, rtol=1e-8)


@pytest.mark.parametrize("factorization", sorted(FACTORIZATIONS))
def test_solve_matches_jax(jax_runs, factorization):
    sol = make(jax_runs, factorization).solve(jax_runs["pde"])
    jsol = jax_runs["jsol"]
    assert sol.info == jsol.info
    np.testing.assert_allclose(sol.t.numpy(), np.asarray(jsol.t), rtol=0, atol=1e-15)
    assert_state_close(sol.mean, sol.cov_sqrtm[-1], jsol.mean, jsol.cov_sqrtm[-1],
                       sol.diffusion_squared_calibrated, jsol.diffusion_squared_calibrated)


def test_meascov_dt_scaled_matches_jax():
    jmake, recipe, boundary, _ = PROBLEMS["spruce-neumann"]
    jpde = jmake()
    jsol = jwhite.SemiLinearWhiteNoiseEK1(
        steprule=jstep.Constant(DT), meascov_dt_scaled=True).solve(jpde)
    sol = pt.white.SemiLinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(DT), meascov_dt_scaled=True,
    ).solve(port_problem(jpde, recipe(), boundary))
    assert_state_close(sol.mean, sol.cov_sqrtm[-1], jsol.mean, jsol.cov_sqrtm[-1],
                       sol.diffusion_squared_calibrated, jsol.diffusion_squared_calibrated)
    # and it is a different filter from the fixed-E default
    default = pt.white.SemiLinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(DT)).solve(
        port_problem(jpde, recipe(), boundary))
    assert float((default.mean - sol.mean).abs().max()) > 1e-8


def test_ek0_equals_ek1_when_f_is_linear():
    """With a zero nonlinearity the Jacobian is zero, so EK0 and EK1 are the
    same map, bit for bit (mirror of tests/test_solvers/test_ek0.py)."""
    pde = pt.examples.spruce_budworm_1d_discretized(dx=0.2, tmax=1.0, device=CPU)
    solver = pt.white.SemiLinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(DT))
    state = solver.initialize(pde)

    def f0(t, u):
        return torch.zeros_like(u)

    def df0(t, u):
        return torch.zeros((u.shape[0], u.shape[0]), dtype=u.dtype)

    common = dict(num_derivatives=2, f=f0, linear=False)
    out1 = pt.white.white_attempt_step(solver._cache, state.y.mean, state.y.cov_sqrtm, DT, DT,
                                       df=df0, ek_order=1, **common)
    out0 = pt.white.white_attempt_step(solver._cache, state.y.mean, state.y.cov_sqrtm, DT, DT,
                                       df=None, ek_order=0, **common)
    for a, b in zip(out0, out1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ek0_and_ek1_differ_on_a_nonlinear_problem():
    pde = pt.examples.spruce_budworm_1d_discretized(dx=0.2, tmax=0.5, device=CPU)
    u = [cls(steprule=pt.odetools.step.Constant(DT)).solve(pde).mean[-1, 0]
         for cls in (pt.white.SemiLinearWhiteNoiseEK0, pt.white.SemiLinearWhiteNoiseEK1)]
    assert torch.isfinite(u[0]).all()
    np.testing.assert_allclose(u[0].numpy(), u[1].numpy(), rtol=2e-2, atol=1e-4)
    assert float((u[0] - u[1]).abs().max()) > 1e-12
