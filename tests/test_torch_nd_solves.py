"""Whole n-D solves of the port against the JAX package: the solves of
tests/test_heat2d.py, tests/test_advection_3d.py, tests/test_fisher_kpp_2d.py
and tests/test_neumann_nd.py.

Each JAX problem's arrays go to the port through
``interop.discretized_problem``, so both solvers see the same ``L``, and the
port solves it on its plain path (``torch.linalg.qr``), on the Householder
LQ hook's block route and leaf route (the plain panel and leaf versions
that CPU tensors take, at small ``leaf``/``block``) and on the R-form hook.
Final means and covariance Grams are held to JAX's to 1e-10 of their
largest entry (measured: means 4.8e-14 and Grams 2.7e-15 at most). Solves
through the port's own discretization are held to what the ``L`` gap of
their stencil Grams allows (tests/test_torch_nd_problems.py), with the
values measured beside each."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu import diffops as jdiffops
from pnmol_tpu import kernels as jkernels
from pnmol_tpu import mesh as jmesh
from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.models import problems as jproblems
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.solvers import white as jwhite
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.ops import qr_householder as tq

torch.set_num_threads(1)

CPU = "cpu"
SAME_L = 1e-10
FKPP = dict(diffusion_rate=0.01, growth_rate=3.0)

# name: (recipe, keyword arguments, boundary, dt, semilinear, final state only)
PROBLEMS = {
    "heat-2d": ("heat_2d_discretized", dict(num_points=(8, 8), tmax=0.4), "dirichlet", 0.1,
                False, False),
    "advection-2d": ("advection_diffusion_discretized",
                     dict(dim=2, num_points=(10, 10), tmax=0.1, velocity=[1.0, 0.0],
                          diffusion_rate=0.02), "dirichlet", 0.01, False, False),
    "advection-3d": ("advection_diffusion_discretized",
                     dict(dim=3, num_points=(6, 6, 6), tmax=0.05, velocity=[1.0, 0.5, 0.0],
                          diffusion_rate=0.05), "dirichlet", 0.01, False, True),
    "fisher-kpp-dirichlet": ("fisher_kpp_2d_discretized",
                             dict(num_points=(8, 8), tmax=0.5, **FKPP), "dirichlet", 0.05,
                             True, False),
    "fisher-kpp-neumann": ("fisher_kpp_2d_discretized",
                           dict(num_points=(6, 6), tmax=0.2, bcond="neumann"), "neumann", 0.05,
                           True, False),
}
FACTORIZATIONS = ("qr", "householder-block", "householder-leaf", "r-form")


def jprior():
    return jkernels.Matern52() + jkernels.WhiteNoise()


def prior():
    return pt.kernels.Matern52() + pt.kernels.WhiteNoise()


def classes(semilinear):
    if semilinear:
        return jwhite.SemiLinearWhiteNoiseEK1, pt.white.SemiLinearWhiteNoiseEK1
    return jwhite.LinearWhiteNoiseEK1, pt.white.LinearWhiteNoiseEK1


def final_state(solver, pde, final_only):
    """(mean (nu + 1, d), covariance Gram) at tmax, from ``solve`` or
    ``simulate_final_state``."""
    if final_only:
        final, _ = solver.simulate_final_state(pde)
        assert float(final.t) == pytest.approx(pde.tmax)
        mean, cov = final.y.mean, final.y.cov_sqrtm
    else:
        sol = solver.solve(pde)
        mean, cov = sol.mean[-1], sol.cov_sqrtm[-1]
    mean, cov = np.asarray(mean), np.asarray(cov)
    return mean, cov @ cov.T


def assert_rel(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def jax_solve(name):
    """JAX's problem and final state, once per test process."""
    recipe, kwargs, _, dt, semilinear, final_only = PROBLEMS[name]
    jpde = getattr(jexamples, recipe)(**kwargs)
    jcls, _ = classes(semilinear)
    return jpde, final_state(jcls(steprule=jstep.Constant(dt), spatial_kernel=jprior()), jpde,
                             final_only)


def port_solver(name, factorization, monkeypatch):
    _, _, _, dt, semilinear, _ = PROBLEMS[name]
    hook = {
        "qr": None,
        "householder-block": tq.make_householder_lq_factorization(leaf=8, block=16),
        "householder-leaf": tq.make_householder_lq_factorization(leaf=8, block=16),
        "r-form": tq.make_householder_factorization(leaf=8, block=16),
    }[factorization]
    if factorization == "householder-leaf":
        # every 16-row block takes the leaf route of the large meshes
        monkeypatch.setattr(tq, "panel_takes_rows", lambda rows, itemsize: False)
    _, tcls = classes(semilinear)
    return tcls(steprule=pt.odetools.step.Constant(dt), spatial_kernel=prior(),
                factorization=hook)


@pytest.mark.parametrize("factorization", FACTORIZATIONS)
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_solve_on_jax_arrays_matches_jax(name, factorization, monkeypatch):
    recipe, kwargs, boundary, _, semilinear, final_only = PROBLEMS[name]
    jpde, (jmean, jgram) = jax_solve(name)
    extra = {}
    if semilinear:
        rhs = getattr(pt.examples, recipe.removesuffix("_discretized"))(**{
            k: v for k, v in kwargs.items() if k != "num_points"})
        extra = dict(f=rhs.f, df=rhs.df)
    pde = interop.discretized_problem(
        L=np.asarray(jpde.L), E_sqrtm=np.asarray(jpde.E_sqrtm), B=np.asarray(jpde.B),
        R_sqrtm=np.asarray(jpde.R_sqrtm), y0=np.asarray(jpde.y0),
        points=np.asarray(jpde.mesh_spatial.points), t0=jpde.t0, tmax=jpde.tmax, device=CPU,
        boundary=boundary, **extra)
    assert pde.dimension == 2
    mean, gram = final_state(port_solver(name, factorization, monkeypatch), pde, final_only)
    assert np.isfinite(mean).all() and np.isfinite(gram).all()
    assert_rel(mean, jmean, SAME_L)
    assert_rel(gram, jgram, SAME_L)


def test_heat_2d_decays_and_advection_transports():
    """The JAX tests' own statements on the port's solves."""
    heat = pt.examples.heat_2d_discretized(num_points=(8, 8), tmax=0.4, device=CPU)
    sol = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.1),
                                       spatial_kernel=prior()).solve(heat)
    assert not torch.isnan(sol.mean).any() and not torch.isnan(sol.cov_sqrtm).any()
    assert float(sol.mean[-1, 0].max()) < float(sol.mean[0, 0].max())

    _, kwargs, _, dt, _, _ = PROBLEMS["advection-2d"]
    adv = pt.examples.advection_diffusion_discretized(device=CPU, **kwargs)
    u = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(dt),
                                     spatial_kernel=prior()).solve(adv).mean[:, 0, :]
    x = adv.mesh_spatial.points[:, 0]
    com0, comT = (float((x * v).sum() / v.sum()) for v in (u[0], u[-1]))
    assert comT > com0 + 1e-3


def test_fisher_kpp_grows_toward_its_carrying_capacity():
    _, kwargs, _, dt, _, _ = PROBLEMS["fisher-kpp-dirichlet"]
    pde = pt.examples.fisher_kpp_2d_discretized(device=CPU, **kwargs)
    sol = pt.white.SemiLinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(dt),
                                           spatial_kernel=prior()).solve(pde)
    u0, uT = sol.mean[0, 0], sol.mean[-1, 0]
    assert float(uT.max()) > float(u0.max())
    assert float(uT.max()) <= 1.05


def test_solve_through_the_ports_own_discretization():
    """The 12 x 12 heat at the JAX defaults, discretized by each package
    (``L`` 3.1e-8 apart: the near-singular stencil Gram), solved to
    tmax = 0.4: the final means and Grams follow ``L`` to 1e-7 of their
    largest entry (measured 7.7e-10 and 3.1e-9)."""
    kwargs = dict(num_points=(12, 12), tmax=0.4)
    jpde = jexamples.heat_2d_discretized(**kwargs)
    pde = pt.examples.heat_2d_discretized(device=CPU, **kwargs)
    jmean, jgram = final_state(jwhite.LinearWhiteNoiseEK1(
        steprule=jstep.Constant(0.1), spatial_kernel=jprior()), jpde, False)
    mean, gram = final_state(pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(0.1), spatial_kernel=prior(),
        factorization="householder"), pde, False)
    assert_rel(mean, jmean, 1e-7)
    assert_rel(gram, jgram, 1e-7)


def test_heat_2d_neumann_conserves_its_mean():
    """tests/test_neumann_nd.py's no-flux heat: 12 x 12, 9-point stencils,
    ``SquareExponential(0.05/dx)``, on the n-D Neumann operator. The spatial
    mean holds to 20% while the spread falls, and the trajectory follows
    JAX's to 1e-5 of its largest entry: this kernel's stencil Grams are
    bound by the 1e-12 nugget (``L`` and ``B`` part 7.9e-6 and 8.8e-6
    relative; measured 1.0e-7 on the means)."""
    num = 12
    dx = 1.0 / (num - 1)
    kwargs = dict(num_points=(num, num), tmax=0.5, bcond="neumann",
                  stencil_size_interior=9, stencil_size_boundary=9)
    pde = pt.examples.heat_2d_discretized(
        device=CPU, kernel=pt.kernels.SquareExponential(input_scale=0.05 / dx), **kwargs)
    assert pde.B.shape == (44, num * num)
    sol = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.05),
                                       spatial_kernel=prior()).solve(pde)
    u = sol.mean[:, 0, :]
    assert not torch.isnan(u).any()
    assert float(u[-1].mean()) == pytest.approx(float(u[0].mean()), rel=0.2)
    assert float(u[-1].std()) < float(u[0].std())

    jpde = jexamples.heat_2d_discretized(
        kernel=jkernels.SquareExponential(input_scale=0.05 / dx), **kwargs)
    ju = np.asarray(jwhite.LinearWhiteNoiseEK1(
        steprule=jstep.Constant(0.05), spatial_kernel=jprior()).solve(jpde).mean[:, 0, :])
    assert_rel(u.numpy(), ju, 1e-5)


def _predator_prey(lib, concat, split):
    def y0_fun(x):
        bump = lib.exp(-20.0 * ((x - 0.5) ** 2).sum(-1))
        return concat((5.0 * lib.ones(x.shape[0], dtype=x.dtype), 20.0 * bump))

    def f(_, z):
        u, v = split(z)
        return concat((0.5 * u - 0.05 * u * v, 0.05 * u * v - 0.5 * v))

    return y0_fun, f


def test_system_2d_neumann_solve_matches_jax():
    """tests/test_neumann_nd.py's two-species system on an 8 x 8 Neumann
    mesh through ``SystemSemiLinearEvolutionNeumann``, each package with its
    own discretization (``SquareExponential(0.1/dx)``, 9-point stencils,
    their Grams bound by the nugget), to tmax = 0.2: the JAX test's statements,
    and the final mean to 1e-6 of JAX's largest entry (measured 5.1e-8)."""
    num = 8
    dx = 1.0 / (num - 1)
    box = [[0.0, 1.0], [0.0, 1.0]]
    disc = dict(stencil_size_interior=9, stencil_size_boundary=9, nugget_gram_matrix=1e-12)

    y0_fun, f = _predator_prey(torch, torch.cat, lambda z: torch.chunk(z, 2))
    lap = pt.diffops.laplace()
    pde = pt.models.problems.SystemSemiLinearEvolutionNeumann(
        diffop=(lap, lap), diffop_scale=(0.1, 0.1), bbox=box, t0=0.0, tmax=0.2,
        y0_fun=y0_fun, f=f, df=torch.func.jacfwd(f, argnums=1), df_diagonal=None)
    pde.discretize_system(
        mesh_spatial=pt.mesh.RectangularMesh.from_bbox_2d(box, nums=(num, num), device=CPU),
        kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx), **disc)
    d = num * num
    assert pde.dimension == 2
    assert pde.L.shape == (2 * d, 2 * d) and pde.B.shape[0] == 2 * (4 * num - 4)
    final, _ = pt.white.SemiLinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(0.02),
        spatial_kernel=pt.duplicate(prior(), 2)).simulate_final_state(pde)
    assert not torch.isnan(final.y.mean).any()
    u, v = torch.chunk(final.y.mean[0], 2)
    assert float(u.mean()) > 5.0 and float(u.min()) > 0.0
    assert float(v.max()) < float(y0_fun(pde.mesh_spatial.points)[d:].max())

    jy0_fun, jf = _predator_prey(jnp, jnp.concatenate, lambda z: jnp.split(z, 2))
    jlap = jdiffops.laplace()
    jpde = jproblems.SystemSemiLinearEvolutionNeumann(
        diffop=(jlap, jlap), diffop_scale=(0.1, 0.1), bbox=jnp.asarray(box), t0=0.0, tmax=0.2,
        y0_fun=jy0_fun, f=jf, df=jax.jacfwd(jf, argnums=1), df_diagonal=None)
    jpde.discretize_system(
        mesh_spatial=jmesh.RectangularMesh.from_bbox_2d(box, nums=(num, num)),
        kernel=jkernels.SquareExponential(input_scale=0.1 / dx), **disc)
    jfinal, _ = jwhite.SemiLinearWhiteNoiseEK1(
        steprule=jstep.Constant(0.02),
        spatial_kernel=jkernels.duplicate(jprior(), num=2)).simulate_final_state(jpde)
    assert_rel(final.y.mean.numpy(), np.asarray(jfinal.y.mean), 1e-6)
