"""The port's MOL baseline EK1 against the JAX package's: one attempt step
from the same state, whole constant-step solves (means, covariance Grams
and the calibrated diffusion to 1e-10), the adaptive loop's step and
attempt counts (equal), ``simulate_final_state``, and figure 4's
work-precision statistics on Lotka-Volterra at dx = 0.2 (1e-8).

The heat problems take JAX's ``L`` (the FD weights of two linear-algebra
libraries differ at 1e-12, tests/test_torch_problems.py), so the filters
run from the same numbers; the Lotka-Volterra run is the port's own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import ek1 as jek1
from pnmol_tpu.odetools import init as jinit
from pnmol_tpu.odetools import reference_solver as jref
from pnmol_tpu.odetools import step as jstep
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.odetools import ek1, init, reference_solver, step

torch.set_num_threads(1)

CPU = "cpu"


def gram(C):
    C = np.asarray(C)
    return C @ C.T


def rel_close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def heat():
    """The heat IVP at dx = 0.1 (d = 9 interior points), both packages."""
    jpde = jexamples.heat_1d_discretized(dx=0.1, tmax=1.0)
    pde = pt.examples.heat_1d_discretized(dx=0.1, tmax=1.0, device=CPU)
    pde.L = torch.tensor(np.asarray(jpde.L))
    return pde.to_ivp(), jpde.to_ivp()


def solvers(nu, rule, routine):
    """The port's and JAX's solver for ``rule`` ("constant" or "adaptive")
    and initialization ``routine`` ("stack" or "taylor")."""
    rules = {"constant": (step.Constant(0.05), jstep.Constant(0.05)),
             "adaptive": (step.Adaptive(abstol=1e-6, reltol=1e-4),
                          jstep.Adaptive(abstol=1e-6, reltol=1e-4))}
    routines = {"stack": (init.Stack(use_df=False), jinit.Stack(use_df=False)),
                "taylor": (init.TaylorMode(), jinit.TaylorMode())}
    (rule_t, rule_j), (init_t, init_j) = rules[rule], routines[routine]
    return (ek1.ReferenceEK1ConstantDiffusion(num_derivatives=nu, steprule=rule_t,
                                              initialization=init_t),
            jek1.ReferenceEK1ConstantDiffusion(num_derivatives=nu, steprule=rule_j,
                                               initialization=init_j))


def test_one_step_from_the_same_state_matches_jax(heat):
    """Everything to 1e-12 of its largest entry but the posterior Gram, a
    square of the factor, which agrees to 1.1e-12 (measured), held to 1e-11."""
    ivp, jivp = heat
    solver, jsolver = solvers(2, "constant", "stack")
    jstate = jsolver.initialize(jivp)
    jout = jsolver._step_fn(jstate.y.mean, jstate.y.cov_sqrtm, jnp.asarray(0.05),
                            jnp.asarray(0.05))
    solver.initialize(ivp)
    state = interop.ode_filter_state(t=0.0, mean=np.asarray(jstate.y.mean),
                                     cov_sqrtm=np.asarray(jstate.y.cov_sqrtm), device=CPU)
    out = solver._step_fn(state.y.mean, state.y.cov_sqrtm, 0.05, 0.05)
    mean, cov, error, ref, sig = out
    rel_close(mean, jout[0], 1e-12)
    rel_close(gram(cov), gram(jout[1]), 1e-11)
    rel_close(error, jout[2], 1e-12)
    rel_close(ref, jout[3], 1e-12)
    rel_close(sig, jout[4], 1e-12)


@pytest.mark.parametrize("nu, routine", [(2, "stack"), (3, "taylor")])
def test_constant_solve_matches_jax(heat, nu, routine):
    ivp, jivp = heat
    solver, jsolver = solvers(nu, "constant", routine)
    sol, sigma_sq = solver.solve(ivp)
    jsol, jsigma_sq = jsolver.solve(jivp)
    assert sol.mean.shape == jsol.mean.shape == (21, nu + 1, 9)
    assert sol.info == jsol.info == dict(num_steps=20, num_attempted_steps=20)
    rel_close(sol.t, jsol.t, 1e-15)
    rel_close(sol.mean, jsol.mean, 1e-10)
    for k in (1, 10, 20):
        rel_close(gram(sol.cov_sqrtm[k]), gram(jsol.cov_sqrtm[k]), 1e-10)
    rel_close(sigma_sq, jsigma_sq, 1e-10)
    # the heat decays, and E0 projects onto the interior points
    assert sol.mean[-1, 0].abs().max() < sol.mean[0, 0].abs().max()
    assert solver.iwp.projection_matrix(0).shape == (9, 9 * (nu + 1))


def test_simulate_final_state_matches_jax_and_solve(heat):
    ivp, jivp = heat
    solver, jsolver = solvers(2, "constant", "stack")
    final, info = solver.simulate_final_state(ivp)
    jfinal, jinfo = jsolver.simulate_final_state(jivp)
    assert info == jinfo == dict(num_steps=20)
    assert final.t == pytest.approx(1.0, abs=1e-15)
    rel_close(final.y.mean, jfinal.y.mean, 1e-10)
    rel_close(gram(final.y.cov_sqrtm), gram(jfinal.y.cov_sqrtm), 1e-10)
    sol, sigma_sq = solver.solve(ivp)
    torch.testing.assert_close(final.y.cov_sqrtm, sol.cov_sqrtm[-1] * torch.sqrt(sigma_sq),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("entry", ["solve", "simulate_final_state"])
def test_adaptive_counts_equal_jax(heat, entry):
    ivp, jivp = heat
    solver, jsolver = solvers(2, "adaptive", "taylor")
    if entry == "solve":
        (sol, sigma_sq), (jsol, jsigma_sq) = solver.solve(ivp), jsolver.solve(jivp)
        info, jinfo, mean, jmean = sol.info, jsol.info, sol.mean[-1], jsol.mean[-1]
        assert float(sol.t[-1]) == pytest.approx(1.0)
        rel_close(sol.t, jsol.t, 1e-12)
    else:
        (final, info), (jfinal, jinfo) = (solver.simulate_final_state(ivp),
                                          jsolver.simulate_final_state(jivp))
        mean, jmean, sigma_sq, jsigma_sq = (final.y.mean, jfinal.y.mean,
                                            final.diffusion_squared_local,
                                            jfinal.diffusion_squared_local)
    assert info == jinfo
    assert info["num_attempted_steps"] > info["num_steps"] > 1
    rel_close(mean, jmean, 1e-10)
    rel_close(sigma_sq, jsigma_sq, 1e-10)


# figure 4's statistics (experiments/common.py)
def chi2_statistic(error_abs, cov):
    chol = torch.linalg.cholesky(cov + 1e-12 * torch.eye(cov.shape[0], dtype=cov.dtype))
    white = torch.cholesky_solve(error_abs[:, None], chol)[:, 0]
    return error_abs @ white / error_abs.shape[0]


def rmse(error_abs, reference):
    err = error_abs / torch.abs(reference)
    return torch.linalg.norm(err) / err.numel() ** 0.5


def figure4_mol(examples, ek1_module, init_module, step_module, reference_module, to_tensor,
                device_kwargs, dts):
    """Figure 4's MOL column at dx = 0.2 (experiments/figure4.py) in either
    package: ``[(rmse, chi2, num_steps)]`` over ``dts``."""
    def make_lv(dx, **kwargs):
        return examples.lotka_volterra_1d_discretized(t0=0.0, tmax=1.0, dx=dx, **kwargs,
                                                      **device_kwargs)

    ivp = make_lv(0.2, stencil_size_interior=3, stencil_size_boundary=4).to_ivp()
    ref_ivp = make_lv(0.2 / 7).to_ivp()
    ref = reference_module.solve_ivp_stiff(ref_ivp.f, ref_ivp.t_span, ref_ivp.y0,
                                           t_eval=np.asarray([1.0]), rtol=1e-10, atol=1e-10,
                                           jac=ref_ivp.df)
    u_ref = to_tensor(ref.y[-1])[: ref_ivp.y0.shape[0] // 2][6::7]
    rows = []
    for dt in dts:
        solver = ek1_module.ReferenceEK1ConstantDiffusion(
            num_derivatives=2, steprule=step_module.Constant(dt),
            initialization=init_module.Stack(use_df=False))
        final, info = solver.simulate_final_state(ivp)
        mean, C = to_tensor(final.y.mean), to_tensor(final.y.cov_sqrtm)
        E0 = to_tensor(solver.iwp.projection_matrix(0))
        half = mean.shape[1] // 2
        u, cov0 = mean[0, :half], E0 @ (C @ C.T) @ E0.T
        err = torch.abs(u - u_ref)
        rows.append((float(rmse(err, u_ref)), float(chi2_statistic(err, cov0[:half, :half])),
                     info["num_steps"]))
    return rows


def test_figure4_mol_statistics_match_jax():
    dts = [1.0, 0.0562341325190349]  # the first two of logspace(0, -2.5, 3)
    got = figure4_mol(pt.examples, ek1, init, step, reference_solver, lambda x: x,
                      dict(device=CPU), dts)
    want = figure4_mol(jexamples, jek1, jinit, jstep, jref,
                       lambda x: torch.tensor(np.asarray(x)), {}, dts)
    for (rmse_t, chi2_t, steps_t), (rmse_j, chi2_j, steps_j) in zip(got, want):
        assert steps_t == steps_j
        assert rmse_t == pytest.approx(rmse_j, rel=1e-8)
        assert chi2_t == pytest.approx(chi2_j, rel=1e-8) and chi2_t > 0
    assert [s for _, _, s in got] == [1, 18]
