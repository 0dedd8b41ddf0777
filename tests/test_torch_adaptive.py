"""Adaptive steps in the port against the JAX package: the same accepted
and attempted step counts, the same final state, and the solve-loop contract
(landing on tmax, time stops, the bounded solve, divergence and zero-step
guards)."""

import math

import numpy as np
import pytest
import torch

from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.solvers import latent as jlatent
from pnmol_tpu.solvers import white as jwhite
import pnmol_tpu_torch as pt

torch.set_num_threads(1)

CPU = "cpu"
SOLVERS = {
    "white": (jwhite.LinearWhiteNoiseEK1, pt.white.LinearWhiteNoiseEK1),
    "latent": (jlatent.LinearLatentForceEK1, pt.latent.LinearLatentForceEK1),
}


@pytest.fixture(scope="module")
def heat():
    return pt.examples.heat_1d_discretized(dx=0.1, tmax=1.0, device=CPU)


@pytest.fixture(scope="module", params=sorted(SOLVERS))
def adaptive_runs(request, heat):
    """JAX's and the port's default-Adaptive final states on
    heat_1d_discretized(dx=0.1, tmax=1.0)."""
    jcls, tcls = SOLVERS[request.param]
    jfinal, jinfo = jcls().simulate_final_state(
        jexamples.heat_1d_discretized(dx=0.1, tmax=1.0)
    )
    solver = tcls()
    final, info = solver.simulate_final_state(heat)
    return request.param, solver, (final, info), (jfinal, jinfo)


def test_steprule_none_is_adaptive():
    for _, tcls in SOLVERS.values():
        assert tcls().steprule == pt.odetools.step.Adaptive()
        assert tcls().supports_adaptive_steps


def test_counts_and_final_state_match_jax(adaptive_runs, heat):
    name, _, (final, info), (jfinal, jinfo) = adaptive_runs
    if name == "white":  # JAX accepts 13 of 15 attempted steps here
        assert (jinfo["num_steps"], jinfo["num_attempted_steps"]) == (13, 15)
    for key in ("num_steps", "num_attempted_steps", "num_f_evaluations",
                "num_df_evaluations"):
        assert info[key] == jinfo[key], key
    assert info["num_attempted_steps"] > info["num_steps"]  # it rejected steps
    assert final.t == pytest.approx(float(heat.tmax), abs=1e-12)
    # the FD operators differ in their last bits (tests/test_torch_discretize.py)
    # and the controller amplifies that through the step sizes: measured
    # 8e-11 (mean) and 2e-11 (diffusion) relative for the white solver
    jmean = np.asarray(jfinal.y.mean)
    scale = np.abs(jmean).max()
    np.testing.assert_allclose(final.y.mean.numpy(), jmean, rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(float(final.diffusion_squared_local),
                               float(jfinal.diffusion_squared_local), rtol=1e-8)


def test_generator_and_final_state_agree(adaptive_runs, heat):
    _, solver, (final, info), _ = adaptive_runs
    states = list(solver.solution_generator(heat))
    last, last_info = states[-1]
    assert last_info == info
    assert len(states) == info["num_steps"] + 1
    ts = [s.t for s, _ in states]
    assert all(b > a for a, b in zip(ts, ts[1:]))
    assert last.t == final.t
    torch.testing.assert_close(last.y.mean, final.y.mean, rtol=0, atol=0)
    diffusion = torch.stack([s.diffusion_squared_local for s, _ in states[1:]]).mean()
    torch.testing.assert_close(final.y.cov_sqrtm, last.y.cov_sqrtm * torch.sqrt(diffusion),
                               rtol=0, atol=0)


def test_bounded_solve_matches_and_raises(adaptive_runs, heat):
    name, _, (final, info), _ = adaptive_runs
    make = SOLVERS[name][1]
    sol = make().solve(heat, max_steps=64)
    assert sol.info == info
    assert sol.t.shape == (info["num_steps"] + 1,)
    torch.testing.assert_close(sol.mean[-1], final.y.mean, rtol=0, atol=0)
    torch.testing.assert_close(sol.diffusion_squared_calibrated,
                               final.diffusion_squared_local, rtol=0, atol=0)
    torch.testing.assert_close(make().solve(heat).mean, sol.mean, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="max_steps=2"):
        make().solve(heat, max_steps=2)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_stop_at_hits_requested_time(name, heat):
    rule = pt.odetools.step.Adaptive(abstol=1e-3, reltol=1e-3)
    sol = SOLVERS[name][1](steprule=rule).solve(heat, stop_at=(0.217,))
    assert torch.any(torch.isclose(sol.t, torch.tensor(0.217, dtype=sol.t.dtype),
                                   rtol=0, atol=1e-14))
    assert float(sol.t[-1]) == pytest.approx(1.0, abs=1e-12)


def test_jax_stop_at_trajectory_matches(heat):
    """Time stops on a Constant rule go through the controller too: the
    accumulated times are JAX's."""
    jsol = jwhite.LinearWhiteNoiseEK1(steprule=jstep.Constant(0.3)).solve(
        jexamples.heat_1d_discretized(dx=0.1, tmax=1.0), stop_at=(0.45, 0.5))
    sol = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.3)).solve(
        heat, stop_at=(0.45, 0.5))
    np.testing.assert_allclose(sol.t.numpy(), np.asarray(jsol.t), rtol=0, atol=1e-15)
    assert sol.info == jsol.info
    scale = np.abs(np.asarray(jsol.mean)).max()
    np.testing.assert_allclose(sol.mean.numpy(), np.asarray(jsol.mean), rtol=0,
                               atol=1e-10 * scale)


class _DivergingFilter(pt.pdefilter.PDEFilter):
    """A filter whose every attempt reports a NaN error estimate."""

    def initialize(self, pde):
        zero = torch.zeros((), dtype=torch.float64)
        return pt.pdefilter.PDEFilterState(
            t=0.0, y=pt.ops.rv.MultivariateNormal(torch.ones(3, 2, dtype=torch.float64),
                                                torch.eye(6, dtype=torch.float64)),
            error_estimate=None, reference_state=None, diffusion_squared_local=zero,
        )

    def _step_function(self, pde):
        def step(mean, cov, t_next, dt):
            nan = torch.full((2,), math.nan, dtype=torch.float64)
            return mean, cov, nan, torch.ones(2), torch.zeros(())
        return step


class _Problem:
    t0, tmax = 0.0, 1.0
    L = -torch.eye(2, dtype=torch.float64)
    y0 = torch.ones(2, dtype=torch.float64)


def test_nan_error_estimate_raises_instead_of_spinning():
    solver = _DivergingFilter(steprule=pt.odetools.step.Adaptive())
    with pytest.raises(FloatingPointError, match="diverged at t=0"):
        solver.simulate_final_state(_Problem())


def test_adaptive_attempt_masks_a_rejected_attempt():
    rule = pt.odetools.step.Adaptive()
    mean, cov = torch.ones(3, 2, dtype=torch.float64), torch.eye(6, dtype=torch.float64)

    def step(mean_, cov_, t_next, dt):
        big = torch.full((2,), 1e3, dtype=torch.float64)
        return mean_ + 1.0, cov_, big, torch.ones(2, dtype=torch.float64), torch.ones(())

    t, m, c, dt, accepted, *_ = pt.pdefilter.adaptive_attempt(
        step, rule, 3, 0.25, mean, cov, 0.1, 1.0)
    assert not accepted and t == 0.25 and dt == pytest.approx(0.02)
    assert m is mean and c is cov


def test_zero_step_guard():
    """tmax within epsilon of t0: no step, no calibration, the covariance
    unscaled (diffusion 1)."""
    heat = pt.examples.heat_1d_discretized(dx=0.2, tmax=1e-14, device=CPU)
    final, info = pt.white.LinearWhiteNoiseEK1().simulate_final_state(heat)
    assert info["num_steps"] == info["num_attempted_steps"] == 0
    assert float(final.diffusion_squared_local) == 1.0
    state0 = pt.white.LinearWhiteNoiseEK1().initialize(heat)
    torch.testing.assert_close(final.y.cov_sqrtm, state0.y.cov_sqrtm, rtol=0, atol=0)
    assert final.t == 0.0
