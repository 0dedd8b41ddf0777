"""The port's step rules against the JAX package's (mirror of
tests/test_odetools/test_step.py): accept/reject, clamped suggestions, the
rate the controller needs, RMS error scaling and the first step."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
import pnmol_tpu_torch as pt

torch.set_num_threads(1)

tstep = pt.odetools.step
CPU = "cpu"


def test_constant_rule():
    rule = tstep.Constant(dt=0.1)
    assert rule.is_accepted(torch.tensor(float("inf")))
    assert rule.suggest(0.5, None) == 0.1
    assert rule.scale_error_estimate(None, None) is None
    assert (rule.min_step, rule.max_step) == (jstep.Constant(0.1).min_step,
                                              jstep.Constant(0.1).max_step)


def test_adaptive_defaults_match_jax():
    assert dataclasses.asdict(tstep.Adaptive()) == dataclasses.asdict(jstep.Adaptive())


def test_adaptive_accept_reject():
    rule = tstep.Adaptive(abstol=1e-4, reltol=1e-2)
    assert bool(rule.is_accepted(torch.tensor(0.5)))
    assert not bool(rule.is_accepted(torch.tensor(2.0)))
    assert not bool(rule.is_accepted(torch.tensor(float("nan"))))


@pytest.mark.parametrize("scaled", [1e-4, 0.3, 0.97, 1.0, 1.7, 1e4])
def test_adaptive_suggest_monotone_and_equal_to_jax(scaled):
    rule, jrule = tstep.Adaptive(), jstep.Adaptive()
    dt = 0.1
    got = float(rule.suggest(dt, torch.tensor(scaled, dtype=torch.float64),
                             local_convergence_rate=3))
    want = float(jrule.suggest(dt, jnp.asarray(scaled), local_convergence_rate=3))
    # one pow, one clip and one product in f64
    np.testing.assert_allclose(got, want, rtol=1e-14)
    assert 0.2 * dt - 1e-12 <= got <= 10.0 * dt + 1e-12  # clamped into max_changes
    assert (got > dt) == (scaled < 0.95**3)  # grow on small error, shrink on large


def test_adaptive_suggest_requires_rate():
    with pytest.raises(ValueError):
        tstep.Adaptive().suggest(0.1, torch.tensor(1.0))


def test_scale_error_estimate_rms_matches_jax():
    rule = tstep.Adaptive(abstol=1.0, reltol=0.0)
    err = torch.full((4,), 2.0, dtype=torch.float64)
    assert float(rule.scale_error_estimate(err, torch.zeros(4, dtype=torch.float64))) == 2.0

    rng = np.random.default_rng(0)
    err, ref = rng.uniform(size=7) * 1e-3, rng.uniform(size=7)
    got = tstep.Adaptive().scale_error_estimate(torch.from_numpy(err), torch.from_numpy(ref))
    want = jstep.Adaptive().scale_error_estimate(jnp.asarray(err), jnp.asarray(ref))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-14)


def test_first_dt_linear_and_nonlinear_match_jax():
    rule, jrule = tstep.Adaptive(), jstep.Adaptive()
    heat = pt.examples.heat_1d_discretized(dx=0.2, device=CPU)
    jheat = jexamples.heat_1d_discretized(dx=0.2)
    # L @ y0 differs from JAX's in the last bits of L (tests/test_torch_discretize.py)
    np.testing.assert_allclose(float(rule.first_dt(heat)), float(jrule.first_dt(jheat)),
                               rtol=1e-11)
    assert float(rule.first_dt(heat)) > 0.0

    spruce = pt.examples.spruce_budworm_1d_discretized(dx=0.2, device=CPU)
    jspruce = jexamples.spruce_budworm_1d_discretized(dx=0.2)
    # f is a closed form on the same y0: equal to rounding
    np.testing.assert_allclose(float(rule.first_dt(spruce)), float(jrule.first_dt(jspruce)),
                               rtol=1e-14)


def test_propose_first_dt_values_match_jax():
    L = -2.0 * np.eye(3) + np.diag([0.5, 0.25], 1)
    y0 = np.array([1.0, -0.5, 2.0])
    got = tstep.propose_first_dt_linear(torch.from_numpy(L), 0.0, torch.from_numpy(y0))
    want = jstep.propose_first_dt_linear(jnp.asarray(L), 0.0, jnp.asarray(y0))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-14)
    np.testing.assert_allclose(float(got), 0.01 * np.linalg.norm(y0) / np.linalg.norm(L @ y0),
                               rtol=1e-14)

    got = tstep.propose_first_dt(lambda t, y: y**2 - t, 0.5, torch.from_numpy(y0))
    want = jstep.propose_first_dt(lambda t, y: y**2 - t, 0.5, jnp.asarray(y0))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-14)
