"""The port's utilities against the JAX package's.

One counterpart for each case of ``tests/test_utils.py``, on the same
problems (``heat_1d_discretized(dx=0.2)``, the ``Matern52() + WhiteNoise()``
prior): checkpoints (also read from an ``.npz`` the JAX package wrote),
finite checks, the NaN scope, configs, the FLOP model and roofline, timers
and resilient solves, whose NaN injections mirror JAX's monkeypatching.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pnmol_tpu_torch as pt  # noqa: E402
from pnmol_tpu import kernels  # noqa: E402
from pnmol_tpu.models import examples  # noqa: E402
from pnmol_tpu.odetools import step  # noqa: E402
from pnmol_tpu.solvers import white  # noqa: E402
from pnmol_tpu.utils import checkpoint as jcheckpoint  # noqa: E402
from pnmol_tpu.utils import profiling as jprofiling  # noqa: E402
from pnmol_tpu_torch.solvers import pdefilter  # noqa: E402
from pnmol_tpu_torch.utils import (  # noqa: E402
    checkpoint,
    configs,
    debug,
    profiling,
    resilience,
)


def _prior():
    return pt.kernels.Matern52() + pt.kernels.WhiteNoise()


def _heat(tmax=0.5):
    return pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=tmax, device="cpu")


def _solver(rule):
    return pt.white.LinearWhiteNoiseEK1(steprule=rule, spatial_kernel=_prior())


@pytest.fixture(scope="module")
def solved():
    pde = _heat(tmax=0.4)
    solver = _solver(pt.odetools.step.Constant(dt=0.1))
    final, _ = solver.simulate_final_state(pde)
    return pde, solver, final


@pytest.fixture(scope="module")
def jax_final():
    pde = examples.heat_1d_discretized(dx=0.2, tmax=0.4)
    solver = white.LinearWhiteNoiseEK1(steprule=step.Constant(dt=0.1),
                                       spatial_kernel=kernels.Matern52() + kernels.WhiteNoise())
    return solver.simulate_final_state(pde)[0]


def test_checkpoint_roundtrip(tmp_path, solved, jax_final, monkeypatch):
    _, _, final = solved
    path = tmp_path / "ckpt"
    checkpoint.save_state(path, final, extra={"note": torch.tensor(3.0)})
    restored, extra = checkpoint.load_state(path, device="cpu")
    assert restored.t == final.t
    assert torch.equal(restored.y.mean, final.y.mean)
    assert torch.equal(restored.y.cov_sqrtm, final.y.cov_sqrtm)
    assert torch.equal(restored.diffusion_squared_local, final.diffusion_squared_local)
    assert float(extra["note"]) == 3.0

    # the JAX package's npz branch writes what the port reads, and back
    monkeypatch.setattr(jcheckpoint, "_HAVE_ORBAX", False)
    jcheckpoint.save_state(tmp_path / "jax", jax_final, extra={"note": jnp.asarray(3.0)})
    from_jax, extra = checkpoint.load_state(tmp_path / "jax", device="cpu")
    assert from_jax.t == pytest.approx(float(jax_final.t))
    assert np.array_equal(from_jax.y.mean.numpy(), np.asarray(jax_final.y.mean))
    assert np.array_equal(from_jax.y.cov_sqrtm.numpy(), np.asarray(jax_final.y.cov_sqrtm))
    assert float(extra["note"]) == 3.0
    assert np.allclose(from_jax.y.mean.numpy(), final.y.mean.numpy(), rtol=0, atol=1e-12)
    back, _ = jcheckpoint.load_state(path)
    assert np.array_equal(np.asarray(back.y.mean), final.y.mean.numpy())


def test_checkpoint_resume_continues_solve(tmp_path, solved):
    """Restore a state and keep stepping from it."""
    pde, solver, final = solved
    path = tmp_path / "resume"
    checkpoint.save_state(path, final)
    restored, _ = checkpoint.load_state(path, device="cpu")
    mean, cov, *_ = solver._step_fn(restored.y.mean, restored.y.cov_sqrtm, restored.t + 0.1, 0.1)
    assert not torch.isnan(mean).any()
    assert restored.y.mean.device == final.y.mean.device


def test_assert_finite():
    debug.assert_finite({"a": torch.ones(3), "b": (1.0, None)}, "ok")
    with pytest.raises(FloatingPointError, match=r"bad\['a'\]\[1\]"):
        debug.assert_finite({"a": [torch.ones(2), torch.tensor([1.0, float("nan")])]}, "bad")
    with pytest.warns(RuntimeWarning, match="x"):
        debug.checkify_finite(torch.tensor([float("inf")]), "x")


def test_debug_nans_context():
    with debug.debug_nans(True):
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
    assert not torch.is_anomaly_enabled()


def test_configs_build_and_solve():
    run = configs.RunConfig(
        problem=configs.ProblemConfig(family="heat", dx=0.2, tmax=0.3),
        solver=configs.SolverConfig(method="white", linearity="linear", steprule="constant",
                                    dt=0.1),
    )
    pde, solver = run.build(device="cpu")
    sol = solver.solve(pde)
    debug.validate_solution(sol)
    jpde = examples.heat_1d_discretized(dx=0.2, tmax=0.3)
    jsol = white.LinearWhiteNoiseEK1(steprule=step.Constant(0.1)).solve(jpde)
    assert np.allclose(sol.mean.numpy(), np.asarray(jsol.mean), rtol=0, atol=1e-10)


def test_configs_system_family():
    run = configs.RunConfig(
        problem=configs.ProblemConfig(family="lotka_volterra", dx=0.25, tmax=0.2),
        solver=configs.SolverConfig(method="latent", linearity="semilinear",
                                    steprule="constant", dt=0.1, prior_duplicates=2),
    )
    pde, solver = run.build(device="cpu")
    assert isinstance(solver, pt.latent.SemiLinearLatentForceEK1)
    sol = solver.solve(pde)
    assert not torch.isnan(sol.mean).any()


def test_flop_accounting():
    flops = profiling.white_step_flops(d=256, nu=2, b=2)
    assert flops > 0
    assert flops == jprofiling.white_step_flops(d=256, nu=2, b=2)
    gflops = profiling.steps_per_sec_to_gflops(500.0, d=256, nu=2, b=2)
    assert gflops > 1.0


def test_solve_resilient_happy_path(tmp_path):
    pde = _heat()
    solver = _solver(pt.odetools.step.Constant(dt=0.05))
    final, report = resilience.solve_resilient(solver, pde, checkpoint_dir=tmp_path / "ck",
                                               checkpoint_every=3)
    assert final.t == pytest.approx(0.5)
    assert report.num_steps == 10
    assert report.num_failures == 0
    assert report.num_checkpoints >= 3
    plain, _ = solver.simulate_final_state(pde)
    assert torch.allclose(final.y.mean, plain.y.mean, rtol=0, atol=1e-10)


def test_solve_resilient_recovers_from_injected_nan(tmp_path):
    pde = _heat()
    solver = _solver(pt.odetools.step.Constant(dt=0.05))
    original_attempt = solver.attempt_step
    fail_state = {"armed": True}

    def flaky_attempt(state, dt, p, t_next=None):
        new_state, info = original_attempt(state, dt, p, t_next)
        if fail_state["armed"] and state.t >= 0.2:
            fail_state["armed"] = False
            poisoned = new_state.y._replace(mean=new_state.y.mean * float("nan"))
            return new_state._replace(y=poisoned), info
        return new_state, info

    solver.attempt_step = flaky_attempt
    final, report = resilience.solve_resilient(solver, pde, checkpoint_dir=tmp_path / "ck",
                                               checkpoint_every=2)
    assert final.t == pytest.approx(0.5)
    assert report.num_failures == 1
    assert report.num_restarts == 1
    assert report.final_dt == pytest.approx(0.025)  # backed off once
    assert bool(torch.isfinite(final.y.mean).all())


def test_solve_resilient_adaptive(tmp_path):
    """Adaptive rules run through the shared adaptive_attempt and match the
    plain adaptive driver."""
    pde = _heat()
    solver = _solver(pt.odetools.step.Adaptive())
    final, report = resilience.solve_resilient(solver, pde, checkpoint_dir=tmp_path / "ck",
                                               checkpoint_every=3)
    assert final.t == pytest.approx(0.5)
    assert report.num_failures == 0
    plain, info = solver.simulate_final_state(pde)
    assert report.num_steps == info["num_steps"]
    assert torch.allclose(final.y.mean, plain.y.mean, rtol=0, atol=1e-10)


def _poison_accepted_mean(monkeypatch):
    real_attempt = pdefilter.adaptive_attempt
    armed = {"on": True}

    def flaky_attempt(step_fn, steprule, rate, t, mean, cov, dt, tmax):
        out = real_attempt(step_fn, steprule, rate, t, mean, cov, dt, tmax)
        if armed["on"] and t >= 0.2:
            armed["on"] = False
            out = list(out)
            out[1] = out[1] * float("nan")  # poison the accepted mean
            out = tuple(out)
        return out

    monkeypatch.setattr(pdefilter, "adaptive_attempt", flaky_attempt)


def test_solve_resilient_adaptive_recovers_from_injected_nan(tmp_path, monkeypatch):
    """A NaN injected mid-adaptive-solve restarts from the last checkpoint
    with a backed-off dt."""
    pde = _heat()
    solver = _solver(pt.odetools.step.Adaptive())
    _poison_accepted_mean(monkeypatch)
    final, report = resilience.solve_resilient(solver, pde, checkpoint_dir=tmp_path / "ck",
                                               checkpoint_every=2)
    assert final.t == pytest.approx(0.5)
    assert report.num_failures == 1
    assert report.num_restarts == 1
    assert bool(torch.isfinite(final.y.mean).all())


def test_solve_resilient_adaptive_recovers_from_rejected_nan_attempt(tmp_path, monkeypatch):
    """A NaN attempt is rejected with its state masked back to finite
    values; only the suggested dt and the error estimate carry the NaN,
    and they must restart the solve."""
    pde = _heat()
    solver = _solver(pt.odetools.step.Adaptive())
    real_attempt = pdefilter.adaptive_attempt
    armed = {"on": True}

    def flaky_attempt(step_fn, steprule, rate, t, mean, cov, dt, tmax):
        out = real_attempt(step_fn, steprule, rate, t, mean, cov, dt, tmax)
        if armed["on"] and t >= 0.2:
            armed["on"] = False
            out = list(out)
            out[3] = float("nan")  # suggested dt
            out[4] = False  # rejected
            out[5] = out[5] * float("nan")  # raw error estimate
            out = tuple(out)  # the state (out[1:3]) stays finite
        return out

    monkeypatch.setattr(pdefilter, "adaptive_attempt", flaky_attempt)
    final, report = resilience.solve_resilient(solver, pde, checkpoint_dir=tmp_path / "ck",
                                               checkpoint_every=2)
    assert final.t == pytest.approx(0.5)
    assert report.num_failures == 1
    assert report.num_restarts == 1
    assert bool(torch.isfinite(final.y.mean).all())


def test_adaptive_driver_raises_on_persistent_nan_attempt(monkeypatch):
    """The adaptive driver raises instead of spinning when every attempt
    past some t is a rejected NaN."""
    pde = _heat()
    solver = _solver(pt.odetools.step.Adaptive())
    real_attempt = pdefilter.adaptive_attempt

    def flaky_attempt(step_fn, steprule, rate, t, mean, cov, dt, tmax):
        out = list(real_attempt(step_fn, steprule, rate, t, mean, cov, dt, tmax))
        if t >= 0.2:
            out[3] = float("nan")
            out[4] = False
        return tuple(out)

    monkeypatch.setattr(pdefilter, "adaptive_attempt", flaky_attempt)
    with pytest.raises(FloatingPointError, match="diverged"):
        solver.simulate_final_state(pde)


def test_solve_resilient_rejects_unknown_steprule(tmp_path):
    solver = _solver(pt.odetools.step.Constant(0.1))
    solver.steprule = object()  # neither Constant nor Adaptive
    with pytest.raises(NotImplementedError):
        resilience.solve_resilient(solver, _heat(), checkpoint_dir=tmp_path)


def test_timer_and_time_blocked(solved):
    _, solver, final = solved
    out, elapsed = profiling.time_blocked(solver._step_fn, final.y.mean, final.y.cov_sqrtm, 0.5,
                                          0.1, repeats=2)
    assert elapsed > 0.0
    assert out[0].shape == final.y.mean.shape
    with profiling.Timer() as timer:
        profiling.force_complete(out)
    assert timer.elapsed >= 0.0


def test_lq_sweep_flops_matches_dense_qr():
    D = 256
    dense = profiling.lq_sweep_flops(D, 2 * D)
    closed = profiling.qr_flops(2 * D, D)
    assert abs(dense - closed) / closed < 0.02
    assert dense == jprofiling.lq_sweep_flops(D, 2 * D)


def test_per_pipeline_flop_ordering():
    """interleaved < banded < two_qr < fused, the structural ratios of the
    banded and interleaved sweeps, and JAX's numbers for each pipeline."""
    d, nu, b = 4096, 1, 2
    flops = {p: profiling.white_step_flops(d, nu, b, p) for p in profiling.WHITE_PIPELINES}
    assert profiling.WHITE_PIPELINES == jprofiling.WHITE_PIPELINES
    assert flops == {p: jprofiling.white_step_flops(d, nu, b, p)
                     for p in jprofiling.WHITE_PIPELINES}
    assert flops["steady"] < flops["interleaved"] < flops["banded"]
    assert flops["banded"] < flops["two_qr"] < flops["fused"]

    D = (nu + 1) * d
    dense_prop = profiling.lq_sweep_flops(D, 2 * D)
    banded_prop = profiling.lq_sweep_flops(D, 2 * D, b0=D + 1, slope=1.0)
    inter_prop = profiling.lq_sweep_flops(D, 2 * D, b0=nu + 1, slope=2.0)
    assert 0.55 < banded_prop / dense_prop < 0.65
    assert 0.15 < inter_prop / dense_prop < 0.25
    assert flops["steady"] < 1e-2 * flops["interleaved"]


def test_roofline_per_pipeline():
    r_fused = profiling.roofline(2048, 1, 2, pipeline="fused")
    r_inter = profiling.roofline(2048, 1, 2, pipeline="interleaved")
    assert r_inter["steps_per_sec_ceiling"] > r_fused["steps_per_sec_ceiling"]
    legacy = profiling.roofline(2048, 1, 2, fused=False)
    two_qr = profiling.roofline(2048, 1, 2, pipeline="two_qr")
    assert legacy["qr_flops"] == two_qr["qr_flops"]
    with pytest.raises(ValueError):
        profiling.roofline(2048, 1, 2, pipeline="steady")
    # the FLOP split is JAX's; the rates are the H100's FP64 and HBM ones
    j_fused = jprofiling.roofline(2048, 1, 2, pipeline="fused")
    assert r_fused["qr_flops"] == j_fused["qr_flops"]
    assert r_fused["other_flops"] == j_fused["other_flops"]
    assert r_fused["bound_by"] == "operations"
    assert r_fused["tflops_at_ceiling"] == pytest.approx(67.0)
    assert r_fused["fp64_peak_share_at_ceiling"] == pytest.approx(1.0)
    assert "mfu_ceiling_vs_bf16_peak" not in r_fused


def test_trace_and_dump_live_arrays(tmp_path, monkeypatch, capsys):
    """The profiler scope writes a Chrome trace with the annotated region;
    the live-array dump prints only under PNMOL_DEBUG_LIVE=1."""
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("pnmol_region"):
            torch.ones(8) @ torch.ones(8)
    assert "pnmol_region" in (tmp_path / "trace" / "trace.json").read_text()
    monkeypatch.delenv("PNMOL_DEBUG_LIVE", raising=False)
    debug.dump_live_arrays("off")
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("PNMOL_DEBUG_LIVE", "1")
    debug.dump_live_arrays("on")
    assert "[live_arrays:on]" in capsys.readouterr().out
