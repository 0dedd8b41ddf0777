"""The graphed white-noise attempt (``white.GraphedWhiteAttempt``): where it
engages, the host reads it removes from the step, and on the card the
graph against the attempt run op by op.

On the CPU: the engagement rule, the Nordsieck scales from a device scalar
``dt``, the deferring step itself, and the graphed attempt's buffers and
the Cholesky failure that it defers to the solve loop's reads, forced on
with a stand-in for the CUDA graph that replays the captured attempt op by
op. The ``cuda`` tests hold the graph to the eager attempt at
the benchmark's N=512 point. Imports neither JAX nor the JAX package::

    python -m pytest tests/test_torch_graph.py -m cuda --noconftest -q
"""

import contextlib
import functools
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

import pnmol_tpu_torch as pt
from pnmol_tpu_torch.ops import iwp
from pnmol_tpu_torch.ops import qr_householder as tq
from pnmol_tpu_torch.solvers import pdefilter, white

torch.set_num_threads(1)


def _heat(dx, tmax, device="cpu"):
    return pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=tmax, device=device, kernel=pt.kernels.SquareExponential(0.1 / dx))


class _ReplayingGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU as a graph behaves:
    the attempt run between ``capture_begin`` and ``capture_end`` (recorded by
    :func:`_recording`) runs again at each replay, on the same buffers, into
    the same outputs."""

    captured = None

    def capture_begin(self):
        _ReplayingGraph.captured = None

    def capture_end(self):
        self.body = _ReplayingGraph.captured

    def replay(self):
        self.body()


def _recording(attempt):
    """``attempt``, its last call kept for :class:`_ReplayingGraph`; its
    counters are the wrapper's while it stands in the module's place."""

    @functools.wraps(attempt)
    def record(*args, **kwargs):
        outputs = attempt(*args, **kwargs)

        def body():
            for output, new in zip(outputs, attempt(*args, **kwargs)):
                output.copy_(new)

        _ReplayingGraph.captured = body
        return outputs

    return record


def _force(monkeypatch, graph=_ReplayingGraph):
    """The graphed attempt wherever the solver is built, with ``graph`` for
    the CUDA graph and no capture stream."""
    monkeypatch.setattr(white, "graph_engages", lambda *args: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", graph)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(white, "_capture_stream", lambda device: None)
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None, raising=False)
    if graph is _ReplayingGraph:
        monkeypatch.setattr(white, "white_attempt_step", _recording(white.white_attempt_step))


@pytest.fixture
def forced(monkeypatch):
    _force(monkeypatch)


# --- the engagement rule ------------------------------------------------------

ENGAGES = dict(cls=pt.LinearWhiteNoiseEK1, kwargs=dict(factorization="householder"), d=512,
               dtype=torch.float64, device="cuda")


@pytest.mark.parametrize("change, engages", [
    ({}, True),
    (dict(dtype=torch.float32), True),
    (dict(d=4095), True),
    (dict(device="cpu"), False),
    (dict(kwargs=dict(factorization="householder", fused=False)), False),
    (dict(kwargs=dict(factorization=None)), False),
    (dict(kwargs=dict(factorization=tq.make_householder_lq_factorization())), False),
    (dict(cls=pt.SemiLinearWhiteNoiseEK1), False),
    (dict(cls=pt.SemiLinearWhiteNoiseEK0), False),
    (dict(d=4096), False),
    (dict(d=10000, dtype=torch.float32), False),
    (dict(kwargs=dict(factorization="householder", steady_state=True)), False),
    (dict(kwargs=dict(factorization="householder", steady_state={})), False),
], ids=["block-route", "f32", "d-4095", "cpu", "two-qr", "plain-qr", "own-hook", "semilinear",
        "ek0", "d-4096", "d-1e4-f32", "steady", "steady-dict"])
def test_engagement_rule(change, engages):
    case = dict(ENGAGES, **change)
    solver = case["cls"](steprule=pt.odetools.step.Constant(0.01), **case["kwargs"])
    assert white.graph_engages(solver, case["d"], case["dtype"], case["device"]) is engages


def _spruce_budworm(device="cpu"):
    return pt.pde.examples.spruce_budworm_1d_discretized(device=device, dx=0.1, tmax=0.03)


@pytest.mark.parametrize("cls, kwargs, problem", [
    (pt.LinearWhiteNoiseEK1, dict(factorization="householder"), None),
    (pt.LinearWhiteNoiseEK1, dict(factorization="householder", fused=False), None),
    (pt.LinearWhiteNoiseEK1, dict(factorization=None), None),
    (pt.LinearWhiteNoiseEK1, dict(factorization="householder", steady_state=True), None),
    (pt.SemiLinearWhiteNoiseEK1, dict(factorization="householder"), _spruce_budworm),
], ids=["householder", "two-qr", "plain-qr", "steady", "semilinear"])
def test_solves_on_the_cpu_stay_op_by_op(cls, kwargs, problem):
    before = (white.white_attempt_step.graph_captures, white.white_attempt_step.graph_replays)
    solver = cls(steprule=pt.odetools.step.Constant(0.01), **kwargs)
    sol = solver.solve(problem() if problem else _heat(0.1, 0.03))
    assert torch.isfinite(sol.mean).all()
    assert not isinstance(solver._step_function(None), white.GraphedWhiteAttempt)
    assert (white.white_attempt_step.graph_captures,
            white.white_attempt_step.graph_replays) == before


def test_latent_solver_stays_op_by_op():
    before = white.white_attempt_step.graph_replays
    solver = pt.latent.LinearLatentForceEK1(steprule=pt.odetools.step.Constant(0.01),
                                            factorization="householder")
    solver.solve(_heat(0.1, 0.03))
    assert not isinstance(solver._step_function(None), white.GraphedWhiteAttempt)
    assert white.white_attempt_step.graph_replays == before


# --- the scales from a device scalar -----------------------------------------


def _adaptive_dts():
    return np.concatenate((np.geomspace(1e-7, 0.5, 37),
                           np.random.default_rng(5).uniform(1e-5, 2e-2, 40)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("num_derivatives", [1, 2, 4])
def test_scales_from_a_device_dt_equal_the_float_dt_scales(num_derivatives, dtype):
    _, const_dts = pdefilter.constant_step_schedule(0.0, 0.1005, 1e-3)
    dts = np.concatenate((const_dts, _adaptive_dts()))
    assert const_dts[-1] != const_dts[0]  # the schedule's last step differs
    buffer = torch.zeros((), dtype=dtype)
    for dt in dts.tolist():
        want = iwp.nordsieck_scales_1d(num_derivatives, dt, dtype=dtype, device="cpu")
        buffer.fill_(dt)
        got = iwp.nordsieck_scales_1d(num_derivatives, buffer, dtype=dtype, device="cpu")
        for a, b in zip(got, want):
            assert a.dtype == dtype and torch.equal(a, b), dt


def test_scale_constants_are_made_once():
    dt = torch.tensor(1e-3, dtype=torch.float64)
    first = iwp._scale_constants(3, torch.float64, torch.device("cpu"))
    iwp.nordsieck_scales_1d(3, dt, dtype=torch.float64, device="cpu")
    assert iwp._scale_constants(3, torch.float64, torch.device("cpu")) is first


# --- the deferring step ---------------------------------------------------------


def _eager_step(heat):
    """The op-by-op step of a Householder solver on ``heat`` and its initial
    state."""
    solver = pt.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.01),
                                    factorization="householder")
    state = solver.initialize(heat)
    return solver._step_fn, state.y.mean, state.y.cov_sqrtm


def _deferring(step, mean, cov, dt, failed, **kwargs):
    """``step`` with ``dt`` as a 0-dim tensor and the failure code ``failed``."""
    return step.func(*step.args, mean, cov, dt, mean.new_tensor(dt), failed=failed,
                     **step.keywords, **kwargs)


def test_the_deferring_step_gives_the_eager_step_bit_for_bit_and_reads_nothing():
    step, mean, cov = _eager_step(_heat(0.05, 0.05))
    failed = torch.zeros((), dtype=torch.int32)
    for dt in (0.01, 3.7e-3):
        eager = step(mean, cov, dt, dt)
        deferred = _deferring(step, mean, cov, dt, failed)
        assert all(torch.equal(a, b) for a, b in zip(deferred, eager))
        buffer = cov.clone()  # in place: the factor written over its input
        in_place = _deferring(step, mean, buffer, dt, failed, in_place=True)
        assert in_place[1] is buffer
        assert all(torch.equal(a, b) for a, b in zip(in_place, eager))
        mean, cov = eager[:2]
    assert int(failed) == 0


def test_the_deferring_step_keeps_the_first_failure_and_gives_no_mean():
    step, mean, cov = _eager_step(_failing_heat(0.05))
    with pytest.raises(torch.linalg.LinAlgError) as info:
        step(mean, cov, 0.01, 0.01)
    order = int(str(info.value).split("order ")[1].split(" ")[0])
    failed = torch.zeros((), dtype=torch.int32)
    out = _deferring(step, mean, cov, 0.01, failed)
    assert int(failed) == order > 0 and torch.isnan(out[0]).all() and torch.isnan(out[3]).all()
    # a sound attempt after it keeps the code, and its mean too is none
    step, mean, cov = _eager_step(_heat(0.05, 0.05))
    failed.fill_(order + 5)
    out, eager = _deferring(step, mean, cov, 0.01, failed), step(mean, cov, 0.01, 0.01)
    assert int(failed) == order + 5 and torch.isnan(out[0]).all()
    assert all(torch.equal(a, b) for a, b in zip(out[1:3], eager[1:3]))


# --- the graphed attempt, replayed op by op, and the deferred failure ----------


@pytest.mark.parametrize("rule", [pt.odetools.step.Constant(0.01), pt.odetools.step.Adaptive()],
                         ids=["constant", "adaptive"])
def test_deferred_step_gives_the_eager_solution_bit_for_bit(rule, monkeypatch):
    heat = _heat(0.025, 0.05)
    eager = pt.LinearWhiteNoiseEK1(steprule=rule, factorization="householder").solve(heat)
    _force(monkeypatch)
    captures = white.white_attempt_step.graph_captures
    solver = pt.LinearWhiteNoiseEK1(steprule=rule, factorization="householder")
    for _ in range(2):  # the second initialize loads its cache into the first one's buffers
        sol = solver.solve(heat)
        assert white.white_attempt_step.graph_captures - captures == 1
        assert isinstance(solver._step_function(heat), white.GraphedWhiteAttempt)
        assert sol.info == eager.info
        for name in ("t", "mean", "cov_sqrtm", "diffusion_squared_calibrated"):
            assert torch.equal(getattr(sol, name), getattr(eager, name)), name
    graphed = solver._graphed
    assert solver._cache is graphed.cache and solver.iwp.process_noise_factor is graphed.cache.Ql


def test_a_later_initialize_keeps_one_cache_and_another_problem_takes_another(forced):
    heat = _heat(0.05, 0.02)
    solver = pt.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.01),
                                    factorization="householder")
    solver.solve(heat)
    graphed, buffers = solver._graphed, [x.data_ptr() for x in solver._graphed.cache]
    solver.solve(heat)
    assert solver._graphed is graphed
    assert [x.data_ptr() for x in solver._cache] == buffers
    solver.solve(_heat(0.05, 0.02))  # the same shapes, another problem's L and B
    assert solver._graphed is not graphed


def _failing_heat(tmax):
    """A heat problem whose boundary rows measure nothing, exactly: the
    innovation covariance S has zero rows, so its Cholesky factor fails."""
    heat = _heat(0.05, tmax)
    heat.B.zero_()
    heat.R_sqrtm.zero_()
    return heat


def _raised(fn):
    with pytest.raises(torch.linalg.LinAlgError) as info:
        fn()
    return str(info.value), [frame.name for frame in traceback.extract_tb(info.tb)]


@pytest.mark.parametrize("rule, deferred_to", [
    (pt.odetools.step.Constant(0.01), "raise_deferred_failure"),
    (pt.odetools.step.Adaptive(), "_read_accepted"),
], ids=["solve-constant", "solve-adaptive"])
def test_a_failed_cholesky_raises_the_same_error_at_the_deferred_read(rule, deferred_to,
                                                                       monkeypatch):
    def solve():
        pt.LinearWhiteNoiseEK1(steprule=rule, factorization="householder").solve(
            _failing_heat(0.05))

    eager, eager_frames = _raised(solve)
    assert "white_attempt_step" in eager_frames
    _force(monkeypatch)
    deferred, frames = _raised(solve)
    assert deferred == eager and "not positive-definite" in deferred
    assert deferred_to in frames and "white_attempt_step" not in frames


def test_a_failed_cholesky_raises_from_simulate_final_state_and_the_generator(forced):
    solver = pt.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.01),
                                    factorization="householder")
    message, _ = _raised(lambda: solver.simulate_final_state(_failing_heat(0.05)))
    gen = solver.solution_generator(_failing_heat(0.05))
    states = []
    with pytest.raises(torch.linalg.LinAlgError, match="leading minor") as info:
        for state, _ in gen:  # every step is yielded; the failure raises at the end
            states.append(state)
    assert str(info.value) == message and len(states) == 6
    assert all(torch.isnan(state.y.mean).all() for state in states[1:])


def test_a_generator_left_early_raises_the_failure_where_it_is_closed(forced):
    solver = pt.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.01),
                                    factorization="householder")
    gen = solver.solution_generator(_failing_heat(1.0))
    states = [state for (state, _), _ in zip(gen, range(4))]
    assert all(torch.isnan(state.y.mean).all() for state in states[1:])
    with pytest.raises(torch.linalg.LinAlgError, match="leading minor"):
        gen.close()
    with pytest.raises(torch.linalg.LinAlgError, match="leading minor"):
        with contextlib.closing(solver.solution_generator(_failing_heat(1.0))) as gen:
            for (state, _), k in zip(gen, range(3)):
                pass
    # a sound generator closed early reads the code and raises nothing
    with contextlib.closing(solver.solution_generator(_heat(0.05, 1.0))) as gen:
        next(gen), next(gen)
    assert not solver._graphed.unread


def test_solve_resilient_raises_a_deferred_failure_before_its_checkpoint(forced, tmp_path):
    solver = pt.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.01),
                                    factorization="householder")
    with pytest.raises(torch.linalg.LinAlgError, match="leading minor"):
        pt.utils.resilience.solve_resilient(solver, _failing_heat(0.05),
                                            checkpoint_dir=tmp_path, checkpoint_every=1)
    state, _ = pt.utils.checkpoint.load_state(tmp_path / "latest", device="cpu")
    assert state.t == 0.0 and torch.isfinite(state.y.mean).all()


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: the capture runs
    the body once, a replay does nothing."""

    replays = 0

    def capture_begin(self):
        pass

    def capture_end(self):
        pass

    def replay(self):
        _FakeGraph.replays += 1


def test_capture_counts_nothing_and_each_replay_counts_its_launches(monkeypatch):
    """The bookkeeping of :class:`white.GraphedWhiteAttempt` around a capture
    and its replays, with a stand-in graph; the plain panel counts its calls
    as the kernel counts its launches."""
    reference = tq.panel_lq_reference

    def counted(slab, off):
        tq.panel_lq.launches += 1
        return reference(slab, off)

    monkeypatch.setattr(tq, "panel_lq_reference", counted)
    # the counters go back to their values after the test: other tests read them
    monkeypatch.setattr(tq.panel_lq, "launches", tq.panel_lq.launches)
    for name in ("graph_captures", "graph_replays"):
        monkeypatch.setattr(white.white_attempt_step, name, getattr(white.white_attempt_step, name))
    _force(monkeypatch, _FakeGraph)
    counts = white.white_attempt_step
    captures, replays = counts.graph_captures, counts.graph_replays
    gen = pt.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.01),
                                 factorization="householder").solution_generator(_heat(0.025, 1.0))
    state, _ = next(gen)
    graphed = gen.gi_frame.f_locals["self"]._step_fn
    launches, fake = tq.panel_lq.launches, _FakeGraph.replays
    for k in range(1, 4):
        new, _ = next(gen)
        assert tq.panel_lq.launches - launches == 2 * k  # 166 pre-array rows: two blocks
        assert _FakeGraph.replays - fake == k
        assert new.y.cov_sqrtm.data_ptr() != graphed.outputs[1].data_ptr()
    assert graphed.launches[0] == (tq.panel_lq, 2)
    assert (counts.graph_captures - captures, counts.graph_replays - replays) == (1, 3)


def test_a_sound_solve_reads_no_failure(forced):
    solver = pt.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Adaptive(),
                                    factorization="householder")
    solver.solve(_heat(0.05, 0.05))
    graphed = solver._graphed
    assert int(graphed.failed) == 0 and not graphed.unread


# --- on the card ----------------------------------------------------------------

N512_DX = 1.0 / 511


def _n512(device, tmax):
    """The benchmark's N=512 configuration (``benchmark/configs/heat1d-fd-n512.json``)."""
    return pt.pde.examples.heat_1d_discretized(
        dx=N512_DX, tmax=tmax, diffusion_rate=0.05, bcond="dirichlet",
        kernel=pt.kernels.SquareExponential(input_scale=0.1 / N512_DX),
        stencil_size_interior=3, stencil_size_boundary=3, nugget_gram_matrix_fd=0.0,
        device=device)


def _n512_solver(rule):
    return pt.LinearWhiteNoiseEK1(steprule=rule, num_derivatives=2,
                                  spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
                                  factorization="householder")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _states(solver, heat, steps):
    gen = solver.solution_generator(heat)
    return [state for (state, _), _ in zip(gen, range(steps + 1))]


@pytest.mark.cuda
def test_graph_gives_the_eager_states_bit_for_bit_over_20_constant_steps(cuda, monkeypatch):
    heat = _n512(cuda, 1.0)
    rule = pt.odetools.step.Constant(1e-3)
    graphed = _states(_n512_solver(rule), heat, 20)
    monkeypatch.setattr(white, "graph_engages", lambda *args: False)
    eager = _states(_n512_solver(rule), heat, 20)
    for a, b in zip(graphed, eager):
        assert a.t == b.t
        for x, y in ((a.y.mean, b.y.mean), (a.y.cov_sqrtm, b.y.cov_sqrtm),
                     (a.diffusion_squared_local, b.diffusion_squared_local)):
            assert torch.equal(x, y)
        if b.error_estimate is not None:
            assert torch.equal(a.error_estimate, b.error_estimate)
            assert torch.equal(a.reference_state, b.reference_state)


@pytest.mark.cuda
def test_graph_gives_the_eager_adaptive_solve_bit_for_bit(cuda, monkeypatch):
    heat = _n512(cuda, 0.1)
    solver = _n512_solver(pt.odetools.step.Adaptive())
    graphed = solver.solve(heat)
    assert isinstance(solver._step_fn, white.GraphedWhiteAttempt)
    monkeypatch.setattr(white, "graph_engages", lambda *args: False)
    eager = _n512_solver(pt.odetools.step.Adaptive()).solve(heat)
    assert graphed.info == eager.info
    assert eager.info["num_attempted_steps"] > eager.info["num_steps"]  # rejections happened
    for name in ("t", "mean", "cov_sqrtm", "diffusion_squared_calibrated"):
        assert torch.equal(getattr(graphed, name), getattr(eager, name)), name


@pytest.mark.cuda
def test_one_capture_across_three_initializes_and_17_launches_a_replay(cuda):
    heat = _n512(cuda, 0.1)
    solver = _n512_solver(pt.odetools.step.Constant(1e-3))
    counts = white.white_attempt_step
    captures, replays = counts.graph_captures, counts.graph_replays
    for k in range(3):
        gen = solver.solution_generator(heat)
        next(gen)
        for _ in range(4):
            before = tq.panel_lq.launches
            next(gen)
            assert tq.panel_lq.launches - before == 17
    assert counts.graph_captures - captures == 1
    assert counts.graph_replays - replays == 12


@pytest.mark.cuda
def test_a_yielded_state_is_not_written_by_later_replays(cuda):
    heat = _n512(cuda, 1.0)
    gen = _n512_solver(pt.odetools.step.Constant(1e-3)).solution_generator(heat)
    next(gen)
    state, _ = next(gen)
    kept = [x.clone() for x in (state.y.mean, state.y.cov_sqrtm, state.error_estimate,
                                state.reference_state, state.diffusion_squared_local)]
    for _ in range(5):
        later, _ = next(gen)
    assert not torch.equal(later.y.mean, kept[0])
    now = (state.y.mean, state.y.cov_sqrtm, state.error_estimate, state.reference_state,
           state.diffusion_squared_local)
    assert all(torch.equal(a, b) for a, b in zip(now, kept))


_PEAK = """
import sys, torch
import pnmol_tpu_torch as pt
from pnmol_tpu_torch.solvers import white
sys.path.insert(0, "tests")
import test_torch_graph as t
if sys.argv[1] == "eager":
    white.graph_engages = lambda *args: False
gen = t._n512_solver(pt.odetools.step.Constant(1e-3)).solution_generator(t._n512("cuda", 1.0))
for _ in range(6):
    next(gen)
torch.cuda.synchronize()
print(torch.cuda.max_memory_allocated())
"""


@pytest.mark.cuda
def test_graph_peak_memory_within_one_percent_of_eager(cuda):
    """Each in a fresh process, as the benchmark measures it: the graph's
    pool holds the capture stream's cuBLAS workspace, and its factor buffer
    is the step's input and output."""
    peaks = {}
    for mode in ("eager", "graphed"):
        proc = subprocess.run([sys.executable, "-c", _PEAK, mode], capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        peaks[mode] = int(proc.stdout.split()[-1])
    print(peaks)
    assert peaks["graphed"] <= 1.01 * peaks["eager"]
