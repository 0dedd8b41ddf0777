"""The port's spans: free while nothing records, and under ``torch.profiler``
one ``pnmol.step`` per attempt with the step's phases, its LQ sweeps and one
kernel span per block or leaf of the sweep's schedule nested inside it;
``pnmol.init.*`` and ``pnmol.discretize.*`` around set-up.

Small 1-D heat problems on the CPU, ``factorization="householder"`` (the
kernel routes' plain versions): 41 points at nu = 2 make a fused pre-array
of 166 rows, two blocks of the 128-row sweep.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pnmol_tpu_torch as pt
from pnmol_tpu_torch.ops import qr_householder as tq
from pnmol_tpu_torch.utils import profiling

torch.set_num_threads(1)

DX = 0.025  # 41 points
STEP_PHASES = ("pnmol.step.predict", "pnmol.step.error", "pnmol.step.factorize",
               "pnmol.step.update")
WHITE_INIT = ("pnmol.init.prior_gram_cholesky_y0", "pnmol.init.measure_assembly",
              "pnmol.init.init_update_qr", "pnmol.init.aux_Ql_Ebc")
DISCRETIZE = ("pnmol.discretize", "pnmol.discretize.neighbours", "pnmol.discretize.stencils",
              "pnmol.discretize.assemble")


def _heat(tmax, dx=DX):
    return pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=tmax, device="cpu", kernel=pt.kernels.SquareExponential(0.1 / dx))


def _spans(fn):
    """``fn()`` under the profiler, and its ``pnmol.`` spans as ``(name,
    start, end)`` in the order they started."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("pnmol.")]
    return out, sorted(spans, key=lambda s: s[1])


def _inside(spans, parent):
    """The spans inside each span named ``parent``, one list per parent."""
    return [[c for c in spans if c is not p and p[1] <= c[1] and c[2] <= p[2]]
            for p in spans if p[0] == parent]


def _names(spans, name):
    return [s for s in spans if s[0] == name]


def _schedule(rows, block, leaf=None):
    """Kernel launches and trailing updates of one sweep of ``rows`` rows."""
    sizes = [min(block, rows - done) for done in range(0, rows, block)]
    kernels = len(sizes) if leaf is None else sum(-(-b // leaf) for b in sizes)
    return kernels, len(sizes) - 1


def test_annotate_is_a_shared_null_context_when_off(monkeypatch):
    def recording(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    assert not torch.autograd._profiler_enabled()
    span = profiling.annotate("pnmol.step")
    assert span is profiling.annotate("pnmol.lq.sweep")
    assert isinstance(span, contextlib.nullcontext)
    with span, span:  # reusable and reentrant
        pass
    pt.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.01),
                           factorization="householder").simulate_final_state(_heat(0.03))


def test_annotate_records_when_on():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert not isinstance(profiling.annotate("pnmol.outer"), contextlib.nullcontext)
        with profiling.annotate("pnmol.outer"):
            with profiling.annotate("pnmol.inner"):
                torch.ones(4).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "pnmol.outer" in names and "pnmol.inner" in names


# (solver options, the step's LQ sweeps, the block route or leaves of 32 rows)
CASES = {
    "const-fused": (dict(steprule=pt.odetools.step.Constant(0.01)), 1, None),
    "adaptive-fused": (dict(), 1, None),
    "const-two-qr": (dict(steprule=pt.odetools.step.Constant(0.01), fused=False), 2, None),
    "const-leaf-route": (dict(steprule=pt.odetools.step.Constant(0.01)), 1, 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_step_span_per_attempt_with_its_schedule(monkeypatch, case):
    options, sweeps, leaf = CASES[case]
    if leaf is not None:
        monkeypatch.setattr(tq, "panel_takes_rows", lambda rows, itemsize: False)
    pde = _heat(0.05)
    solver = pt.LinearWhiteNoiseEK1(factorization="householder", **options)
    (_, info), spans = _spans(lambda: solver.simulate_final_state(pde))

    attempts = info["num_attempted_steps"]
    steps = _names(spans, "pnmol.step")
    assert attempts >= 5 and len(steps) == attempts
    assert (attempts > info["num_steps"]) == (case == "adaptive-fused")
    controls = len(_names(spans, "pnmol.step.control"))
    assert controls == (attempts if case == "adaptive-fused" else 0)

    d = pde.L.shape[0]
    D, m = 3 * d, d + pde.B.shape[0]
    if sweeps == 1:  # the fused pre-array: D + m rows
        kernels, trailing = _schedule(D + m, 128, leaf)
    else:  # the propagate's D rows, the update's m + D rows
        kernels, trailing = (a + b for a, b in zip(_schedule(D, 128), _schedule(m + D, 128)))
    kernel = "pnmol.kernel.panel_lq" if leaf is None else "pnmol.kernel.leaf_lq"
    assert kernels >= 2
    for inside in _inside(spans, "pnmol.step"):
        names = [c[0] for c in inside]
        assert all(names.count(phase) == 1 for phase in STEP_PHASES), names
        assert names.count("pnmol.lq.sweep") == sweeps
        assert names.count(kernel) == kernels
        assert names.count("pnmol.lq.trailing") == trailing
        assert all(n.startswith(("pnmol.step.", "pnmol.lq.", "pnmol.kernel."))
                   for n in names)
    # every sweep, trailing update and kernel of the attempts lies in their steps
    for inside in _inside(spans, "pnmol.step.factorize"):
        assert [c[0] for c in inside].count("pnmol.lq.sweep") == sweeps
    assert len(_names(spans, "pnmol.kernel.leaf_qr")) == 0


@pytest.mark.parametrize("name, options, expected", [
    ("white", dict(), WHITE_INIT),
    ("white-interleaved", dict(fused=False, propagate_band="interleaved"),
     WHITE_INIT + ("pnmol.init.interleave_retriangularize",)),
    ("white-steady", dict(steady_state=True), WHITE_INIT + ("pnmol.init.steady_riccati",)),
    ("latent", dict(), ("pnmol.init.prior_gram_cholesky_y0", "pnmol.init.measure_assembly",
                        "pnmol.init.init_update_qr", "pnmol.init.aux_Ql")),
])
def test_init_phases_are_spans_inside_init(name, options, expected):
    cls = pt.LinearLatentForceEK1 if name == "latent" else pt.LinearWhiteNoiseEK1
    solver = cls(steprule=pt.odetools.step.Constant(0.01), factorization="householder",
                 **options)
    pde = _heat(0.05, dx=0.1)
    _, spans = _spans(lambda: solver.initialize(pde))
    (inside,) = _inside(spans, "pnmol.init")
    phases = sorted({c[0] for c in inside if c[0].startswith("pnmol.init.")})
    assert phases == sorted(expected)
    assert not _names(spans, "pnmol.step")
    # the initialization update runs the Householder sweep
    assert any(c[0] == "pnmol.lq.sweep" for c in inside)


def test_discretize_phases_are_spans_inside_discretize():
    _, spans = _spans(lambda: _heat(0.05))
    assert sorted({s[0] for s in spans}) == sorted(DISCRETIZE)
    (inside,) = _inside(spans, "pnmol.discretize")
    assert sorted({c[0] for c in inside}) == sorted(DISCRETIZE[1:])
    assert [c[0] for c in inside].count("pnmol.discretize.stencils") == 1


def test_system_discretization_is_one_span():
    _, spans = _spans(lambda: pt.pde.examples.lotka_volterra_1d_discretized(
        dx=0.1, tmax=0.2, device="cpu"))
    assert len(_names(spans, "pnmol.discretize")) == 1
    (inside,) = _inside(spans, "pnmol.discretize")
    assert [c[0] for c in inside].count("pnmol.discretize.stencils") == 2  # two species


def test_leaf_qr_route_is_one_span_per_leaf():
    """The R-form sweep: one ``pnmol.kernel.leaf_qr`` per leaf slab."""
    A = torch.randn(70, 40, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    R, spans = _spans(lambda: tq.blocked_qr_r(A, leaf=8, block=16))
    assert len(_names(spans, "pnmol.kernel.leaf_qr")) == 5  # 40 columns of 8
    torch.testing.assert_close(R.T @ R, A.T @ A, rtol=0, atol=1e-10)
