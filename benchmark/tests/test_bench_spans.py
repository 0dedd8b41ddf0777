"""The readers of the program's spans (``metrics/syncs_per_attempt``,
``sync_idle_pct``, ``step_issue_ms``) on a synthetic trace whose numbers
are known, on a trace without the program's spans, and in the harness's
traced run of each cell of ``BENCHMARK.json`` on the CPU at its small size."""

import types

import pytest

from conftest import cells, small_cell
from harness import manifest, runner

SPAN_METRICS = ("syncs_per_attempt", "sync_idle_pct", "step_issue_ms")

# two attempts in a 1 s window: each a pnmol.step with one sweep; sync calls
# in the first step outside its sweep, in both sweeps, in an initialization
# (a pnmol. span, not a step) and outside the program (the harness's drain)
HOST = [
    ("pnmol.step", 0.10, 0.30),
    ("pnmol.step.predict", 0.11, 0.145),
    ("cudaStreamSynchronize", 0.12, 0.14),
    ("cudaLaunchKernel", 0.13, 0.131),
    ("pnmol.lq.sweep", 0.15, 0.25),
    ("pnmol.kernel.panel_lq", 0.16, 0.17),
    ("aten::mm", 0.16, 0.18),
    ("cudaMemcpy", 0.20, 0.22),
    ("pnmol.step", 0.40, 0.60),
    ("pnmol.lq.sweep", 0.45, 0.55),
    ("cudaStreamSynchronize", 0.50, 0.53),
    ("pnmol.init", 0.61, 0.65),
    ("pnmol.lq.sweep", 0.615, 0.64),
    ("cudaEventSynchronize", 0.62, 0.63),
    ("harness.step", 0.69, 0.81),
    ("cudaDeviceSynchronize", 0.70, 0.80),
]
# idle stretches open at 0.13 (in a step's sync: 0.02 s), 0.21 (in a sweep's
# sync: 0.04 s), 0.41 (no sync), 0.52 (in a sweep's sync: 0.10 s), 0.625 (in
# the initialization's sync: 0.125 s), 0.78 (the harness's sync) and 1.0
DEVICE = [
    ("kernel_a", 0.0, 0.13),
    ("kernel_b", 0.15, 0.21),
    ("kernel_c", 0.25, 0.40),
    ("Memcpy HtoD", 0.35, 0.41),
    ("kernel_d", 0.45, 0.52),
    ("kernel_e", 0.62, 0.625),
    ("kernel_f", 0.75, 0.78),
]
EXPECTED = {
    "syncs_per_attempt": 3 / 2,  # 0.12, 0.20, 0.50
    "sync_idle_pct": 100.0 * (0.02 + 0.04 + 0.10 + 0.125) / 1.0,
    "step_issue_ms": 1e3 * (0.40 - (0.02 + 0.02 + 0.03)) / 2,
}


def _ctx(attempts=2, host=HOST, device=DEVICE, traced=True):
    trace = types.SimpleNamespace(host=list(host), device=list(device), window_s=1.0)
    return types.SimpleNamespace(trace=trace if traced else None, attempts=attempts)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_gives_the_exact_value(name):
    assert manifest.reader(name)(_ctx()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", SPAN_METRICS)
@pytest.mark.parametrize("attempts", [1, 3])
def test_reader_gives_nothing_when_the_steps_are_not_the_attempts(name, attempts):
    assert manifest.reader(name)(_ctx(attempts=attempts)) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_gives_nothing_without_the_program_spans_or_the_trace(name):
    parent = [event for event in HOST if not event[0].startswith("pnmol.")]
    assert manifest.reader(name)(_ctx(host=parent)) is None
    assert manifest.reader(name)(_ctx(traced=False)) is None
    assert manifest.reader(name)(_ctx(attempts=0, host=parent)) is None


@pytest.mark.parametrize("cell", cells())
def test_traced_run_on_the_cpu_reports_the_span_metrics(cell):
    """The program's spans in the harness's own trace: no CUDA runtime on
    the CPU, so no sync calls, and the issue times are whole steps."""
    small = small_cell(cell)
    result, _ = runner.run(small, 123456789012, 0.05, device="cpu", trace=True)
    assert result["correct"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    listed = {m["name"] for m in small.per_layer} & set(SPAN_METRICS)
    assert set(metrics) & set(SPAN_METRICS) == listed
    for name in {"syncs_per_attempt", "sync_idle_pct"} & listed:
        assert metrics[name] == 0.0
    if "step_issue_ms" in listed:
        assert metrics["step_issue_ms"] > 0.0
