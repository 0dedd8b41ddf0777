"""The reader of ``metrics/replays_per_attempt``: the program's
``pnmol.step.replay`` spans inside its ``pnmol.step`` spans, per attempt, on
a synthetic trace; nothing without the program's spans or its graph
counter; and the harness's traced run of each cell on the CPU, where every
attempt runs op by op."""

import sys
import types

import pytest

from conftest import cells, small_cell
from harness import manifest, runner

HOST = [
    ("pnmol.step", 0.10, 0.30),
    ("pnmol.step.replay", 0.12, 0.14),
    ("cudaGraphLaunch", 0.125, 0.13),
    ("pnmol.step", 0.40, 0.60),
    ("pnmol.step.replay", 0.45, 0.47),
    ("pnmol.step", 0.70, 0.80),
    ("pnmol.step.predict", 0.71, 0.72),
    ("pnmol.step.replay", 0.85, 0.86),  # outside every step: not counted
]


def _ctx(attempts=3, host=HOST, traced=True):
    trace = types.SimpleNamespace(host=list(host), device=[], window_s=1.0)
    return types.SimpleNamespace(trace=trace if traced else None, attempts=attempts)


def _read(ctx):
    return manifest.reader("replays_per_attempt")(ctx)


def test_reader_counts_the_replays_inside_the_steps():
    import pnmol_tpu_torch  # noqa: F401  the program, with its graph counter

    assert _read(_ctx()) == pytest.approx(2 / 3, rel=1e-12)


def test_reader_gives_nothing_without_the_spans_the_attempts_or_the_counter(monkeypatch):
    import pnmol_tpu_torch  # noqa: F401

    assert _read(_ctx(traced=False)) is None
    assert _read(_ctx(attempts=2)) is None
    assert _read(_ctx(host=[e for e in HOST if not e[0].startswith("pnmol.")])) is None
    white = types.SimpleNamespace(white_attempt_step=lambda *args: None)  # a program without it
    monkeypatch.setitem(sys.modules, "pnmol_tpu_torch.solvers.white", white)
    assert _read(_ctx()) is None


@pytest.mark.parametrize("cell", [c for c in cells() if any(
    m["name"] == "replays_per_attempt" for m in manifest.Cell.load(c).per_layer)])
def test_traced_run_on_the_cpu_reads_no_replay(cell):
    result, _ = runner.run(small_cell(cell), 123456789013, 0.05, device="cpu", trace=True)
    assert result["correct"]
    assert result["metrics"]["replays_per_attempt"]["value"] == 0.0
