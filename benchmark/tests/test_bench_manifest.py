"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
against the files the harness finds by name."""

import json
import re

import pytest

from conftest import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = MANIFEST["workloads"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["paths"] == ["benchmark"]


def test_names_and_units():
    names = [m["name"] for m in METRICS] + [c["name"] for c in CELLS]
    names += [c["name"] for c in MANIFEST["configs"]]
    names += [c["traffic"] for c in CELLS] + [k for c in MANIFEST["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for group in (METRICS, CELLS, MANIFEST["configs"]):
        assert len({x["name"] for x in group}) == len(group)


def test_each_cell_has_its_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for cell in CELLS:
        assert (ROOT / configs[cell["config"]]["file"]).is_file()
        assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
        assert (BENCH / "workloads" / f"{cell['name']}.json").is_file()
    assert {c["config"] for c in CELLS} == set(configs)
    assert len({(c["config"], c["traffic"]) for c in CELLS}) == len(CELLS)


def test_each_configuration_and_mix_has_its_code():
    for entry in MANIFEST["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        assert (BENCH / "harness" / "checks" / f"{config['check']}.py").is_file()
    for name in {c["traffic"] for c in CELLS}:
        traffic = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
        assert (BENCH / "harness" / "modes" / f"{traffic['mode']}.py").is_file()


def test_each_metric_has_its_reader():
    for metric in METRICS:
        assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_moves_metric_is_reported_in_each_cell():
    end_to_end = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for metric in MANIFEST["per_layer"]:
        assert metric["moves"] in end_to_end
        for cell in (c["name"] for c in CELLS if _reports(metric, c["name"])):
            assert _reports(end_to_end[metric["moves"]], cell), (metric["name"], cell)


def test_every_cell_reports_enough():
    for cell in (c["name"] for c in CELLS):
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, cell) for m in MANIFEST["per_layer"])


def test_bounds():
    for metric in MANIFEST["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


def test_at_most_a_quarter_of_the_cells_on_four_chips():
    four = sum(c["chips"] == 4 for c in CELLS)
    assert all(c["chips"] in (1, 4) for c in CELLS)
    assert four <= max(1, len(CELLS) // 4)


def test_one_line_fields():
    for entry in CELLS + MANIFEST["configs"] + MANIFEST["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in entry:
                value = entry[key]
                assert 1 <= len(value) <= 200 and "\n" not in value and "\t" not in value


def test_layers_keep_one_spelling():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert len({layer.lower() for layer in layers}) == len(layers)


@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_each_cell_has_limits(cell):
    settings = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    assert settings["limits"], "a cell without limits is never correct"
