"""Finds a cell's files by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration and
traffic mix. A configuration is ``configs/<config>.json`` (the path its entry
gives), a traffic mix ``traffic/<traffic>.json``, a cell's own settings (what
its check compares and the limits) ``workloads/<cell>.json``, and a metric's
reader ``metrics/<metric>.py``, each under the benchmark's folder.
"""

import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def read_json(path):
    return json.loads(pathlib.Path(path).read_text())


def manifest():
    return read_json(ROOT / "BENCHMARK.json")


class Cell:
    """One cell: its ``BENCHMARK.json`` entry, configuration, traffic mix,
    own settings (``settings``), and the metrics it reports."""

    def __init__(self, name, *, entry, config, traffic, settings, end_to_end, per_layer):
        self.name, self.entry, self.config = name, entry, config
        self.traffic, self.settings = traffic, settings
        self.end_to_end, self.per_layer = end_to_end, per_layer

    @classmethod
    def load(cls, name, bench=None):
        """The cell ``name`` of ``BENCHMARK.json`` (or of the dict ``bench``)."""
        bench = bench if bench is not None else manifest()
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        entry = entries[name]
        config = {c["name"]: c for c in bench["configs"]}[entry["config"]]

        def reports(metric):
            return "workloads" not in metric or name in metric["workloads"]

        return cls(name, entry=entry, config=read_json(ROOT / config["file"]),
                   traffic=read_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
                   settings=read_json(BENCH / "workloads" / f"{name}.json"),
                   end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                   per_layer=[m for m in bench["per_layer"] if reports(m)])


def reader(metric_name):
    """The ``read(ctx)`` function of ``metrics/<metric_name>.py``."""
    path = BENCH / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric_name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
