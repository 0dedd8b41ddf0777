"""One run of one cell: set-up, the measured window, the check, the metrics.

The traffic mix's ``mode`` names what the window drives through
``solution_generator`` of the configured solver: the module
``harness/modes/<mode>.py``, whose ``drive(run)`` sets up, opens
``run.window()`` and fills ``run.program`` with what the check compares
(see :mod:`harness.modes`).

Each accepted step's completion is marked by a CUDA event on the stream,
read after the window. Nothing in the window synchronizes the host beyond
what the program does itself, save the copy of each whole solve's summary
at its end in the ``solves`` mode, whose program synchronizes every attempt.
"""

import contextlib
import gc
import importlib
import time
import types

import torch

import roofline
from harness import compare, faults, inputs, manifest, system, trace as tracing
from reference import discretization as rd


class Marks:
    """Completion marks of the window's steps: CUDA events on the card, the
    host clock on the CPU (where the tests drive the harness)."""

    def __init__(self, cuda):
        self.cuda = cuda
        self.marks = []

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        """Milliseconds from each mark to the next (after synchronizing)."""
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _host(summary):
    """A state summary with its tensors on the host, in float64."""
    return {"t": summary["t"], "mean": summary["mean"].double().cpu(),
            "sketch": summary["sketch"].cpu(), "diffusion": float(summary["diffusion"])}


class _Run:
    """The state of one run, filled as it goes: what the program produced
    (``program``, checked after the window) and the timings the readers take."""

    def __init__(self, cell, seed, seconds, trace, dtype, device, t_start):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.t_start = t_start
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.pt = system.import_port(dtype or cell.config["dtype"])
        problem = cell.config["problem"]
        points = rd.grid(problem["bbox"], problem["num_points"])
        y0 = inputs.initial_values(points, problem["bbox"], cell.traffic["initial"], seed)
        self.sync()
        t0 = time.perf_counter()
        self.pde = system.build_problem(self.pt, problem, y0, cell.traffic["tmax"], self.dev)
        self.sync()
        self.discretize_s = time.perf_counter() - t0
        self.solver = system.build_solver(self.pt, cell.config["solver"],
                                          cell.traffic["steprule"])
        nu = cell.config["solver"]["num_derivatives"]
        d = self.pde.L.shape[0]
        self.dims = dict(d=d, m=d + self.pde.B.shape[0], n=nu + 1,
                         itemsize=self.pde.L.element_size())
        self.layout = self.prepared = self.scale = None  # from the first state
        self.program = {"y0": y0}
        self.marks = Marks(self.cuda)
        self.holder = types.SimpleNamespace(trace=None)
        self.init_s = self.setup_s = self.window_s = None
        self.steps = self.attempts = self.inits = 0
        self.before = self.after = {}
        self.finite = True

    span = staticmethod(torch.profiler.record_function)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _read_layout(self, mean):
        """The layout, the check's probe and scaling, from a state's mean
        ``(n, d')``: the rows of the state, whatever the solver stacks in it."""
        n, d = mean.shape
        settings = self.cell.settings
        self.layout = system.Layout(n, d, self.dev)
        probe = inputs.probe(n * d, settings["probe_columns"], self.seed, self.dev)
        self.scale = compare.scaling(n - 1, settings["probe_dt"], d, self.dev)
        self.prepared = self.layout.prepare(probe, self.scale)
        self.program.update(probe=probe.cpu(), layout_inv=self.layout.inv.cpu())

    def summary(self, state, diffusion=None):
        """What the check compares of a state; its tensors stay on the device."""
        return {"t": state.t, "mean": state.y.mean,
                "sketch": self.layout.sketch(state.y.cov_sqrtm, self.prepared, self.scale),
                "diffusion": state.diffusion_squared_local if diffusion is None else diffusion}

    def initialize(self):
        """The generator of a first solve, past its initialization (timed)."""
        gen = self.solver.solution_generator(self.pde)
        self.sync()
        t0 = time.perf_counter()
        state, _ = next(gen)
        self.sync()
        self.init_s = time.perf_counter() - t0
        if self.layout is None:
            self._read_layout(state.y.mean)
        return gen, state

    def to_host(self, summary):
        """``summary`` with its tensors copied to the host; the host waits for
        them (the summary's two thin products): what the run keeps adds
        nothing to the device's peak."""
        return {k: v.cpu() if torch.is_tensor(v) else v for k, v in summary.items()}

    def pinned_like(self, summary):
        """Host buffers (pinned on the card) for a summary like ``summary``,
        made before the window, so that the window allocates none."""
        return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=self.cuda)
                if torch.is_tensor(v) else v for k, v in summary.items()}

    @staticmethod
    def copy_into(buffers, summary):
        """``summary`` into :meth:`pinned_like`'s ``buffers``, without waiting
        (read them after the window has drained)."""
        for k, v in summary.items():
            if torch.is_tensor(v):
                buffers[k].copy_(v, non_blocking=True)
            else:
                buffers[k] = v

    @contextlib.contextmanager
    def window(self):
        """Set-up ends, the window runs (traced if asked), the device drains."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        self.before = system.counters(self.pt)
        with tracing.profiled(self.trace) as self.holder:
            with self.span(tracing.WINDOW_SPAN):
                self.marks.mark()
                t0 = time.perf_counter()
                yield t0
                self.sync()
                self.window_s = time.perf_counter() - t0
        self.after = system.counters(self.pt)

    def outputs_to_host(self):
        """Move the program's outputs to the host and free its state."""
        self.sync()  # the copies that :meth:`copy_into` left running
        program, pde = self.program, self.pde
        if "init" in program:
            program["init"] = _host(program["init"])
        if "chain" in program:
            program["chain"] = [_host(s) for s in program["chain"]]
        if "window" in program:
            program["window"]["output"] = _host(program["window"]["output"])
        if "solves" in program:
            program["solves"] = [dict(s, final=_host(s["final"])) for s in program["solves"]]
        program.update(points=pde.mesh_spatial.points.double().cpu().numpy(),
                       L=pde.L.double().cpu(), E_sqrtm=pde.E_sqrtm.double().cpu(),
                       B=pde.B.double().cpu(), R_sqrtm=pde.R_sqrtm.double().cpu())
        del self.pde, self.solver, self.prepared
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def run(cell, seed, seconds, *, trace=False, dtype=None, fault=None, device="cuda",
        t_start=None):
    """Run ``cell`` (a :class:`harness.manifest.Cell`) once, with the program
    in ``dtype`` (the configuration's by default) and the planted ``fault``
    (:mod:`harness.faults`; none by default). Returns ``(result, checks)``:
    the result line's fields and the check's table. Where the program
    raises, what it produced until then is still checked and the result says
    so (``failure``); it is never correct."""
    t_start = time.perf_counter() if t_start is None else t_start
    failure = None
    with faults.planted(fault):
        r = _Run(cell, seed, seconds, trace, dtype, device, t_start)
        try:
            importlib.import_module(f"harness.modes.{cell.traffic['mode']}").drive(r)
        except RuntimeError as exc:  # torch's linear-algebra errors among them
            failure = f"{type(exc).__name__}: {exc}"
    peak = torch.cuda.max_memory_allocated(r.dev) if r.cuda else None
    r.outputs_to_host()
    nums = compare.check(cell, r.program, seed, r.dev)
    correct, table = compare.verdict(nums, cell.settings.get("limits", {}))

    ctx = types.SimpleNamespace(
        cell=cell, config=cell.config, traffic=cell.traffic, trace=r.holder.trace,
        roofline=roofline, setup_s=r.setup_s, discretize_s=r.discretize_s, init_s=r.init_s,
        window_s=r.window_s, steps=r.steps, attempts=r.attempts, inits=r.inits,
        peak_bytes=peak,
        step_ms=r.marks.intervals_ms(), dims=r.dims,
        counters={k: v - r.before.get(k, 0) for k, v in r.after.items()})
    metrics = {}
    if failure is None:
        for metric in (cell.per_layer if trace else cell.end_to_end):
            value = manifest.reader(metric["name"])(ctx)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    ok = failure is None and r.finite
    result = {"correct": correct and ok, "attempted": r.steps,
              "failed": 0 if ok else max(r.steps, 1), "metrics": metrics,
              "memory_peak_bytes": peak, "failure": failure}
    if r.holder.trace is not None:
        result["busy_s"] = r.holder.trace.busy_s
        result["trace_window_s"] = r.holder.trace.window_s
        result["breakdown"] = {"device_ops": r.holder.trace.device_ops(),
                               "idle_gaps": r.holder.trace.idle_gaps()}
    return result, table
