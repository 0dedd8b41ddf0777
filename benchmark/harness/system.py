"""The system under test, ``pnmol_tpu_torch``, as the harness drives it.

Everything here goes through the port's public constructors: the problem
recipe, the kernels, the step rules and the solver class named in a
configuration file. The port keeps its state in the point-major layout
(``x[j n + i]`` is derivative ``i`` at point ``j``); :class:`Layout` maps
that to the derivative-major layout of the reference.
"""

import torch

COUNTERS = {"panel_lq": ("ops", "qr_householder", "panel_lq"),
            "leaf_lq": ("ops", "qr_householder", "leaf_lq"),
            "leaf_qr": ("ops", "qr_householder", "leaf_qr"),
            "gram_radial": ("ops", "gram", "gram_radial")}


def import_port(dtype):
    """Import the port and set its precision policy to ``dtype``
    (``"float64"`` or ``"float32"``)."""
    import pnmol_tpu_torch as pt

    pt.config.enable_x64(dtype == "float64")
    return pt


def spacing(problem):
    """Grid spacing along the first axis."""
    (lo, hi), n = problem["bbox"][0], problem["num_points"][0]
    return (hi - lo) / (n - 1)


def build_problem(pt, problem, y0, tmax, device):
    """The configuration's recipe of ``pnmol_tpu_torch.pde.examples``,
    discretized on ``device``, starting from the values ``y0`` at the grid
    points. The recipe takes the grid (``dx`` in 1-D, ``num_points``
    otherwise), the FD kernel where one is named, and ``recipe_kwargs``
    passed through unchanged."""
    values = torch.as_tensor(y0)

    def y0_fun(points):
        return values.to(dtype=points.dtype, device=points.device)[:, None]

    kwargs = dict(problem.get("recipe_kwargs", {}), device=device, tmax=tmax, y0_fun=y0_fun)
    if "fd_kernel" in problem:
        kwargs["kernel"] = getattr(pt.kernels, problem["fd_kernel"])(
            input_scale=problem["fd_input_scale_times_dx"] / spacing(problem))
    if len(problem["num_points"]) == 1:
        kwargs.update(bbox=problem["bbox"][0], dx=spacing(problem))
    else:
        kwargs.update(bbox=problem["bbox"], num_points=tuple(problem["num_points"]))
    return getattr(pt.pde.examples, problem["recipe"])(**kwargs)


def steprule(pt, rule):
    """The traffic mix's step rule: ``{"kind": "Constant", "dt": ...}`` or
    ``{"kind": "Adaptive", ...}`` with the rule's own fields."""
    fields = {k: v for k, v in rule.items() if k != "kind"}
    return getattr(pt.odetools.step, rule["kind"])(**fields)


def build_solver(pt, solver, rule):
    """The configuration's solver class with the traffic mix's step rule,
    the prior's kernels summed, and ``solver_kwargs`` passed through
    unchanged."""
    prior = None
    for name in solver["prior"]:
        kernel = getattr(pt.kernels, name)()
        prior = kernel if prior is None else prior + kernel
    return getattr(pt, solver["class"])(
        steprule=steprule(pt, rule), num_derivatives=solver["num_derivatives"],
        spatial_kernel=prior, **solver.get("solver_kwargs", {}))


def counters(pt):
    """The port's launch counters that exist, by kernel route."""
    out = {}
    for name, path in COUNTERS.items():
        obj = pt
        for part in path:
            obj = getattr(obj, part, None)
        if obj is not None and hasattr(obj, "launches"):
            out[name] = obj.launches
    return out


class Layout:
    """Maps the port's point-major state rows to the reference's
    derivative-major ones, and sketches a covariance factor's Gram."""

    def __init__(self, n, d, device):
        q = torch.arange(n * d, device=device)
        self.n, self.d = n, d
        self.perm = (q % n) * d + q // n  # point-major row -> derivative-major row
        self.inv = torch.argsort(self.perm)

    def factor(self, cov):
        """The factor's rows in the derivative-major order."""
        return cov[self.inv]

    def prepare(self, probe, scale):
        """The probe for :meth:`sketch`: ``scale`` (D,) applied and the rows
        moved to the point-major order."""
        return (scale[:, None] * probe)[self.perm]

    def sketch(self, cov, prepared, scale):
        """``S C C^T S probe`` in the derivative-major order, float64, with
        ``prepared = prepare(probe, scale)``: two thin products, no (D, D)
        temporary beyond a float64 copy of a float32 factor."""
        cov = cov.to(torch.float64)
        return scale[:, None] * (cov @ (cov.T @ prepared))[self.inv]
