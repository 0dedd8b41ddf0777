"""Long-horizon decay of the frozen-gain (steady-state) mean recursion.

Counterpart of ``experiments/steady_decay_probe.py``: seed a 1-D heat
solve (``heat_1d_discretized`` on ``n`` points with the dx-adapted FD
kernel ``SquareExponential(0.1/dx)``; ``LinearWhiteNoiseEK1``, nu = 1,
``Constant(dt)``, prior ``Matern52() + WhiteNoise()``, steady state on),
freeze the stationary factors, run ``steps`` mean-only steps, and record
the amplitude ratio beside the PDE's slowest Dirichlet mode. The JAX
driver's keys, in f64 on either device::

    python -m pnmol_tpu_torch.experiments.steady_decay_probe [--n 512]
        [--steps 2048] [--dt 0.01] [--device cuda|cpu] [--out DIR]

prints one JSON line and writes it to ``<out>/steady_decay_probe/``.

:func:`build` initializes (the SDA seed and the polish) and :func:`measure`
steps, so a caller holding an initialized solver (``chip_smoke.py`` at
N = 1e4) measures without a second seed. On the card the solver takes the
kernel route (``"householder"``), and from 4096 points the two-QR banded
pipeline, whose pre-arrays are a third of the fused one's.
"""

import argparse
import json
import math

import torch

import pnmol_tpu_torch as pt
from pnmol_tpu_torch.experiments import common
from pnmol_tpu_torch.odetools import step as step_module
from pnmol_tpu_torch.solvers import white

TWO_QR_MIN_POINTS = 4096
# u_t = 0.05 u_xx on [0, 1]: the slowest Dirichlet mode decays at 0.05 pi^2
DIFFUSION_RATE = 0.05


def solver_options(device, n):
    """The factorization and pipeline on ``device`` at ``n`` points."""
    options = dict(factorization=common.default_factorization(device))
    if torch.device(device).type == "cuda" and n >= TWO_QR_MIN_POINTS:
        options.update(fused=False, propagate_band="banded")
    return options


def build(device, n=512, dt=0.01):
    """``(solver, initial state)`` of the probe's configuration, initialized."""
    device = common.device_of(device)
    dx = 1.0 / (n - 1)
    heat = pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=1.0, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx),
        device=device)
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=step_module.Constant(dt), num_derivatives=1,
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(), steady_state=True,
        **solver_options(device, n))
    return solver, solver.initialize(heat)


def measure(solver, state, steps=2048, dt=0.01):
    """``steps`` mean-only steps of ``dt`` from ``state`` with the solver's
    frozen blocks; the JAX driver's record."""
    step = white.make_steady_state_white_step(
        cache=solver._cache, steady=solver.steady_cache,
        num_derivatives=solver.num_derivatives)
    mean, cov = state.y.mean, state.y.cov_sqrtm
    m0 = mean[0].abs().max().item()
    for k in range(1, steps + 1):
        mean, cov, *_ = step(mean, cov, k * dt, dt)
    mf = mean[0].abs().max().item()
    residual = (solver.steady_diagnostics or {}).get("dare_residual")
    return {
        "experiment": "steady_decay_probe",
        "device": common.device_name(mean.device),
        "dtype": "f64" if mean.dtype == torch.float64 else str(mean.dtype),
        "n": mean.shape[1], "steps": steps, "dt": dt,
        "absmax0": m0, "absmax_final": mf,
        "ratio": mf / m0,
        "per_step_factor": (mf / m0) ** (1.0 / steps),
        "slowest_mode_ratio": math.exp(-DIFFUSION_RATE * math.pi**2 * steps * dt),
        "riccati_iters": int(solver.steady_cache.iterations),
        "dare_residual": None if residual is None else float(residual),
    }


def run(device="cuda", *, n=512, steps=2048, dt=0.01):
    solver, state = build(device, n, dt)
    return measure(solver, state, steps, dt)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=512, help="mesh points")
    p.add_argument("--steps", type=int, default=2048, help="mean-only steps")
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=common.ARTIFACT_ROOT, help="output root")
    args = p.parse_args(argv)
    record = run(args.device, n=args.n, steps=args.steps, dt=args.dt)
    print(json.dumps(record), flush=True)
    common.write_artifact("steady_decay_probe", record, args.out)
    return record


if __name__ == "__main__":
    main()
