"""Trajectory error against the Riccati convergence's quality.

Counterpart of ``experiments/steady_error_probe.py``. The steady-state
mode's mean-only step is exact for whatever factors it freezes; this
measures how much trajectory error a partly converged freeze leaves. The
same heat problem (``heat_1d_discretized(dx, tmax)``, its default FD
kernel) is solved with ``LinearWhiteNoiseEK1`` (``Constant(dt)``, nu = 2,
prior ``Matern52() + WhiteNoise()``)

  (a) with the full per-step QR (the exact recursion: the ground truth),
  (b) in steady state, unseeded, the recursion capped at each rung of an
      iteration ladder,
  (c) in steady state with the doubling (SDA) seed,

and each row reports the convergence delta, the DARE certificate, and the
largest mean deviation from (a), relative to the initial amplitude, over
the whole trajectory and over its tail (after the first quarter of the
steps: the frozen gain is the stationary one, so the transient differs by
design)::

    python -m pnmol_tpu_torch.experiments.steady_error_probe [--dx 0.02]
        [--dt 0.001] [--tmax 1.0] [--iters-ladder 5,10,25,50,100,200]
        [--device cuda|cpu] [--out DIR]

prints one JSON line a row and writes the JAX driver's record to
``<out>/steady_error_probe/``. The committed record
(``bench_artifacts/steady_error_probe.json``) is dx 0.02, dt 1e-4, tmax
0.3 and the ladder 1, 2, 3, 5, 10, 25, 100. On the card the solves take the
kernel route (``"householder"``).
"""

import argparse
import json

import torch

import pnmol_tpu_torch as pt
from pnmol_tpu_torch.experiments import common
from pnmol_tpu_torch.odetools import step as step_module

NOTE = ("rel_mean_err_* = max-abs mean deviation from the full per-step-QR solver, relative "
        "to the initial amplitude; tail excludes the by-design transient window")


def solve_mean(pde, dt, steady_state, factorization=None):
    """The solution means of every step, ``(steps + 1, d)``, and the solver."""
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=step_module.Constant(dt),
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
        steady_state=steady_state, factorization=factorization)
    u = torch.stack([state.y.mean[0] for state, _ in solver.solution_generator(pde)])
    if torch.isnan(u).any():
        raise FloatingPointError("NaN in the solution mean")
    return u, solver


def run(device="cuda", *, dx=0.02, dt=0.001, tmax=1.0, iters_ladder=(5, 10, 25, 50, 100, 200)):
    """The JAX driver's record: ``config``, ``note`` and one row a solve of
    (b) and (c)."""
    device = common.device_of(device)
    factorization = common.default_factorization(device)
    pde = pt.pde.examples.heat_1d_discretized(dx=dx, tmax=tmax, device=device)
    u_exact, _ = solve_mean(pde, dt, False, factorization)
    scale = u_exact[0].abs().max().item()
    num_steps = u_exact.shape[0]
    tail = slice(num_steps // 4, None)
    rows = []

    def add_row(label, u, solver):
        sc = solver.steady_cache
        residual = (solver.steady_diagnostics or {}).get("dare_residual")
        rows.append({
            "config": label,
            "riccati_iterations": int(sc.iterations),
            "delta": float(sc.delta),
            "dare_residual": None if residual is None else float(residual),
            "rel_mean_err_tail": (u[tail] - u_exact[tail]).abs().max().item() / scale,
            "rel_mean_err_full": (u - u_exact).abs().max().item() / scale,
        })
        print(json.dumps(rows[-1]), flush=True)

    for iters in iters_ladder:
        u, solver = solve_mean(pde, dt, {"seed": False, "max_iters": iters}, factorization)
        add_row(f"unseeded_cap{iters}", u, solver)
    u, solver = solve_mean(pde, dt, True, factorization)
    add_row("sda_seeded", u, solver)
    return {
        "config": {"dx": dx, "dt": dt, "tmax": tmax, "d": u_exact.shape[1],
                   "num_steps": num_steps, "platform": f"{device.type}-f64",
                   "device": common.device_name(device),
                   "tail_window": f"steps {num_steps // 4}..{num_steps}"},
        "note": NOTE,
        "rows": rows,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dx", type=float, default=0.02)
    p.add_argument("--dt", type=float, default=0.001)
    p.add_argument("--tmax", type=float, default=1.0)
    p.add_argument("--iters-ladder", default="5,10,25,50,100,200")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=common.ARTIFACT_ROOT, help="output root")
    args = p.parse_args(argv)
    record = run(args.device, dx=args.dx, dt=args.dt, tmax=args.tmax,
                 iters_ladder=[int(x) for x in args.iters_ladder.split(",")])
    path = common.write_artifact("steady_error_probe", record, args.out)
    print(json.dumps({"artifact": str(path)}))
    return record


if __name__ == "__main__":
    main()
