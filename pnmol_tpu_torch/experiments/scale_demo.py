"""Scale demonstration: the step loop at N = 1e4 and the latent N-ladder,
and the radial Gram kernel against its plain version.

Counterpart of ``experiments/scale_demo.py``, on either device, in the
package's precision policy: f64, or with ``PNMOL_TPU_X32=1`` f32 end to end
(mesh, FD assembly, prior, init and steps), as the JAX driver runs.
``step`` builds a problem (1-D heat with the dx-adapted FD kernel, 2-D heat
or 3-D advection-diffusion, the JAX driver's recipes), initializes the
white or latent solver, frees everything the step does not read, and runs
``--steps`` steps twice: the first call's seconds stand where the JAX
driver reports its compilation, the second call gives the steps/s. With
``--steady-state`` the steps are mean-only, with the frozen blocks. ``gram``
times the Matern52 Gram of seeded uniform 2-D points through the kernel of
``csrc/gram_radial.cu`` and through its plain version, in f64 and f32::

    python -m pnmol_tpu_torch.experiments.scale_demo step [--n 100] [--nu 1]
        [--dim 1|2|3] [--solver white|latent] [--steps 4] [--fused]
        [--propagate-band banded|interleaved] [--factorization householder|plain]
        [--steady-state [--steady-iters K] [--steady-tol T] [--steady-chunk C]
        [--steady-no-seed] [--steady-dtype float64]] [--dt 1e-3]
        [--device cuda|cpu] [--out DIR]
    python -m pnmol_tpu_torch.experiments.scale_demo gram [--n 10000]
        [--input-scale 5.0] [--device cuda|cpu] [--out DIR]

Each prints one JSON record (the JAX driver's keys, the device's name, and
on the card the peak memory) and writes it to ``<out>/scale_demo/``.
"""

import argparse
import functools
import json

import numpy as np
import torch

import pnmol_tpu_torch as pt
from pnmol_tpu_torch.experiments import common
from pnmol_tpu_torch.odetools import step as step_module
from pnmol_tpu_torch.ops import gram as gram_ops
from pnmol_tpu_torch.solvers import latent as latent_module
from pnmol_tpu_torch.solvers import white as white_module

DEMOS = {1: "heat1d_step", 2: "heat2d_step", 3: "advdiff3d_step"}


def make_problem(dim, n_side, device, tmax=1.0):
    """The JAX driver's problem on ``n_side`` points a side."""
    dx = 1.0 / (n_side - 1)
    if dim == 1:
        return pt.pde.examples.heat_1d_discretized(
            dx=dx, tmax=tmax, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx),
            device=device)
    if dim == 2:
        return pt.pde.examples.heat_2d_discretized(
            num_points=(n_side, n_side),
            kernel=pt.kernels.SquareExponential(input_scale=0.15 / dx),
            stencil_size_interior=5, stencil_size_boundary=5, nugget_gram_matrix_fd=1e-10,
            tmax=tmax, device=device)
    return pt.pde.examples.advection_diffusion_discretized(
        dim=3, num_points=(n_side,) * 3,
        kernel=pt.kernels.SquareExponential(input_scale=0.15 / dx),
        stencil_size_interior=7, stencil_size_boundary=7, nugget_gram_matrix_fd=1e-10,
        tmax=tmax, velocity=[1.0, 0.5, 0.25], diffusion_rate=0.05, device=device)


def steady_options(steady_state, iters=None, tol=None, chunk=None, seed=True, dtype=None):
    """The solver's ``steady_state`` argument from the command line's;
    ``dtype`` runs the Riccati recursion in that type (``"float64"`` on an
    f32 problem)."""
    if not steady_state:
        return False
    opts = {key: value for key, value in
            (("max_iters", iters), ("tol", tol), ("chunk_iters", chunk), ("dtype", dtype))
            if value is not None}
    if not seed:
        opts["seed"] = False
    return opts or True


def make_solver(solver_name, *, nu, dt, factorization, fused, propagate_band,
                steady_state=False):
    """The white or latent linear solver; ``factorization`` is
    ``"householder"`` (the kernel route) or ``"plain"`` (``torch.linalg.qr``)."""
    cls = pt.white.LinearWhiteNoiseEK1 if solver_name == "white" else pt.latent.LinearLatentForceEK1
    return cls(steprule=step_module.Constant(dt), num_derivatives=nu,
               spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
               factorization=None if factorization == "plain" else factorization,
               fused=fused, propagate_band=propagate_band, steady_state=steady_state)


def stepper(solver, solver_name, *, nu, fused, propagate_band, steady_state):
    """The step ``(mean, cov, t, dt) -> (mean, cov, ...)`` of the initialized
    ``solver``, holding only what it reads: the solver's cache, and in
    steady state the frozen blocks without the (D, D) stationary factor and
    Sl (the mean-only step reads L21, Sl^{-1} and err_vec)."""
    if steady_state:
        make = (white_module.make_steady_state_white_step if solver_name == "white"
                else latent_module.make_steady_state_latent_step)
        dummy = solver._cache.Ql.new_zeros((1, 1))
        return make(cache=solver._cache, num_derivatives=nu,
                    steady=solver.steady_cache._replace(cov_inf=dummy, Sl=dummy))
    attempt = (white_module.white_attempt_step if solver_name == "white"
               else latent_module.latent_attempt_step)
    return functools.partial(attempt, solver._cache, num_derivatives=nu, f=None, df=None,
                             linear=True, fused=fused, factorization=solver.factorization,
                             propagate_band=propagate_band)


def advance(step_fn, mean, cov, num_steps, dt):
    """``num_steps`` steps at t = dt, 2 dt, ...; ``(mean, cov)``."""
    for k in range(1, num_steps + 1):
        mean, cov, *_ = step_fn(mean, cov, k * dt, dt)
    return mean, cov


def step(device="cuda", *, n=100, nu=1, steps=4, fused=False, dim=2, factorization="plain",
         solver_name="white", propagate_band=None, steady_state=False, steady_iters=None,
         steady_tol=None, steady_chunk=None, steady_seed=True, steady_dtype=None, dt=1e-3):
    """The JAX driver's ``demo_step`` record."""
    device = common.device_of(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    heat, build_s = common.timed(make_problem, dim, n, device)
    d = heat.L.shape[0]
    opts = steady_options(steady_state, steady_iters, steady_tol, steady_chunk, steady_seed,
                          steady_dtype)
    solver = make_solver(solver_name, nu=nu, dt=dt, factorization=factorization, fused=fused,
                         propagate_band=propagate_band, steady_state=opts)
    state, init_s = common.timed(solver.initialize, heat)
    riccati_iterations = riccati_delta = None
    diagnostics = {}
    if steady_state:
        riccati_iterations = int(solver.steady_cache.iterations)
        riccati_delta = float(solver.steady_cache.delta)
        diagnostics = {k: v.item() if isinstance(v, torch.Tensor) else v
                       for k, v in (solver.steady_diagnostics or {}).items()}
        # the frozen closed loop's spectral radius (matvecs only): < 1 certifies
        # the mean recursion stable
        family = white_module if solver_name == "white" else latent_module
        diagnostics["closed_loop_rho"] = float(family.steady_closed_loop_radius(
            solver._cache, solver.steady_cache, dt, num_derivatives=nu))
    step_fn = stepper(solver, solver_name, nu=nu, fused=fused,
                      propagate_band=propagate_band, steady_state=steady_state)
    mean, cov = state.y.mean, state.y.cov_sqrtm
    if steady_state:
        cov = cov.new_zeros((1, 1))  # the frozen factor stays out of the loop
    mean0_max = mean[0, :d].abs().max().item()
    # free what the step does not read before it runs: at N = 1e4 the
    # problem, the solver (its prior's Gram factor) and the state are GBs
    del state, solver, heat
    (mean, cov), first_s = common.timed(advance, step_fn, mean, cov, steps, dt)
    (mean, cov), loop_s = common.timed(advance, step_fn, mean, cov, steps, dt)
    final_max = mean[0, :d].abs().max().item()  # the latent state's solution half
    record = {
        "demo": DEMOS[dim],
        "solver": solver_name,
        "grid": [n] * dim,
        "N": d,
        "state_dim": d * (nu + 1) * (2 if solver_name == "latent" else 1),
        "nu": nu,
        "dtype": str(mean.dtype).removeprefix("torch."),
        "device": common.device_name(device),
        "factorization": factorization,
        "fused_qr": fused,
        "propagate_band": propagate_band,
        "steady_state": steady_state,
        "steady_riccati_iterations": riccati_iterations,
        "steady_riccati_delta": riccati_delta,
        **({"steady_diagnostics": diagnostics} if diagnostics else {}),
        "steps_per_sec": steps / loop_s,
        "build_seconds": build_s,
        "init_seconds": init_s,
        "first_call_seconds": first_s,
        "dt": dt,
        "nan_free": not bool(torch.isnan(mean).any()),
        "heat_decays": final_max < mean0_max,
        "decay_ratio": final_max / mean0_max,
        "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30 if on_card else None,
    }
    return record


def best_seconds(fn, *args, **kwargs):
    """``(output, best of 3 timed calls after one warm-up)``, the card's
    queue drained around each."""
    out = fn(*args, **kwargs)
    best = float("inf")
    for _ in range(3):
        out, seconds = common.timed(fn, *args, **kwargs)
        best = min(best, seconds)
    return out, best


def gram(device="cuda", *, n=10000, input_scale=5.0):
    """The JAX driver's ``demo_gram`` record, in f64 and f32: the plain
    Gram's seconds, and on the card the kernel's, its speedup and its
    largest deviation from the plain Gram."""
    device = common.device_of(device)
    points = np.random.default_rng(0).uniform(size=(n, 2))
    record = {"demo": "gram_assembly", "N": n, "device": common.device_name(device)}
    for dtype in (torch.float64, torch.float32):
        x = torch.as_tensor(points, dtype=dtype, device=device)
        args = (x, x, input_scale, 1.0)
        want, plain_s = best_seconds(gram_ops.gram_radial_reference, *args, phi_name="matern52")
        entry = {"plain_seconds": plain_s, "gbytes_out": n * n * x.element_size() / 1e9}
        if device.type == "cuda":
            got, kernel_s = best_seconds(gram_ops.gram_radial, *args, phi_name="matern52")
            entry.update(kernel_seconds=kernel_s, kernel_speedup_vs_plain=plain_s / kernel_s,
                         max_abs_diff=(got - want).abs().max().item())
            del got
        del want
        record[str(dtype).removeprefix("torch.")] = entry
    return record


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("step", "gram"))
    p.add_argument("--n", type=int, default=100,
                   help="grid side (step mode) or total points (gram)")
    p.add_argument("--nu", type=int, default=1)
    p.add_argument("--dim", type=int, default=2, choices=(1, 2, 3))
    p.add_argument("--solver", choices=("white", "latent"), default="white")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--fused", action="store_true")
    p.add_argument("--propagate-band", default=None, choices=("banded", "interleaved"))
    p.add_argument("--steady-state", action="store_true",
                   help="freeze the Riccati fixed point at init; mean-only steps")
    p.add_argument("--steady-iters", type=int, default=None,
                   help="Riccati max_iters (default 4 seeded, 200 unseeded)")
    p.add_argument("--steady-tol", type=float, default=None, help="Riccati stationarity tol")
    p.add_argument("--steady-chunk", type=int, default=None,
                   help="Riccati iterations between convergence checks")
    p.add_argument("--steady-no-seed", action="store_true",
                   help="no doubling (SDA) seed: converge the recursion from scratch")
    p.add_argument("--steady-dtype", default=None, choices=("float64",),
                   help="run the Riccati recursion in f64 and cast the frozen blocks back "
                        "(an f32 problem under PNMOL_TPU_X32=1: its f32 seed has no "
                        "Cholesky factor at N = 512)")
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--input-scale", type=float, default=5.0)
    p.add_argument("--factorization", choices=("householder", "plain"), default="plain")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=common.ARTIFACT_ROOT, help="output root")
    args = p.parse_args(argv)
    if args.mode == "step":
        record = step(args.device, n=args.n, nu=args.nu, steps=args.steps, fused=args.fused,
                      dim=args.dim, factorization=args.factorization, solver_name=args.solver,
                      propagate_band=args.propagate_band, steady_state=args.steady_state,
                      steady_iters=args.steady_iters, steady_tol=args.steady_tol,
                      steady_chunk=args.steady_chunk, steady_seed=not args.steady_no_seed,
                      steady_dtype=args.steady_dtype, dt=args.dt)
    else:
        record = gram(args.device, n=args.n, input_scale=args.input_scale)
    print(json.dumps(record), flush=True)
    common.write_artifact("scale_demo", record, args.out)
    return record


if __name__ == "__main__":
    main()
