"""Figure 1: heat-equation contours, PNMOL (white, latent) against MOL and
the truth.

Counterpart of ``experiments/figure1.py``: 1-D heat with Dirichlet
boundaries, a Matern52 discretization kernel, constant steps; the means,
stds, times and points of each method, and the calibrated gammas of the
two PNMOL solvers (which the JAX driver prints)::

    python -m pnmol_tpu_torch.experiments.figure1 [--fast] [--no-plot]
        [--device cuda|cpu] [--out DIR]
"""

import torch

import pnmol_tpu_torch as pt
from pnmol_tpu_torch.experiments import common
from pnmol_tpu_torch.odetools import ek1 as ek1_module
from pnmol_tpu_torch.odetools import init as init_module
from pnmol_tpu_torch.odetools import reference_solver
from pnmol_tpu_torch.odetools import step as step_module

# Hyperparameters (method)
DT = 0.05
DX = 0.2
HIGH_RES_FACTOR_DT = 8
NUM_DERIVATIVES = 2
STENCIL_SIZE = 3
INPUT_SCALE = 1.0

# Hyperparameters (problem)
T0 = 0.0
DIFFUSION_RATE = 0.035


def high_res_factor_dx(fast):
    return 4 if fast else 12


def tmax(fast):
    return 1.0 if fast else 3.0


def kernel():
    return pt.kernels.Matern52(input_scale=INPUT_SCALE)


def make_pde(dx, *, device, fast=False):
    return pt.pde.examples.heat_1d_discretized(
        device=device,
        t0=T0,
        tmax=tmax(fast),
        dx=dx,
        stencil_size_interior=STENCIL_SIZE,
        stencil_size_boundary=STENCIL_SIZE + 1,
        diffusion_rate=DIFFUSION_RATE,
        kernel=kernel(),
        bcond="dirichlet",
    )


def solve_white(pde, factorization=None):
    solver = pt.white.LinearWhiteNoiseEK1(
        num_derivatives=NUM_DERIVATIVES,
        steprule=step_module.Constant(DT),
        spatial_kernel=kernel(),
        factorization=factorization,
    )
    sol = solver.solve(pde)
    E0 = solver.iwp.projection_matrix(0)
    means, stds = common.trajectory_mean_std(sol, E0)
    gamma = torch.sqrt(sol.diffusion_squared_calibrated)
    print("white calibrated gamma:", float(gamma))
    return means, gamma * stds, sol.t, pde.mesh_spatial.points, gamma


def solve_latent(pde, factorization=None):
    solver = pt.latent.LinearLatentForceEK1(
        num_derivatives=NUM_DERIVATIVES,
        steprule=step_module.Constant(DT),
        spatial_kernel=kernel(),
        factorization=factorization,
    )
    sol = solver.solve(pde)
    E0 = solver.state_iwp.projection_matrix(0)
    means, stds = common.trajectory_mean_std_latent(sol, E0)
    gamma = torch.sqrt(sol.diffusion_squared_calibrated)
    print("latent calibrated gamma:", float(gamma))
    return means, gamma * stds, sol.t, pde.mesh_spatial.points, gamma


def solve_mol(pde):
    """The MOL baseline (the JAX driver's "tornadox" rows)."""
    ivp = pde.to_ivp()
    solver = ek1_module.ReferenceEK1ConstantDiffusion(
        num_derivatives=NUM_DERIVATIVES,
        steprule=step_module.Constant(DT),
        initialization=init_module.Stack(use_df=False),
    )
    sol, sigma_squared = solver.solve(ivp)
    sigma = torch.sqrt(sigma_squared)
    E0 = solver.iwp.projection_matrix(0)
    means, stds = common.trajectory_mean_std(sol, E0)
    # re-insert the Dirichlet boundary rows eliminated by the conversion
    means = torch.nn.functional.pad(means, (1, 1))
    stds = torch.nn.functional.pad(stds, (1, 1))
    return means, sigma * stds, sol.t, pde.mesh_spatial.points


def solve_reference(pde_hi, fast=False):
    """High-resolution ground truth on the fine mesh, via DP5."""
    dt = DT / HIGH_RES_FACTOR_DT
    points = pde_hi.mesh_spatial.points
    t_eval = torch.arange(pde_hi.t0, pde_hi.tmax, step=dt, dtype=points.dtype,
                          device=points.device)
    ivp = pde_hi.to_ivp()
    sol = reference_solver.solve_ivp_dopri5(
        ivp.f, ivp.t_span, ivp.y0, t_eval, rtol=1e-8, atol=1e-10
    )
    step_dx = high_res_factor_dx(fast)
    means = torch.nn.functional.pad(sol.y, (1, 1))[::HIGH_RES_FACTOR_DT, ::step_dx]
    stds = torch.zeros_like(means)
    ts = t_eval[::HIGH_RES_FACTOR_DT]
    xs = points[::step_dx]
    return means, stds, ts, xs


def run(device="cuda", *, fast=False):
    """Every method's ``<prefix>_{means,stds,ts,xs}`` as the JAX driver
    names them, and ``pnmol_{white,latent}_gamma``. The PNMOL solvers take
    the kernel route on the card and the plain QRs on the CPU."""
    device = common.device_of(device)
    factorization = common.default_factorization(device)
    pde = make_pde(DX, device=device, fast=fast)
    pde_hi = make_pde(DX / high_res_factor_dx(fast), device=device, fast=fast)

    arrays = {}
    *white, white_gamma = solve_white(pde, factorization)
    *latent, latent_gamma = solve_latent(pde, factorization)
    for prefix, result in [
        ("pnmol_white", white),
        ("pnmol_latent", latent),
        ("tornadox", solve_mol(pde)),
        ("reference", solve_reference(pde_hi, fast)),
    ]:
        for name, value in zip(("means", "stds", "ts", "xs"), result):
            arrays[f"{prefix}_{name}"] = common.to_numpy(value)
        print(f"{prefix}: means {tuple(result[0].shape)}, stds {tuple(result[1].shape)}")
    arrays["pnmol_white_gamma"] = common.to_numpy(white_gamma)
    arrays["pnmol_latent_gamma"] = common.to_numpy(latent_gamma)
    return arrays


def main(argv=None):
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    common.finish(args, "figure1", run(args.device, fast=args.fast))


if __name__ == "__main__":
    main()
