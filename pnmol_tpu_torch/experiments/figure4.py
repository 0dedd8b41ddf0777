"""Figure 4: work-precision diagrams on the Lotka-Volterra system.

Counterpart of ``experiments/figure4.py``: for each mesh width and twelve
step sizes, the Lotka-Volterra reaction-diffusion system through
PNMOL-white, PNMOL-latent and the MOL baseline; the relative RMSE of the
prey compartment against a high-resolution LSODA reference, the chi^2
calibration, the step counts and the seconds, as
``dx_<dx>_<method>_<metric>.npy``; and the reference's seconds and its
Jacobian calls (``dx_<dx>_reference_*``)::

    python -m pnmol_tpu_torch.experiments.figure4 [--fast] [--no-plot]
        [--device cuda|cpu] [--out DIR] [--dxs 0.01,0.05,0.2]
"""

import numpy as np
import torch

import pnmol_tpu_torch as pt
from pnmol_tpu_torch.experiments import common
from pnmol_tpu_torch.odetools import ek1 as ek1_module
from pnmol_tpu_torch.odetools import init as init_module
from pnmol_tpu_torch.odetools import reference_solver
from pnmol_tpu_torch.odetools import step as step_module

T0 = 0.0
DXS = (0.01, 0.05, 0.2)
REF_SCALE = 7
NU = 2
METHODS = ("pnmol_white", "pnmol_latent", "mol")


def tmax(fast):
    return 1.0 if fast else 6.0


def default_dxs(fast):
    return (0.05,) if fast else DXS


def default_dts(fast):
    return np.logspace(0.0, -2.5, 3 if fast else 12, endpoint=True)


def prior_kernel():
    return pt.kernels.duplicate(pt.kernels.Matern52() + pt.kernels.WhiteNoise(), num=2)


def make_lv(dx, *, device, fast=False, **kwargs):
    return pt.pde.examples.lotka_volterra_1d_discretized(
        device=device, t0=T0, tmax=tmax(fast), dx=dx, **kwargs
    )


def solve_reference(dx, *, device, fast=False):
    """High-res prey and predator at tmax on the coarse interior grid, and
    the solve's record (seconds, Jacobian calls and their seconds).

    LSODA (host scipy): the high-res system is stiff (diffusion eigenvalue
    ~ (dx/7)^-2). Its ``f`` and dense ``jac`` run on ``device``, and each
    Jacobian is copied to the host.
    """
    pde_ref = make_lv(dx / REF_SCALE, device=device, fast=fast)
    ivp = pde_ref.to_ivp()
    jac = common.HostJacobian(ivp.df)
    sol, seconds = common.timed(
        reference_solver.solve_ivp_stiff,
        ivp.f,
        ivp.t_span,
        ivp.y0,
        t_eval=[ivp.tmax],
        rtol=1e-10,
        atol=1e-10,
        jac=jac,
    )
    u_full, v_full = torch.chunk(sol.y[-1], 2)
    record = dict(time=seconds, jac_time=jac.seconds, jac_calls=jac.calls, nfev=sol.num_steps,
                  d=ivp.y0.shape[0])
    return u_full[REF_SCALE - 1 :: REF_SCALE], v_full[REF_SCALE - 1 :: REF_SCALE], record


def extract_white(final, solver):
    u_full, _ = torch.chunk(final.y.mean[0], 2)
    cov = final.y.cov_sqrtm @ final.y.cov_sqrtm.T
    cov0 = solver.E0 @ cov @ solver.E0.T
    u_cov = common.leading_block(cov0, 2)
    return u_full[1:-1], u_cov[1:-1, 1:-1]


def extract_latent(final, solver):
    mean_state, _ = torch.chunk(final.y.mean[0], 2)
    u_full, _ = torch.chunk(mean_state, 2)
    cov = final.y.cov_sqrtm @ final.y.cov_sqrtm.T
    cov_state = common.leading_block(cov, 2)
    cov0 = solver.E0 @ cov_state @ solver.E0.T
    u_cov = common.leading_block(cov0, 2)
    return u_full[1:-1], u_cov[1:-1, 1:-1]


def extract_mol(final, solver):
    u, _ = torch.chunk(final.y.mean[0], 2)
    cov = final.y.cov_sqrtm @ final.y.cov_sqrtm.T
    E0 = solver.iwp.projection_matrix(0)
    return u, common.leading_block(E0 @ cov @ E0.T, 2)


def solve(method, pde, ivp, dt, factorization=None):
    """``(u, u_cov, info, seconds)`` of one method at one step size."""
    steprule = step_module.Constant(dt)
    if method == "pnmol_latent":
        solver = pt.latent.SemiLinearLatentForceEK1(
            num_derivatives=NU, steprule=steprule, spatial_kernel=prior_kernel(),
            factorization=factorization)
        problem, extract = pde, extract_latent
    elif method == "pnmol_white":
        solver = pt.white.SemiLinearWhiteNoiseEK1(
            num_derivatives=NU, steprule=steprule, spatial_kernel=prior_kernel(),
            factorization=factorization)
        problem, extract = pde, extract_white
    else:
        solver = ek1_module.ReferenceEK1ConstantDiffusion(
            num_derivatives=NU, steprule=steprule,
            initialization=init_module.Stack(use_df=False))
        problem, extract = ivp, extract_mol
    (final, info), seconds = common.timed(solver.simulate_final_state, problem)
    u, u_cov = extract(final, solver)
    return u, u_cov, info, seconds


def run(device="cuda", *, fast=False, dxs=None, dts=None):
    """The JAX driver's arrays for each of ``dxs`` (default: its grid)
    at ``dts`` (default: its twelve, three under ``fast``), and each
    reference's ``dx_<dx>_reference_{time,jac_time,jac_calls}``.
    The PNMOL solvers take the kernel route on the card and the plain QRs
    on the CPU; the MOL EK1 takes plain QRs either way."""
    device = common.device_of(device)
    factorization = common.default_factorization(device)
    dxs = default_dxs(fast) if dxs is None else dxs
    dts = default_dts(fast) if dts is None else np.asarray(dts, dtype=np.float64)

    arrays = {}
    for dx in dxs:
        pde = make_lv(dx, device=device, fast=fast, stencil_size_interior=3,
                      stencil_size_boundary=4)
        ivp = pde.to_ivp()
        u_ref, _, record = solve_reference(dx, device=device, fast=fast)
        print(f"dx={dx}: grid {tuple(pde.mesh_spatial.shape)}, ref {tuple(u_ref.shape)}; LSODA "
              f"on {record['d']} unknowns in {record['time']:.3f} s, {record['nfev']} f and "
              f"{record['jac_calls']} jac calls ({record['jac_time']:.3f} s with their copies)")

        metrics = {method: {"rmse": [], "chi2": [], "nsteps": [], "time": []}
                   for method in METHODS}
        for dt in dts.tolist():
            for method in ("pnmol_latent", "pnmol_white", "mol"):
                u, u_cov, info, seconds = solve(method, pde, ivp, dt, factorization)
                err = torch.abs(u - u_ref)
                metrics[method]["rmse"].append(float(common.rmse(err, u_ref)))
                metrics[method]["chi2"].append(float(common.chi2_statistic(err, u_cov)))
                metrics[method]["nsteps"].append(int(info["num_steps"]))
                metrics[method]["time"].append(seconds)
            print(f"  dt={dt:.4f}: " + " | ".join(
                f"{m}: rmse={metrics[m]['rmse'][-1]:.2e} chi2={metrics[m]['chi2'][-1]:.2e}"
                for m in metrics))

        prefix = f"dx_{dx}"
        for method, vals in metrics.items():
            for metric, values in vals.items():
                arrays[f"{prefix}_{method}_{metric}"] = np.asarray(values)
        arrays[f"{prefix}_dts"] = dts
        for key in ("time", "jac_time", "jac_calls"):
            arrays[f"{prefix}_reference_{key}"] = np.asarray(record[key])
    return arrays


def main(argv=None):
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--dxs", type=lambda s: [float(v) for v in s.split(",")], default=None,
                   help="comma-separated mesh widths (default: 0.01,0.05,0.2; 0.05 with --fast)")
    args = p.parse_args(argv)
    dxs = default_dxs(args.fast) if args.dxs is None else args.dxs
    common.finish(args, "figure4", run(args.device, fast=args.fast, dxs=dxs), dxs=dxs)


if __name__ == "__main__":
    main()
