"""Figure 3: the dt x dx convergence and calibration grid on the SIR system.

Counterpart of ``experiments/figure3.py``: for each (dx, dt) cell the SIR
reaction-diffusion system through the PNMOL white-noise EK1 and the MOL
baseline, against a high-resolution LSODA reference at tmax: RMSE (abs,
rel), mean std, chi^2 calibration and seconds, as
``{pnmol_white,tornadox}_<metric>.npy``; and each reference's seconds and
Jacobian calls (``reference_*``, one entry per dx)::

    python -m pnmol_tpu_torch.experiments.figure3 [--fast] [--no-plot]
        [--device cuda|cpu] [--out DIR] [--dx-levels N] [--ensemble-dts]

``--dx-levels N`` keeps the N coarsest meshes; ``--ensemble-dts`` runs the
white solver's step sizes of each mesh as one batched sweep
(``parallel.ensembles.dt_sweep_final_states``), each lane's runtime the
batch's divided by the lanes.
"""

import numpy as np
import torch

import pnmol_tpu_torch as pt
from pnmol_tpu_torch.experiments import common
from pnmol_tpu_torch.odetools import ek1 as ek1_module
from pnmol_tpu_torch.odetools import init as init_module
from pnmol_tpu_torch.odetools import reference_solver
from pnmol_tpu_torch.odetools import step as step_module
from pnmol_tpu_torch.parallel import ensembles

DTS = 2.0 ** np.arange(2, -7, step=-0.5)
DXS = 1.0 / (2.0 ** np.arange(2, 7))
HIGH_RES_FACTOR_DX = 10
NUM_DERIVATIVES = 1
STENCIL_SIZE = 3
T0 = 0.0
DIFFUSION_RATE = 0.035
METRICS = ("error_abs", "error_rel", "std", "runtime", "chi2", "dt", "dx")


def tmax(fast):
    return 1.0 if fast else 6.0


def default_dxs(fast):
    return DXS[:2] if fast else DXS


def default_dts(fast):
    return DTS[::4] if fast else DTS


def prior_kernel():
    return pt.kernels.duplicate(pt.kernels.Matern52() + pt.kernels.WhiteNoise(), num=3)


def make_sir(dx, stencil_boundary, *, device, fast=False):
    return pt.pde.examples.sir_1d_discretized(
        device=device,
        t0=T0,
        tmax=tmax(fast),
        dx=dx,
        stencil_size_interior=STENCIL_SIZE,
        stencil_size_boundary=stencil_boundary,
        diffusion_rate_S=DIFFUSION_RATE,
        diffusion_rate_I=DIFFUSION_RATE,
        diffusion_rate_R=DIFFUSION_RATE,
        kernel=pt.kernels.SquareExponential(),
    )


def solve_reference(dx, *, device, fast=False):
    """High-res ground truth at tmax: the susceptible compartment on the
    coarse interior, and the solve's record (seconds, Jacobian calls and
    their seconds).

    LSODA (host scipy): the 10x-refined system is stiff. Its ``f`` and dense
    ``jac`` run on ``device``, and each Jacobian is copied to the host.
    """
    pde_ref = make_sir(dx / HIGH_RES_FACTOR_DX, STENCIL_SIZE + 1, device=device, fast=fast)
    ivp = pde_ref.to_ivp()
    jac = common.HostJacobian(ivp.df)
    sol, seconds = common.timed(
        reference_solver.solve_ivp_stiff,
        ivp.f,
        ivp.t_span,
        ivp.y0,
        t_eval=[pde_ref.tmax],
        rtol=1e-10,
        atol=1e-10,
        jac=jac,
    )
    i_mean = torch.chunk(sol.y[-1], 3)[0]
    record = dict(time=seconds, jac_time=jac.seconds, jac_calls=jac.calls, nfev=sol.num_steps,
                  d=ivp.y0.shape[0])
    return i_mean[HIGH_RES_FACTOR_DX - 1 :: HIGH_RES_FACTOR_DX], record


def white_solver(dt, factorization=None):
    return pt.white.SemiLinearWhiteNoiseEK1(
        num_derivatives=NUM_DERIVATIVES,
        steprule=step_module.Constant(dt),
        spatial_kernel=prior_kernel(),
        factorization=factorization,
    )


def susceptible(final, E0, interior=True):
    """The S compartment's mean, std and covariance block (the JAX driver
    takes S for all three, where the reference mixes the S mean with the I
    covariance block), at the interior points unless the state is already
    boundary-free."""
    mean, std, cov = common.final_mean_std_cov(final, E0)
    cut = slice(1, -1) if interior else slice(None)
    s_mean = torch.chunk(mean, 3)[0][cut]
    s_std = torch.chunk(std, 3)[0][cut]
    s_cov = common.leading_block(cov, 3)[cut, cut]
    return s_mean, s_std, s_cov


def solve_white(pde, dt, factorization=None):
    solver = white_solver(dt, factorization)
    (final, _), elapsed = common.timed(solver.simulate_final_state, pde)
    return (*susceptible(final, solver.iwp.projection_matrix(0)), elapsed)


def solve_white_ensemble(pde, dts, factorization=None):
    """All PNMOL-white dts of one dx as ONE padded batched sweep
    (``parallel.ensembles.dt_sweep_final_states``). Per-dt wall-clock is
    not observable in a batch, so each lane's runtime is the batch's
    divided by the number of lanes."""
    solver = white_solver(dts[0], factorization)
    state = solver.initialize(pde)
    (means, covs, _), elapsed = common.timed(
        ensembles.dt_sweep_final_states,
        cache=solver._cache,
        num_derivatives=NUM_DERIVATIVES,
        f=pde.f,
        df=pde.df,
        linear=False,
        mean0=state.y.mean,
        cov0=state.y.cov_sqrtm,
        t0=pde.t0,
        tmax=pde.tmax,
        dts=list(dts),
    )
    E0 = solver.iwp.projection_matrix(0)
    per_dt = []
    for i in range(len(dts)):
        final = state._replace(y=state.y._replace(mean=means[i], cov_sqrtm=covs[i]))
        per_dt.append((*susceptible(final, E0), elapsed / len(dts)))
    return per_dt


def solve_mol(pde, dt):
    ivp = pde.to_ivp()
    solver = ek1_module.ReferenceEK1ConstantDiffusion(
        num_derivatives=NUM_DERIVATIVES,
        steprule=step_module.Constant(dt),
        initialization=init_module.Stack(use_df=False),
    )
    (final, _), elapsed = common.timed(solver.simulate_final_state, ivp)
    # the IVP state is already boundary-free
    return (*susceptible(final, solver.iwp.projection_matrix(0), interior=False), elapsed)


def record_cell(result, i_dx, i_dt, dx, dt, ref, cell):
    s_mean, s_std, s_cov, seconds = cell
    err = torch.abs(s_mean - ref)
    result["error_abs"][i_dx, i_dt] = common.rmse(err)
    result["error_rel"][i_dx, i_dt] = common.rmse(err, ref)
    result["std"][i_dx, i_dt] = torch.mean(s_std)
    result["runtime"][i_dx, i_dt] = seconds
    result["chi2"][i_dx, i_dt] = common.chi2_statistic(err, s_cov)
    result["dt"][i_dx, i_dt] = dt
    result["dx"][i_dx, i_dt] = dx


def run(device="cuda", *, fast=False, dxs=None, dts=None, ensemble=False):
    """The JAX driver's ``pnmol_white_*`` and ``tornadox_*`` grids, rows
    the sorted ``dxs`` (finest first; default its five, two under
    ``fast``), columns the sorted ``dts`` (default its eighteen, five under
    ``fast``); and ``reference_{time,jac_time,jac_calls}`` per row.
    The white solver takes the kernel route on the card and the plain QRs
    on the CPU; the MOL EK1 takes plain QRs either way."""
    device = common.device_of(device)
    factorization = common.default_factorization(device)
    dxs = sorted(default_dxs(fast) if dxs is None else dxs)
    dts = sorted(default_dts(fast) if dts is None else dts)
    shape = (len(dxs), len(dts))
    result_white = {k: np.zeros(shape) for k in METRICS}
    result_mol = {k: np.zeros(shape) for k in METRICS}
    references = {k: np.zeros(len(dxs)) for k in ("time", "jac_time", "jac_calls")}

    for i_dx, dx in enumerate(dxs):
        pde = make_sir(dx, STENCIL_SIZE + 2, device=device, fast=fast)
        ref, record = solve_reference(dx, device=device, fast=fast)
        for key in references:
            references[key][i_dx] = record[key]
        print(f"dx={dx:.4f}: LSODA on {record['d']} unknowns in {record['time']:.3f} s, "
              f"{record['nfev']} f and {record['jac_calls']} jac calls "
              f"({record['jac_time']:.3f} s with their copies)")
        white_batch = solve_white_ensemble(pde, dts, factorization) if ensemble else None
        for i_dt, dt in enumerate(dts):
            print(f"dx={dx:.4f} dt={dt:.4f} (d={pde.y0.numel()})")
            white = white_batch[i_dt] if ensemble else solve_white(pde, dt, factorization)
            record_cell(result_white, i_dx, i_dt, dx, dt, ref, white)
            mol = solve_mol(pde, dt)
            record_cell(result_mol, i_dx, i_dt, dx, dt, ref, mol)
            print(
                f"  white: rmse_rel={result_white['error_rel'][i_dx, i_dt]:.3e} "
                f"chi2={result_white['chi2'][i_dx, i_dt]:.3e} t={white[-1]:.2f}s | "
                f"mol: rmse_rel={result_mol['error_rel'][i_dx, i_dt]:.3e} "
                f"chi2={result_mol['chi2'][i_dx, i_dt]:.3e} t={mol[-1]:.2f}s"
            )

    arrays = {f"pnmol_white_{k}": v for k, v in result_white.items()}
    arrays.update({f"tornadox_{k}": v for k, v in result_mol.items()})
    arrays.update({f"reference_{k}": v for k, v in references.items()})
    return arrays


def main(argv=None):
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--dx-levels", type=int, default=None,
                   help="keep the N coarsest meshes of 1/4 ... 1/64")
    p.add_argument("--ensemble-dts", action="store_true",
                   help="the white solver's dts of each mesh as one batched sweep")
    args = p.parse_args(argv)
    dxs = default_dxs(args.fast)
    if args.dx_levels is not None:
        dxs = dxs[: args.dx_levels]
    common.finish(args, "figure3", run(args.device, fast=args.fast, dxs=dxs,
                                       ensemble=args.ensemble_dts))


if __name__ == "__main__":
    main()
