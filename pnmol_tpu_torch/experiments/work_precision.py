"""Work-precision: accuracy and calibration against seconds at constant dt.

Counterpart of ``experiments/tpu_work_precision.py`` on either device, in
f64 or, as the JAX driver's device legs run, in f32 end to end. Figure 4's
constant-dt ladder on the same problems, priors and step sizes:

* ``lv``: the Lotka-Volterra reaction-diffusion system (dx 0.01, tmax 1,
  stencils 3/4) through ``SemiLinearWhiteNoiseEK1`` with a ``duplicate``
  prior, against LSODA on the mesh refined 4-fold, restricted;
* ``heat_<n>`` (n = 512, 2048): the 1-D heat on n points with the
  dx-adapted FD kernel ``SquareExponential(0.1/dx)`` through
  ``LinearWhiteNoiseEK1``, against LSODA on its interior MOL system;

each at nu = 2 with prior ``Matern52() + WhiteNoise()``. A leg is a problem
on a device, ``<problem>_<cpu|cuda>``, in f64; ``<problem>_<cpu|cuda>_f32``
builds and solves it under the f32 policy (``PNMOL_TPU_X32``'s, switched
for the leg alone). Every row has its ``dtype``, the relative RMSE of
the interior solution and the chi^2 calibration (host f64), the steps, the
seconds of one ``simulate_final_state`` (after one untimed solve at the
leg's first dt), the steps/s, and the kernel launches it made. On the card
the solvers take the kernel route (``"householder"``)::

    python -m pnmol_tpu_torch.experiments.work_precision
        [--legs lv_cuda,heat_512_cuda,heat_2048_cuda,lv_cuda_f32,...]
        [--recompute-reference] [--out DIR]

The references are read from the JAX driver's committed
``experiments/results/wp_ref_*.npy`` (as data); ``--recompute-reference``
solves them with the port's LSODA and holds them to the committed ones
(:data:`REFERENCE_RTOL`); references are f64 in every leg. Every leg's
status goes into the record
(``<out>/work_precision/work_precision.json``), a failed leg makes the run
exit non-zero, and no earlier run's file is merged.
"""

import argparse
import datetime
import json
import sys

import numpy as np
import torch

import pnmol_tpu_torch as pt
from pnmol_tpu_torch.experiments import common
from pnmol_tpu_torch.odetools import reference_solver
from pnmol_tpu_torch.odetools import step as step_module
from pnmol_tpu_torch.ops import qr_householder

LV_DTS = [0.316, 0.1, 0.0316, 0.01, 0.00562, 0.00316]
HEAT_DTS_CARD = [0.1, 0.05, 0.02, 0.01, 0.005, 0.002, 0.001]
HEAT_DTS_CPU = [0.1, 0.05, 0.02, 0.01]
HEAT_DTS_CPU_2048 = [0.1, 0.05]
NU = 2
LV_DX, LV_SCALE = 0.01, 4
DEFAULT_LEGS = ("lv_cuda", "heat_512_cuda", "heat_2048_cuda")
# the JAX driver's device legs: the same problems in f32 end to end
F32_LEGS = ("lv_cuda_f32", "heat_512_cuda_f32", "heat_2048_cuda_f32")
REFERENCES = common.REPO / "experiments" / "results"
# a recomputed reference against the committed one, max |diff| / max |ref|,
# by problem: both are LSODA at rtol = atol = 1e-10, on operators that the
# two packages assemble with their own rounding. The Lotka-Volterra
# reference mesh (dx 0.0025, the default SquareExponential() stencils) is
# near singular, so its rows part further (on the CPU: lv 2.9e-7, heat_512
# 1.3e-9, heat_2048 7.7e-9)
REFERENCE_RTOL = {"lv": 1e-6, "heat": 1e-7}
KERNELS = {"panel_lq": qr_householder.panel_lq, "leaf_lq": qr_householder.leaf_lq}
NOTE = ("figure4-style constant-dt work-precision on the port, each row in its dtype; "
        "rmse_rel is the relative RMSE of the interior solution against an LSODA rtol=1e-10 "
        "reference; chi2 is the calibration statistic (f64 host math); seconds is one "
        "simulate_final_state")


def parse_leg(leg):
    """``"heat_512_cuda"`` -> ``("heat", 512, "cuda")``; ``"lv_cpu"`` ->
    ``("lv", None, "cpu")``; a ``_f32`` suffix (:func:`leg_dtype`) parses
    as the leg without it."""
    parts = leg.removesuffix("_f32").split("_")
    if parts[-1] not in ("cpu", "cuda") or parts[0] not in ("lv", "heat") or (
            len(parts) != (3 if parts[0] == "heat" else 2)):
        raise ValueError(f"unknown leg {leg!r}: lv_<cpu|cuda> or heat_<n>_<cpu|cuda>")
    return parts[0], int(parts[1]) if parts[0] == "heat" else None, parts[-1]


def leg_dtype(leg):
    """The dtype a leg builds and solves in: f32 for a ``_f32`` leg."""
    return torch.float32 if leg.endswith("_f32") else torch.float64


def default_dts(problem, n, platform):
    if problem == "lv":
        return LV_DTS
    if platform == "cuda":
        return HEAT_DTS_CARD
    return HEAT_DTS_CPU_2048 if n >= 2048 else HEAT_DTS_CPU


def prior():
    return pt.kernels.Matern52() + pt.kernels.WhiteNoise()


def lotka_volterra(dx, device):
    return pt.pde.examples.lotka_volterra_1d_discretized(
        dx=dx, t0=0.0, tmax=1.0, stencil_size_interior=3, stencil_size_boundary=4,
        device=device)


def heat(n, device):
    dx = 1.0 / (n - 1)
    return pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=1.0, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx),
        device=device)


class Problem:
    """One problem of the sweep on ``device``: the PDE, its solver at a dt,
    the interior solution and its covariance of a final state, and its
    reference (committed tag, the IVP LSODA solves, the values compared)."""

    def __init__(self, problem, n, device):
        self.name, self.device = problem, device
        if problem == "lv":
            self.pde = lotka_volterra(LV_DX, device)
            self.n = self.pde.L.shape[0] // 2
            self.tag = f"lv_dx{LV_DX}_s{LV_SCALE}"
        else:
            self.pde = heat(n, device)
            self.n = n
            self.tag = f"heat_n{n}"

    def reference_ivp(self):
        """The IVP LSODA solves, in the policy's dtype (an f32 problem's
        is built anew)."""
        if self.name == "lv":
            return lotka_volterra(LV_DX / LV_SCALE, self.device).to_ivp()
        if self.pde.L.dtype != pt.config.default_dtype():
            return heat(self.n, self.device).to_ivp()
        return self.pde.to_ivp()

    def reference_values(self, y_ref):
        """The compared entries of a reference's final state (host f64)."""
        if self.name == "lv":
            return np.split(y_ref, 2)[0][LV_SCALE - 1::LV_SCALE]
        return y_ref

    def solver(self, dt, factorization):
        kwargs = dict(num_derivatives=NU, steprule=step_module.Constant(dt),
                      factorization=factorization)
        if self.name == "lv":
            return pt.white.SemiLinearWhiteNoiseEK1(
                spatial_kernel=pt.kernels.duplicate(prior(), num=2), **kwargs)
        return pt.white.LinearWhiteNoiseEK1(spatial_kernel=prior(), **kwargs)

    def extract(self, final, solver):
        """Interior solution mean and covariance (the prey for ``lv``)."""
        cov = final.y.cov_sqrtm @ final.y.cov_sqrtm.T
        cov0 = solver.E0 @ cov @ solver.E0.T
        if self.name == "lv":
            u = torch.chunk(final.y.mean[0], 2)[0]
            cov0 = common.leading_block(cov0, 2)
        else:
            u = final.y.mean[0]
        return u[1:-1], cov0[1:-1, 1:-1]


def solve_reference(problem):
    """LSODA at rtol = atol = 1e-10 (the JAX driver's), its Jacobian on the
    problem's device; ``(final state on the host, record)``."""
    ivp = problem.reference_ivp()
    jac = common.HostJacobian(ivp.df)
    sol, seconds = common.timed(reference_solver.solve_ivp_stiff, ivp.f, ivp.t_span, ivp.y0,
                                t_eval=[ivp.tmax], rtol=1e-10, atol=1e-10, jac=jac)
    return common.to_numpy(sol.y[-1]).astype(np.float64), dict(
        seconds=seconds, jac_calls=jac.calls, jac_seconds=jac.seconds, d=ivp.y0.shape[0])


def reference(problem, recompute=False):
    """``(compared reference values, record)``: the committed reference, or
    under ``recompute`` the port's LSODA, held to the committed one."""
    committed = np.load(REFERENCES / f"wp_ref_{problem.tag}.npy")
    if not recompute:
        return problem.reference_values(committed), {"source": "committed", "tag": problem.tag}
    y_ref, record = solve_reference(problem)
    gap = float(np.abs(y_ref - committed).max() / np.abs(committed).max())
    record.update(source="recomputed", tag=problem.tag, gap_to_committed=gap)
    print(json.dumps({"reference": record}), flush=True)
    if not gap <= REFERENCE_RTOL[problem.name]:
        raise ValueError(f"the recomputed {problem.tag} reference is {gap:.3e} from the "
                         f"committed one (held to {REFERENCE_RTOL[problem.name]:g})")
    return problem.reference_values(y_ref), record


def chi2_f64(err, cov):
    """e^T (C + 1e-12 I)^{-1} e / n in host f64, as the JAX driver."""
    return float(err @ np.linalg.solve(cov + 1e-12 * np.eye(cov.shape[0]), err) / err.size)


def launches():
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}


def solve_row(problem, dt, u_ref, factorization, platform):
    """One timed ``simulate_final_state`` at ``dt``: the JAX driver's row,
    with the steps/s and the kernel launches of the solve."""
    solver = problem.solver(dt, factorization)
    before = launches()
    (final, info), seconds = common.timed(solver.simulate_final_state, problem.pde)
    after = launches()
    u, u_cov = (common.to_numpy(x).astype(np.float64) for x in problem.extract(final, solver))
    err = np.abs(u - u_ref)
    rel = err / np.abs(u_ref)
    row = {
        "problem": problem.name, "platform": platform, "n": problem.n, "dt": dt,
        "num_steps": int(info["num_steps"]),
        "rmse_rel": float(np.linalg.norm(rel) / np.sqrt(rel.size)),
        "chi2": chi2_f64(err, u_cov),
        "seconds": seconds,
        "steps_per_s": int(info["num_steps"]) / seconds,
        "dtype": str(final.y.mean.dtype).removeprefix("torch."),
        "launches": {name: after[name] - before[name] for name in KERNELS},
    }
    print(json.dumps(row), flush=True)
    return row


def run_leg(leg, *, dts=None, recompute_reference=False):
    """One leg's ``{"leg", "device", "reference", "warmup_seconds", "rows"}``: one
    untimed solve at the first dt, then a row for each of ``dts`` (default:
    the JAX driver's ladder for the problem and device)."""
    name, n, platform = parse_leg(leg)
    dtype = leg_dtype(leg)
    device = common.device_of(platform)
    factorization = common.default_factorization(device)
    dts = default_dts(name, n, platform) if dts is None else list(dts)
    with common.precision_policy(dtype):
        problem = Problem(name, n, device)
        with common.precision_policy(torch.float64):  # the reference, in f64
            u_ref, ref_record = reference(problem, recompute_reference)
        _, warmup_seconds = common.timed(
            problem.solver(dts[0], factorization).simulate_final_state, problem.pde)
        rows = [solve_row(problem, dt, u_ref, factorization, platform) for dt in dts]
    return {"leg": leg, "device": common.device_name(device), "reference": ref_record,
            "warmup_seconds": warmup_seconds, "rows": rows}


def run(legs=DEFAULT_LEGS, *, recompute_reference=False):
    """Every leg, each with its status; the record and whether all legs
    completed."""
    statuses, rows, references = [], [], {}
    for leg in legs:
        result, status = common.run_leg(leg, run_leg, leg,
                                        recompute_reference=recompute_reference)
        statuses.append(status)
        if result is not None:
            rows.extend(result["rows"])
            references[leg] = result["reference"]
            status.update(device=result["device"], rows=len(result["rows"]))
        print(json.dumps(status), flush=True)
    record = {
        "experiment": "work_precision",
        "note": NOTE,
        "legs": statuses,
        "references": references,
        "rows": rows,
        "recorded_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
    }
    return record, all(s["status"] == "completed" for s in statuses)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--legs", default=",".join(DEFAULT_LEGS),
                   help="comma-separated legs: lv_<dev>, heat_512_<dev>, heat_2048_<dev>; "
                        "dev cpu or cuda; a _f32 suffix runs the leg in f32 end to end")
    p.add_argument("--recompute-reference", action="store_true",
                   help="solve the references with the port's LSODA and hold them to the "
                        "committed ones")
    p.add_argument("--out", default=common.ARTIFACT_ROOT, help="output root")
    args = p.parse_args(argv)
    record, ok = run(args.legs.split(","), recompute_reference=args.recompute_reference)
    path = common.write_artifact("work_precision", record, args.out)
    print(json.dumps({"artifact": str(path), "ok": ok}), flush=True)
    if not ok:
        sys.exit(1)
    return record


if __name__ == "__main__":
    main()
