"""The check of a white-noise EK1 on a finite-difference heat problem: the
discretization, the initialization and the steps, each recomputed by the
plain reference (:mod:`reference`) from the inputs the program was given.

The numbers, each a gap between the program and the reference:

* ``mesh``, ``stencils``, ``boundary``: exact (limit 0). The grid points,
  the stencils that are not valid nearest-neighbour sets, and ``B`` and
  ``R_sqrtm``. Where the k-th nearest distance ties, the stencil is not
  determined by its definition: the reference takes the program's (the
  support of its ``L`` row) after checking it is a valid choice.
* ``L``, ``E_sqrtm``: the largest entry's gap over the largest entry.
* ``init_u``, ``init_mean``, ``init_gram``; ``u``, ``mean``, ``gram``: the
  initial state's, and every compared step's. ``u`` is the solution, ``mean``
  the worst derivative (each over its own largest entry), ``gram`` the worst
  derivative's rows of ``S G S probe`` in Frobenius norm over the
  reference's, ``G`` the covariance, ``S`` the Nordsieck scaling of the
  settings' ``probe_dt``.
* ``diffusion``: the local diffusions' relative gap; ``calibrated``: their
  mean's (the calibrated diffusion of the compared steps or solve).
* Whole solves under the ``Adaptive`` rule: ``times``, the accepted times'
  largest gap over ``tmax``, and ``attempts``, the accepted steps whose
  attempt count differs (limit 0).

It compares what the program's outputs hold (:mod:`harness.modes`): a
``chain`` of set-up steps from the initialization, a ``window`` step from
the program's own state before it, an ``init`` state and whole ``solves``.
"""

import math

import numpy as np
import torch

from harness.compare import gram_gap, mean_gaps, relative, scaling
from reference import discretization as rd
from reference import filter as rf
from reference import prior


def check(cell, program, seed, device, nums):
    cfg, traffic, settings = cell.config, cell.traffic, cell.settings
    problem, solver = cfg["problem"], cfg["solver"]
    recipe, options = problem["recipe_kwargs"], solver["solver_kwargs"]
    pts = rd.grid(problem["bbox"], problem["num_points"])
    mask = rd.boundary_mask(pts, problem["bbox"])
    nums["mesh"] = float(np.abs(program["points"] - pts).max())
    stencil, tied = rd.stencils(pts, mask, recipe["stencil_size_interior"],
                                recipe["stencil_size_boundary"])
    choices = {i: torch.nonzero(program["L"][i]).reshape(-1).numpy() for i in tied}
    nums["stencils"] = float(len(rd.resolve_ties(stencil, tied, choices)))
    dx = (problem["bbox"][0][1] - problem["bbox"][0][0]) / (problem["num_points"][0] - 1)
    L, E, B, R = rd.fd_operators(
        pts, mask, stencil, input_scale=problem["fd_input_scale_times_dx"] / dx,
        rate=recipe["diffusion_rate"], nugget=recipe["nugget_gram_matrix_fd"], device=device)
    nums["L"] = relative(program["L"], L.cpu())
    nums["E_sqrtm"] = relative(program["E_sqrtm"], E.cpu())
    nums["boundary"] = max(float((program["B"] - B.cpu()).abs().max()),
                           float((program["R_sqrtm"] - R.cpu()).abs().max()))
    del program["L"], program["E_sqrtm"]

    nu = solver["num_derivatives"]
    n, d = nu + 1, pts.shape[0]
    gram = prior.matern52_plus_white(torch.tensor(pts, device=device))
    prob = rf.Problem(L, E, B, R, gram, nu=nu, diffuse_scale=options["diffuse_prior_scale"],
                      nugget=solver["init_nugget"])
    scale = scaling(nu, settings["probe_dt"], d, device)
    # no probe where the program stopped before its first state
    probe = scale[:, None] * program["probe"].to(device) if "probe" in program else None

    def compare(prefix, got, mean, factor):
        u, worst = mean_gaps(got["mean"], mean.cpu())
        nums.worst(prefix + "u", u)
        nums.worst(prefix + "mean", worst)
        sketch = (scale[:, None] * (factor @ (factor.T @ probe))).cpu()
        nums.worst(prefix + "gram", gram_gap(got["sketch"], sketch, n, d))

    y0 = torch.tensor(program["y0"], dtype=torch.float64, device=device)
    mean0, factor0 = rf.initialize(prob, y0)
    rule = traffic["steprule"]
    if "init" in program:
        compare("init_", program["init"], mean0, factor0)
    chain = program.get("chain", [])
    if chain:
        compare("init_", chain[0], mean0, factor0)
        ref = rf.constant_steps(prob, mean0, factor0, rule["dt"], len(chain) - 1)
        for got, (mean, factor, diffusion) in zip(chain[1:], ref):
            compare("", got, mean, factor)
            nums.worst("diffusion", abs(got["diffusion"] / diffusion.item() - 1.0))
        if ref:
            calibrated = sum(r[2].item() for r in ref) / len(ref)
            mine = sum(got["diffusion"] for got in chain[1:]) / len(ref)
            nums.worst("calibrated", abs(mine / calibrated - 1.0))
        del ref
    window = program.get("window")
    if window is not None:
        factor_in = window["input_factor"].to(device=device, dtype=torch.float64)
        factor_in = factor_in[program["layout_inv"].to(device)]
        mean, factor, _, _, diffusion = rf.step(
            prob, window["input_mean"].to(device=device, dtype=torch.float64), factor_in,
            rule["dt"])
        del factor_in
        compare("", window["output"], mean, factor)
        nums.worst("diffusion", abs(window["output"]["diffusion"] / diffusion.item() - 1.0))
    solves = program.get("solves", [])
    if solves:
        if rule["kind"] != "Adaptive":
            raise ValueError("the white_fd check follows whole solves under the Adaptive "
                             f"rule only, not {rule['kind']!r}")
        mean, factor, times, attempts, diffusions = rf.adaptive_solve(
            prob, mean0, factor0, y0, t0=0.0, tmax=traffic["tmax"], abstol=rule["abstol"],
            reltol=rule["reltol"], safety=rule["safety_scale"], changes=rule["max_changes"])
        calibrated = torch.stack(diffusions).mean().item()
        for solve in solves:
            same = len(solve["times"]) == len(times)
            nums.worst("attempts", sum(a != b for a, b in zip(solve["attempts"], attempts))
                       + abs(len(solve["attempts"]) - len(attempts)))
            nums.worst("times", max(abs(a - b) for a, b in zip(solve["times"], times))
                       / traffic["tmax"] if same else math.inf)
            compare("", solve["final"], mean, factor)
            nums.worst("calibrated", abs(solve["final"]["diffusion"] / calibrated - 1.0))
