"""Whole solves from ``initialize`` to ``tmax``: one in set-up, then one
after another until the window's seconds are up, each initialized inside
the window. Every solve is checked: its accepted times, the attempts of
each step, and its final state with the mean of its local diffusions,
copied to the host at the solve's end (the program synchronizes the host
on every attempt already). A solve that runs past the mix's
``solve_seconds_max`` raises."""

import time

import torch


def _solve(run, gen, mark):
    limit = run.cell.traffic["solve_seconds_max"]
    t0 = time.perf_counter()
    times, attempts, diffusions, previous = [], [], [], 0
    for state, info in gen:
        if time.perf_counter() - t0 > limit:
            raise RuntimeError(f"a solve ran past the traffic mix's {limit} s")
        mark()
        times.append(state.t)
        attempts.append(info["num_attempted_steps"] - previous)
        previous = info["num_attempted_steps"]
        diffusions.append(state.diffusion_squared_local)
    return {"times": times, "attempts": attempts,
            "final": run.to_host(run.summary(state, torch.stack(diffusions).mean()))}


def drive(run):
    gen, state = run.initialize()
    run.program["init"] = run.to_host(run.summary(state))
    solves = run.program["solves"] = [_solve(run, gen, lambda: None)]
    with run.window() as t0:
        while time.perf_counter() - t0 < run.seconds:
            gen = run.solver.solution_generator(run.pde)
            with run.span("harness.initialize"):
                next(gen)
            run.inits += 1
            with run.span("harness.solve"):
                solves.append(_solve(run, gen, run.marks.mark))
    run.steps = sum(len(s["times"]) for s in solves[1:])
    run.attempts = sum(sum(s["attempts"]) for s in solves[1:])
    run.finite = all(bool(torch.isfinite(s["final"]["mean"]).all()) for s in solves)
