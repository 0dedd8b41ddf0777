"""One trajectory of constant steps, initialized in set-up and stepped
``chain_steps`` times there (the steps the reference follows from its own
initialization), then stepped through the window. One window step, drawn
from the seed among the first ``window_check_max``, is checked from the
program's own state before it: that state goes to pinned host memory on a
side stream as the window runs, and the step's summary to pinned buffers
made in set-up."""

import time

import numpy as np
import torch


def drive(run):
    settings, cuda = run.cell.settings, run.cuda
    gen, state = run.initialize()
    chain = run.program["chain"] = [run.to_host(run.summary(state))]
    for _ in range(settings["chain_steps"]):
        state, _ = next(gen)
        chain.append(run.to_host(run.summary(state)))
    rng = np.random.default_rng([run.seed, 1])
    check_at = 1 + int(rng.integers(settings["window_check_max"]))
    mean_buf = torch.empty(state.y.mean.shape, dtype=state.y.mean.dtype, pin_memory=cuda)
    cov_buf = torch.empty(state.y.cov_sqrtm.shape, dtype=state.y.cov_sqrtm.dtype,
                          pin_memory=cuda)
    copies = torch.cuda.Stream() if cuda else None
    output = run.pinned_like(run.summary(state))  # the checked window step's summary

    def keep_input(state):
        """The state that window step ``check_at`` starts from, to the host."""
        if not cuda:
            mean_buf.copy_(state.y.mean)
            cov_buf.copy_(state.y.cov_sqrtm)
            return
        copies.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(copies):
            mean_buf.copy_(state.y.mean, non_blocking=True)
            cov_buf.copy_(state.y.cov_sqrtm, non_blocking=True)
        state.y.mean.record_stream(copies)
        state.y.cov_sqrtm.record_stream(copies)

    keep_input(state)  # warms the copy path; window step 1 starts here
    with run.window() as t0:
        while True:
            if run.steps == check_at - 1:
                keep_input(state)
            with run.span("harness.step"):
                try:
                    state, _ = next(gen)
                except StopIteration:
                    raise RuntimeError("the trajectory reached its horizon inside the "
                                       "window: raise the traffic mix's tmax") from None
            run.marks.mark()
            run.steps += 1
            if run.steps == check_at:
                run.copy_into(output, run.summary(state))
            if run.steps >= check_at and time.perf_counter() - t0 >= run.seconds:
                break
    run.attempts = run.steps
    run.finite = bool(torch.isfinite(state.y.mean).all())
    run.program["window"] = {"input_mean": mean_buf, "input_factor": cov_buf,
                             "output": output}
