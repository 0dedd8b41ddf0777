"""Host milliseconds per attempted step spent issuing it: the time inside
the program's ``pnmol.step`` spans, less the sync calls within them
(:data:`harness.spans.SYNC_CALLS`). Where it comes near the step's own
time, the host sets the pace. None without the program's spans."""

from harness import spans


def read(ctx):
    steps = spans.steps(ctx)
    return None if steps is None else spans.issue_ms(ctx, steps)
