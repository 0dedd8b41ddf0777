"""Host milliseconds per attempted step spent issuing its blocked LQ
sweeps: the time inside the program's ``pnmol.lq.sweep`` spans that lie in
a ``pnmol.step``, less the sync calls within them
(:data:`harness.spans.SYNC_CALLS`). None without the program's spans."""

from harness import spans


def read(ctx):
    steps = spans.steps(ctx)
    if steps is None:
        return None
    sweeps = spans.inside(spans.named(ctx.trace, lambda name: name == spans.SWEEP), steps)
    return spans.issue_ms(ctx, sweeps)
