"""Host sync calls (:data:`harness.spans.SYNC_CALLS`) inside the program's
``pnmol.step`` spans, per attempted step: the copies from pageable host
memory, the device scalars read on the host and the other waits that one
attempt makes the host take. None without the program's spans."""

from harness import spans


def read(ctx):
    steps = spans.steps(ctx)
    if steps is None:
        return None
    return len(spans.inside(spans.syncs(ctx.trace), steps)) / ctx.attempts
