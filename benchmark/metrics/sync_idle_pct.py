"""Share of the traced window in which the device idles because the host
synchronized: the idle stretches that open (the device's last activity
ends) while the host is inside a sync call (:data:`harness.spans.SYNC_CALLS`)
within one of the program's ``pnmol.`` spans, summed whole, over the window.
None without the program's spans."""

import bisect

from harness import spans


def read(ctx):
    if spans.steps(ctx) is None:
        return None
    program = spans.merged(spans.named(ctx.trace, lambda name: name.startswith(spans.PREFIX)))
    waits = spans.merged(spans.inside(spans.syncs(ctx.trace), program))
    starts = [s for s, _ in waits]
    idle = 0.0
    for opens, seconds in spans.idle_gap_openings(ctx.trace):
        i = bisect.bisect_right(starts, opens) - 1
        if i >= 0 and opens <= waits[i][1]:
            idle += seconds
    return 100.0 * idle / ctx.trace.window_s
