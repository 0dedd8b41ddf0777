"""The program's spans in the traced window, and the host's synchronizing
CUDA calls among them, for the readers of ``metrics/`` that take the host's
side of the trace (``ctx.trace.host``: ``(name, start_s, end_s)`` on the
window's clock).

The program (``pnmol_tpu_torch``) names its spans ``pnmol.<layer>...``; one
``pnmol.step`` is one attempted step. A program without them, or a trace
whose ``pnmol.step`` count differs from the window's attempts, gives the
readers nothing to read: they return None.

A sync call is a CUDA runtime call that blocks the host until the device
has done the work before it: ``cudaStreamSynchronize`` (what a copy from
pageable host memory and a read of a device scalar end in),
``cudaDeviceSynchronize``, ``cudaEventSynchronize`` and ``cudaMemcpy``, the
synchronous copy. In the H100 traces of the three cells every sync call
inside a ``pnmol.step`` is a ``cudaStreamSynchronize`` (each after a
``cudaMemcpyAsync``, which is asynchronous and not counted); the window's one
``cudaDeviceSynchronize`` is the harness's drain, outside the program.
"""

import bisect

PREFIX = "pnmol."
STEP = PREFIX + "step"
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


def merged(intervals):
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(x) for x in out]


def inside(events, spans):
    """The ``(start, end)`` events that lie within one of ``spans`` (sorted
    and disjoint, as :func:`merged` gives them)."""
    starts = [s for s, _ in spans]
    out = []
    for start, end in events:
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and end <= spans[i][1]:
            out.append((start, end))
    return out


def named(trace, match):
    """``(start, end)`` of the host events whose name satisfies ``match``."""
    return [(s, e) for name, s, e in trace.host if match(name)]


def steps(ctx):
    """The window's ``pnmol.step`` spans, sorted, where the trace is on and
    holds one for each attempt of the window; None otherwise."""
    if ctx.trace is None or not ctx.attempts:
        return None
    spans = sorted(named(ctx.trace, lambda name: name == STEP))
    return spans if len(spans) == ctx.attempts else None


def syncs(trace):
    """``(start, end)`` of the host's sync calls."""
    return named(trace, lambda name: name in SYNC_CALLS)


def issue_ms(ctx, spans):
    """Host milliseconds inside ``spans`` (disjoint), less the sync calls
    within them, over the window's attempts."""
    spans = merged(spans)
    total = sum(e - s for s, e in spans)
    waiting = sum(e - s for s, e in inside(syncs(ctx.trace), spans))
    return 1e3 * (total - waiting) / ctx.attempts


def idle_gap_openings(trace):
    """``(opens_s, seconds)`` of each stretch of the window with nothing on
    the device: it opens where the device's last activity ends."""
    gaps, end = [], 0.0
    for s, e in merged((s, e) for _, s, e in trace.device):
        if s > end:
            gaps.append((end, s - end))
        end = max(end, e)
    if trace.window_s > end:
        gaps.append((end, trace.window_s - end))
    return gaps
