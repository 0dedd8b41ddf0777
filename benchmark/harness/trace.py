"""The profiler over the measured window, and what the readers take from it.

``--trace 1`` runs the window under ``torch.profiler`` with CPU and CUDA
activity, inside a ``harness.window`` span. :class:`Trace` keeps the device
activity (kernels, copies, sets) and the host's operations as ``(name,
start_s, end_s)`` within that span, on the profiler's one clock.
"""

import contextlib

SPAN_PREFIX = "harness."
WINDOW_SPAN = SPAN_PREFIX + "window"


def _raw_events(prof):
    """``(name, is_device, start_ns, end_ns)`` of every profiled event; the
    device-side copies of the host's spans (user annotations) are left out."""
    try:
        events = prof.profiler.kineto_results.events()
        raw = [(e.name(), str(e.device_type()).endswith("CUDA"), e.start_ns(),
                e.start_ns() + e.duration_ns(), e.is_user_annotation()) for e in events]
    except AttributeError:
        raw = [(e.name, str(e.device_type).endswith("CUDA"), e.time_range.start * 1000,
                e.time_range.end * 1000, False) for e in prof.events()]
    return [(name, dev, s, e) for name, dev, s, e, note in raw
            if not (dev and (note or name.startswith(SPAN_PREFIX)))]


def _union_seconds(intervals):
    total, end = 0.0, None
    for start, stop in sorted(intervals):
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


class Trace:
    def __init__(self, prof):
        raw = _raw_events(prof)
        spans = [(s, e) for name, dev, s, e in raw if name == WINDOW_SPAN and not dev]
        if not spans:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        lo, hi = spans[0]
        self.window_s = (hi - lo) * 1e-9
        self.device = [(name, (max(s, lo) - lo) * 1e-9, (min(e, hi) - lo) * 1e-9)
                       for name, dev, s, e in raw if dev and e > lo and s < hi]
        self.host = [(name, (s - lo) * 1e-9, (e - lo) * 1e-9)
                     for name, dev, s, e in raw
                     if not dev and name != WINDOW_SPAN and e > lo and s < hi]
        self.busy_s = _union_seconds([(s, e) for _, s, e in self.device])

    def seconds_of(self, match):
        """Device seconds of the activities whose name satisfies ``match``."""
        return sum(e - s for name, s, e in self.device if match(name))

    def count_of(self, match):
        return sum(1 for name, _, _ in self.device if match(name))

    def device_ops(self, top=10):
        """The device operations that took most time: ``[name, seconds]``."""
        totals = {}
        for name, s, e in self.device:
            totals[name] = totals.get(name, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """The longest stretches with nothing on the device, each named by
        the innermost host operation running at its middle: ``[name,
        seconds]``."""
        gaps, end = [], 0.0
        for s, e in sorted((s, e) for _, s, e in self.device):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window_s > end:
            gaps.append((end, self.window_s))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            mid = 0.5 * (s + e)
            around = [(he - hs, name) for name, hs, he in self.host if hs <= mid <= he]
            out.append([min(around)[1] if around else "host: no operation", e - s])
        return out


@contextlib.contextmanager
def profiled(enabled):
    """Yield a holder whose ``trace`` is the window's :class:`Trace` after
    the block, when ``enabled``; a no-op otherwise."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.trace = Trace(prof)
