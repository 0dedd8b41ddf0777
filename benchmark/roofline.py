"""The yardstick of the kernels: published peaks of one NVIDIA H100 SXM,
the least time of a Householder panel, and the launches of a step's and of
an initialization's LQ sweeps, computed from shapes alone.

The bound arithmetic is a frozen copy of the port's own measurement script
(``chip_smoke.py``: ``bound`` and ``panel_bound``); the sweep
schedule follows the blocked Householder LQ of
``pnmol_tpu_torch.ops.qr_householder`` as it stands when this benchmark was
written, and readers hold it to the launch counters before they use it.
"""

# NVIDIA H100 SXM data sheet, dense, at 700 W: HBM bandwidth; FP64 on the
# tensor cores, and FP32 outside them
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {8: 67e12, 4: 67e12}
# dynamic shared memory of one CTA on Hopper: the panel kernel's T^T CTA
# holds rows x (rows + 2) values of it
SHARED_BYTES_PER_CTA = 232448


def bound(ops, nbytes, itemsize):
    """``(seconds, bound_by)``: the larger of the bytes over the memory rate
    and the operations over the peak rate of the element size."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[itemsize]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def panel_bound(rows, cols, off, itemsize):
    """Bound of one Householder LQ panel ``(rows, cols)`` whose diagonal
    starts at lane ``off``: reflector k's norm and scaling (3 t flops on its
    tail of t lanes), its dot with every other row and the update of the rows
    below (2 (t + 1) each), and row k of T^T (k (k + 1)); the slab read once,
    LV and T^T written once."""
    ops = 0
    for k in range(rows):
        t = cols - off - k - 1
        ops += 3 * t + (2 * rows - 2 - k) * 2 * (t + 1) + k * (k + 1)
    return bound(ops, (2 * rows * cols + rows * rows) * itemsize, itemsize)


def hooks(d):
    """``(block, leaf)`` of the Householder hooks for ``d`` state points:
    256-row blocks from 4096 points on (else 128), 64-row leaves from 8192
    on (else 32)."""
    return (256 if d >= 4096 else 128), (64 if d >= 8192 else 32)


def takes_rows(rows, itemsize):
    """Whether one panel launch takes a ``rows``-row block (else the leaf route)."""
    return rows * (rows + 2) * itemsize <= SHARED_BYTES_PER_CTA


def sweep_launches(rows, cols, *, block, leaf, band, itemsize):
    """The panel-kernel launches of one LQ sweep of a ``(rows, cols)``
    pre-array: ``(route, rows, cols, off)`` each, route ``"panel_lq"`` (one
    launch a block) or ``"leaf_lq"`` (one a leaf). Each block works on its
    window: the columns left of ``cols - done``, cut to the band
    ``(b0, slope)`` where one is declared."""
    leaves = not takes_rows(block, itemsize)
    out, done = [], 0
    while done < rows:
        b = min(block, rows - done)
        win = cols - done
        if band is not None:
            win = min(win, band[0] + (band[1] - 1) * done + band[1] * b)
        if leaves:
            out.extend(("leaf_lq", min(leaf, b - jl), win, jl) for jl in range(0, b, leaf))
        else:
            out.append(("panel_lq", b, win, 0))
        done += b
    return out


def step_sweeps(*, d, m, n, fused, propagate_band):
    """The ``(rows, cols, band)`` of the LQ sweeps of one white-noise step
    with ``d`` points, ``m`` measurement rows and ``n = nu + 1``: the fused
    pre-array ``(m + D, 2 D + m)``, or the two-QR pipeline's propagate ``(D,
    2 D)`` and update ``(m + D, D + m)``."""
    D = n * d
    if fused:
        band = (2 * D + 1, 1) if propagate_band is not None else None
        return [(m + D, 2 * D + m, band)]
    band = (D + 1, 1) if propagate_band is not None else None
    prop_band = (2 * n, 2) if propagate_band == "interleaved" else band
    return [(D, 2 * D, prop_band), (m + D, D + m, band)]


def step_launches(*, d, m, n, fused, propagate_band, itemsize):
    """Every panel-kernel launch of one step, as :func:`sweep_launches` gives them."""
    block, leaf = hooks(d)
    out = []
    for rows, cols, band in step_sweeps(d=d, m=m, n=n, fused=fused,
                                        propagate_band=propagate_band):
        out.extend(sweep_launches(rows, cols, block=block, leaf=leaf, band=band,
                                  itemsize=itemsize))
    return out


def init_sweeps(*, d, m):
    """The ``(rows, cols, band)`` of the LQ sweep of ``initialize``'s PDE
    update under the Householder factorization: the derivative-{0, 1}
    sub-state's pre-array ``[[H C, R], [C, 0]]``, ``(m + 2 d, 2 d + m)``."""
    return [(m + 2 * d, 2 * d + m, None)]


def init_launches(*, d, m, itemsize):
    """Every panel-kernel launch of one ``initialize``."""
    block, leaf = hooks(d)
    out = []
    for rows, cols, band in init_sweeps(d=d, m=m):
        out.extend(sweep_launches(rows, cols, block=block, leaf=leaf, band=band,
                                  itemsize=itemsize))
    return out


def route_roofline(ctx, route):
    """The window's share, in %, of the panel kernel's roofline on one route
    (``"panel_lq"`` or ``"leaf_lq"``): the least time of every launch the
    sweeps made, by :func:`panel_bound` at the sweep's shapes, over the
    kernel's device time in the trace. The launches are those of every step
    attempted in the window and of every ``initialize`` run inside it. None
    where the trace is off, the route did not run, another route of the same
    kernel ran too, or the launches counted, traced and scheduled disagree."""
    trace = ctx.trace
    if trace is None:
        return None
    routes = ("panel_lq", "leaf_lq", "leaf_qr")
    launched = ctx.counters.get(route, 0)
    if not launched or any(ctx.counters.get(r, 0) for r in routes if r != route):
        return None
    solver = ctx.config["solver"]["solver_kwargs"]
    dims = ctx.dims
    itemsize = dims["itemsize"]
    steps = step_launches(d=dims["d"], m=dims["m"], n=dims["n"], fused=solver["fused"],
                          propagate_band=solver["propagate_band"], itemsize=itemsize)
    inits = init_launches(d=dims["d"], m=dims["m"], itemsize=itemsize)
    scheduled = ctx.attempts * [x for x in steps if x[0] == route] \
        + ctx.inits * [x for x in inits if x[0] == route]
    is_kernel = lambda name: "panel_lq_kernel" in name  # noqa: E731
    if not scheduled or launched != len(scheduled) or trace.count_of(is_kernel) != launched:
        return None
    least = sum(panel_bound(rows, cols, off, itemsize)[0] for _, rows, cols, off in scheduled)
    return 100.0 * least / trace.seconds_of(is_kernel)
