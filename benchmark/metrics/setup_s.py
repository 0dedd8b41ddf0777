"""From the start of the process to a warmed-up program: imports, the
kernels' loading (and building, on a checkout's first run), the
discretization, the initialization and the set-up steps (host clock)."""


def read(ctx):
    return ctx.setup_s
