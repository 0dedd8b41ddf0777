"""Device milliseconds of cuBLAS matrix products (kernels named ``gemm``)
per step attempted in the window: the blocked sweeps' trailing updates."""


def read(ctx):
    if ctx.trace is None or not ctx.attempts:
        return None
    seconds = ctx.trace.seconds_of(lambda name: "gemm" in name.lower())
    return 1e3 * seconds / ctx.attempts if seconds else None
