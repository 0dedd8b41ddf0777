"""The device memory the program held at its peak over set-up and window:
``torch.cuda.max_memory_allocated``, read before the check runs."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2**30
