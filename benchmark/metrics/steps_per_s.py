"""Accepted steps completed in the window over the window's seconds, the
device drained at its end (host clock)."""


def read(ctx):
    return ctx.steps / ctx.window_s
