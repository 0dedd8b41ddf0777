"""Attempts per accepted step over the window (the solver's ``info``
counts): above 1, the step-size controller rejects work."""


def read(ctx):
    return ctx.attempts / ctx.steps if ctx.steps else None
