"""The solver's ``initialize`` (the first yield of ``solution_generator``),
synchronized on both sides (host clock)."""


def read(ctx):
    return ctx.init_s
