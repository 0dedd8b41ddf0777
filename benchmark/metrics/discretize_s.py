"""The problem recipe's discretization on the card, synchronized on both
sides (host clock): mesh, k-NN, stencil weights, ``L``, ``E_sqrtm``, ``B``."""


def read(ctx):
    return ctx.discretize_s
