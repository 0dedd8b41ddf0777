"""Differential operators: callables mapping functions to functions.

Counterpart of the parts of :mod:`pnmol_tpu.diffops` the heat equation
uses, on ``torch.func``: operators push through kernel functions
(``diffop(k.pairwise, argnums=0)``) for probabilistic finite differences
and compose with ``torch.func.vmap``.
"""

import typing

import torch
from torch.func import grad, jacrev


class DifferentialOperator:
    """A transform ``fun -> fun``.

    The wrapped transform receives ``(fun, argnums)``; ``argnums`` selects
    which argument the derivative acts on (two-argument kernels).
    """

    def __init__(self, transform: typing.Callable):
        self._transform = transform

    def __call__(self, fun: typing.Callable, argnums: int = 0) -> typing.Callable:
        return self._transform(fun, argnums=argnums)


def divergence():
    """Divergence as the trace of the Jacobian."""

    def transform(fun, argnums=0):
        jac = jacrev(fun, argnums=argnums)
        return lambda *args: torch.trace(jac(*args))

    return DifferentialOperator(transform)


def gradient():
    """Gradient of a scalar-valued function."""

    def transform(fun, argnums=0):
        def as_scalar(*args):
            return fun(*args).squeeze()

        return grad(as_scalar, argnums=argnums)

    return DifferentialOperator(transform)


def laplace():
    """Laplace operator, implemented as divergence(gradient(.))."""

    def transform(fun, argnums=0):
        return divergence()(gradient()(fun, argnums=argnums), argnums=argnums)

    return DifferentialOperator(transform)
