"""Differential operators: callables mapping functions to functions.

Counterpart of :mod:`pnmol_tpu.diffops` on ``torch.func``: the same algebra
(``+ - * @``, ``compose_with``) and the same factories (divergence,
gradient, gradient_by_dimension, directional_derivative, laplace, identity,
power, scalar_mult, constant). Operators push through kernel functions
(``diffop(k.pairwise, argnums=0)``) for probabilistic finite differences
and compose with ``torch.func.vmap``.
"""

import operator
import typing

import numpy as np
import torch
from torch.func import grad, jacrev


class DifferentialOperator:
    """A transform ``fun -> fun`` supporting pointwise algebra and composition.

    The wrapped transform receives ``(fun, argnums)``; ``argnums`` selects
    which argument the derivative acts on (two-argument kernels).
    """

    def __init__(self, transform: typing.Callable):
        self._transform = transform

    def __call__(self, fun: typing.Callable, argnums: int = 0) -> typing.Callable:
        return self._transform(fun, argnums=argnums)

    def __repr__(self):
        return "<DifferentialOperator object>"

    def _pointwise(self, other, binop):
        def combined(fun, argnums=0):
            left = self(fun, argnums=argnums)
            right = other(fun, argnums=argnums)

            def evaluate(*args):
                return binop(left(*args), right(*args))

            return evaluate

        return DifferentialOperator(combined)

    def __add__(self, other):
        return self._pointwise(other, operator.add)

    def __sub__(self, other):
        return self._pointwise(other, operator.sub)

    def __mul__(self, other):
        return self._pointwise(other, operator.mul)

    def __matmul__(self, other):
        def matmul_like(a, b):
            if a.ndim < 1:
                a = a.reshape(-1, 1)
            if b.ndim < 1:
                b = b.reshape(1, -1)
            return a @ b

        return self._pointwise(other, matmul_like)

    def compose_with(self, other: "DifferentialOperator") -> "DifferentialOperator":
        """Operator composition: (self o other)(fun) = self(other(fun))."""

        def composed(fun, argnums=0):
            return self(other(fun, argnums=argnums), argnums=argnums)

        return DifferentialOperator(composed)


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


def gradient_by_dimension(output_coordinate=0):
    """Jacobian row of a vector-valued function for one output coordinate."""

    def transform(fun, argnums=0):
        jac = jacrev(fun, argnums=argnums)
        return lambda *args: jac(*args)[output_coordinate]

    return DifferentialOperator(transform)


def directional_derivative(direction):
    """Advection operator ``v . grad(.)`` with a constant velocity ``v``; ``v``
    becomes a tensor on the gradient's device and dtype where it is applied."""
    v = np.asarray(direction, dtype=np.float64)

    def transform(fun, argnums=0):
        grad_fun = gradient()(fun, argnums=argnums)

        def evaluate(*args):
            g = grad_fun(*args)
            return torch.dot(torch.as_tensor(v, dtype=g.dtype, device=g.device), g)

        return evaluate

    return DifferentialOperator(transform)


def laplace():
    """Laplace operator, implemented as divergence(gradient(.))."""

    def transform(fun, argnums=0):
        return divergence()(gradient()(fun, argnums=argnums), argnums=argnums)

    return DifferentialOperator(transform)


def identity():
    """Identity operator."""
    return DifferentialOperator(lambda fun, argnums=0: fun)


def power(order):
    """Pointwise power: fun -> fun**order."""

    def transform(fun, argnums=0):
        return lambda *args: fun(*args) ** order

    return DifferentialOperator(transform)


def scalar_mult(scalar):
    """Pointwise scaling: fun -> scalar * fun."""

    def transform(fun, argnums=0):
        return lambda *args: scalar * fun(*args)

    return DifferentialOperator(transform)


def constant(scalar):
    """Constant operator: fun -> (x -> scalar)."""

    def transform(fun, argnums=0):
        return lambda *args: scalar

    return DifferentialOperator(transform)
