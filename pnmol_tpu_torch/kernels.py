"""Covariance kernels with shape-polymorphic Gram evaluation.

Counterpart of :mod:`pnmol_tpu.kernels`, with the same call convention:
scalar pair -> scalar; equal-shape ``(N, d)`` inputs -> diagonal ``(N,)``;
``(N, d) x (d, K)`` -> full Gram ``(N, K)`` (callers pass ``k(X, Y.T)``).
Pairwise functions are batched with ``torch.func.vmap``, so they must stay
vmap-safe: no Python branching on tensor values. ``duplicate`` stacks one
kernel into the block-diagonal prior of a PDE system, and the input scale
is calibrated by maximum likelihood, on a grid of trials
(:func:`mle_input_scale`) or by gradient steps
(:func:`mle_input_scale_gradient`).
"""

import abc
import dataclasses
import math

import torch
from torch.func import vmap

from pnmol_tpu_torch.ops import gram


class Kernel(abc.ABC):
    """Covariance kernel interface."""

    #: True if k(x, y) depends on x - y only (enables stencil dedupe).
    stationary: bool = False

    @abc.abstractmethod
    def __call__(self, X, Y):
        raise NotImplementedError


def _gram_dispatch(pairwise, X, Y):
    """Shape-polymorphic evaluation of a pairwise kernel function."""
    if X.ndim <= 1 and Y.ndim <= 1 and X.ndim == Y.ndim:
        return pairwise(X, Y)
    if X.shape == Y.shape:
        return vmap(pairwise, in_dims=(0, 0))(X, Y)
    # Full Gram matrix: X (N, d), Y (d, K) -> (N, K)
    row = vmap(pairwise, in_dims=(0, None))
    return vmap(row, in_dims=(None, 1), out_dims=1)(X, Y)


class PairwiseKernel(Kernel):
    """Kernel defined through a function of two points."""

    @abc.abstractmethod
    def pairwise(self, x, y):
        raise NotImplementedError

    def __call__(self, X, Y):
        return _gram_dispatch(self.pairwise, X, Y)

    def __add__(self, other):
        self_pairwise, other_pairwise = self.pairwise, other.pairwise

        def summed(x, y):
            return self_pairwise(x, y) + other_pairwise(x, y)

        out = Lambda(summed)
        out.stationary = self.stationary and getattr(other, "stationary", False)
        return out


class Lambda(PairwiseKernel):
    """Wrap an arbitrary pairwise function as a kernel."""

    def __init__(self, fun, /):
        self._fun = fun

    def pairwise(self, x, y):
        return self._fun(x, y)


def _sqdist(x, y):
    diff = x - y
    return torch.dot(diff, diff)


@dataclasses.dataclass(frozen=True)
class RadialKernel(PairwiseKernel):
    r"""k(x, y) = output_scale^2 * phi(||x - y|| * input_scale).

    Full Grams take the distance trick ``|x|^2 + |y|^2 - 2 x.y`` on centred
    points, fused with the radial profile (:mod:`pnmol_tpu_torch.ops.gram`),
    with the JAX package's dispatch rule: the CUDA kernel for a full Gram of
    at least ``_PALLAS_MIN_ELEMS`` elements on a CUDA tensor with Python-float
    scales, the plain version otherwise (which also keeps the kernel out of
    the vmapped stencil Grams of the FD layer). The pairwise form is the
    autodiff surface of the discretization layer.
    """

    input_scale: float = 1.0
    output_scale: float = 1.0

    stationary = True

    # subclass marker for the fused Gram path (None disables it)
    _PHI_NAME = None
    _PALLAS_MIN_ELEMS = 512 * 512

    def __call__(self, X, Y):
        if (
            self._PHI_NAME is not None
            and X.ndim == 2
            and Y.ndim == 2
            and X.shape != Y.shape
            and X.shape[1] == Y.shape[0]
        ):
            # Full-Gram convention: callers pass (X, Y.T).
            points_y = Y.T
            static_scales = isinstance(self.input_scale, (int, float)) and isinstance(
                self.output_scale, (int, float)
            )
            gram_fn = (
                gram.gram_radial
                if static_scales
                and X.device.type == "cuda"
                and X.shape[0] * points_y.shape[0] >= self._PALLAS_MIN_ELEMS
                else gram.gram_radial_reference
            )
            return gram_fn(
                X, points_y, self.input_scale, self.output_scale, phi_name=self._PHI_NAME
            )
        return _gram_dispatch(self.pairwise, X, Y)


@dataclasses.dataclass(frozen=True)
class SquareExponential(RadialKernel):
    _PHI_NAME = "squared_exponential"

    def pairwise(self, x, y):
        r2 = _sqdist(x, y) * self.input_scale**2
        return self.output_scale**2 * torch.exp(-r2 / 2.0)


@dataclasses.dataclass(frozen=True)
class Matern52(RadialKernel):
    """Matern(5/2). Not twice differentiable at x = y; the discretization
    layer patches the removable singularity."""

    _PHI_NAME = "matern52"

    def pairwise(self, x, y):
        r2 = _sqdist(x, y)
        scaled = torch.sqrt(5.0 * r2 * self.input_scale**2)
        poly = 1.0 + scaled + scaled**2 / 3.0
        return self.output_scale**2 * poly * torch.exp(-scaled)


@dataclasses.dataclass(frozen=True)
class Polynomial(PairwiseKernel):
    """k(x, y) = (x . y + const)^order."""

    order: int = 2
    const: float = 1.0

    def pairwise(self, x, y):
        return (torch.dot(x, y) + self.const) ** self.order


@dataclasses.dataclass(frozen=True)
class WhiteNoise(PairwiseKernel):
    """k(x, y) = output_scale^2 * 1[x == y]."""

    output_scale: float = 1.0

    stationary = True

    def pairwise(self, x, y):
        return self.output_scale**2 * torch.all(x == y).to(x.dtype)


class StackedKernel(Kernel):
    """Stack of kernels whose Gram matrix is block-diagonal (PDE systems):
    equal-shape inputs give the concatenated diagonals, a full-Gram call the
    block-diagonal of the kernels' Grams."""

    def __init__(self, *, kernel_list):
        self.kernel_list = list(kernel_list)

    def __call__(self, X, Y):
        grams = [k(X, Y) for k in self.kernel_list]
        if X.shape == Y.shape:
            return torch.cat(grams)
        return torch.block_diag(*grams)


def duplicate(kernel, num):
    """``num`` copies of ``kernel`` stacked into a block-diagonal Gram."""
    return StackedKernel(kernel_list=[kernel] * num)


# ---------------------------------------------------------------------------
# Hyperparameter calibration
# ---------------------------------------------------------------------------


def log_likelihood(gram_matrix, y, n):
    """GP log marginal likelihood through one Cholesky factorization; NaN
    where the Gram is not numerically positive definite, as
    ``jnp.linalg.cholesky`` gives there (``torch.linalg.cholesky`` raises,
    so this takes ``cholesky_ex`` and its ``info``)."""
    chol, info = torch.linalg.cholesky_ex(gram_matrix)
    white = torch.linalg.solve_triangular(chol, y[:, None], upper=False)[:, 0]
    maha = white @ white
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    value = -0.5 * (maha + logdet + n * math.log(2.0 * math.pi))
    return torch.where(info == 0, value, torch.full_like(value, float("nan")))


def input_scale_to_log_likelihood(input_scale, mesh_points, data, kernel_type):
    """Log likelihood of ``data`` under ``kernel_type(input_scale=...)``; a
    Python-float scale takes the kernel's Gram dispatch (the CUDA kernel for
    large CUDA Grams), a tensor scale the plain Gram, which autograd follows."""
    kernel = kernel_type(input_scale=input_scale)
    K = kernel(mesh_points, mesh_points.T)
    return log_likelihood(gram_matrix=K, y=data, n=data.shape[0])


def mle_input_scale_gradient(
    *, mesh_points, data, kernel_type, initial_scale=1.0, num_steps=100,
    learning_rate=0.1
):
    """Gradient-based MLE of the input scale: Adam on the log-scale, with
    optax's defaults (betas 0.9/0.999, eps 1e-8). Returns the scale as a
    float."""
    n = data.shape[0]
    eye = torch.eye(n, dtype=data.dtype, device=data.device)
    log_scale = torch.log(
        torch.tensor(float(initial_scale), dtype=data.dtype, device=data.device)
    ).requires_grad_()
    optimizer = torch.optim.Adam([log_scale], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(num_steps):
        optimizer.zero_grad()
        kernel = kernel_type(input_scale=torch.exp(log_scale))
        gram = kernel(mesh_points, mesh_points.T) + 1e-10 * eye
        (-log_likelihood(gram_matrix=gram, y=data, n=n)).backward()
        optimizer.step()
    return float(torch.exp(log_scale.detach()))


def mle_input_scale(*, mesh_points, data, kernel_type, input_scale_trials):
    """Grid-search MLE of the input scale: trial by trial with Python-float
    scales; NaN likelihoods (singular Grams at tiny scales) are masked to
    -inf so the argmax picks the best valid trial. Returns the chosen entry
    of ``input_scale_trials``."""
    values = torch.stack([
        input_scale_to_log_likelihood(float(scale), mesh_points, data, kernel_type)
        for scale in torch.as_tensor(input_scale_trials).tolist()
    ])
    values = torch.where(torch.isnan(values), torch.full_like(values, -math.inf), values)
    return input_scale_trials[int(torch.argmax(values))]
