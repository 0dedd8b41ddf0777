"""The port's differential-operator algebra against the JAX package: every
case of tests/test_diffops.py on the same function and point through both
packages, the directional derivative, and the advection-diffusion operator
pushed through a kernel and batched by ``torch.func.vmap``, as
``fd_probabilistic`` batches it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu import diffops as jdiffops
from pnmol_tpu import discretize as jdiscretize
from pnmol_tpu import kernels as jkernels
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import diffops

torch.set_num_threads(1)

# both packages differentiate the same closed forms in f64: they agree to
# rounding (measured: equal, or 1 ulp)
RTOL = 1e-13
X0 = np.ones(2)


def norm_sq(lib):
    return lambda x: lib.linalg.norm(x) ** 2


def cubic(lib):
    return lambda x: lib.stack([x[0] ** 2, x[1] ** 3])


def times_three(lib):
    return lambda x: 3.0 * x


def kpz(d):
    """KPZ operator: nu lap f + lambda (grad f)^2 + eta (pointwise products
    after application)."""
    return (d.scalar_mult(2.0) * d.laplace()
            + d.scalar_mult(3.0) * (d.gradient() @ d.gradient()) + d.constant(4.0))


# name: (operator of a diffops module, function of a numerics module, value)
CASES = {
    "identity": (lambda d: d.identity(), norm_sq, 2.0),
    "power": (lambda d: d.power(3), norm_sq, 8.0),
    "laplace": (lambda d: d.laplace(), norm_sq, 4.0),
    "gradient": (lambda d: d.gradient(), norm_sq, [2.0, 2.0]),
    "divergence": (lambda d: d.divergence(), times_three, 6.0),
    "gradient_by_dimension": (lambda d: d.gradient_by_dimension(0), cubic, [2.0, 0.0]),
    "gradient_by_dimension_1": (lambda d: d.gradient_by_dimension(1), cubic, [0.0, 3.0]),
    "algebra_add_mul": (lambda d: d.identity() + d.power(3) * d.laplace(), norm_sq,
                        2.0 + 8.0 * 4.0),
    "algebra_sub": (lambda d: d.identity() - d.laplace(), norm_sq, 2.0 - 4.0),
    "compose": (lambda d: d.power(3).compose_with(d.laplace()), norm_sq, 64.0),
    "matmul": (lambda d: d.gradient() @ d.gradient(), norm_sq, 8.0),
    "matmul_scalars": (lambda d: d.laplace() @ d.identity(), norm_sq, [[8.0]]),
    "scalar_mult": (lambda d: d.scalar_mult(5.0), norm_sq, 10.0),
    "constant": (lambda d: d.constant(7.0), norm_sq, 7.0),
    "kpz": (kpz, norm_sq, 2.0 * 2.0 * 4.0 + 3.0 * 2.0 * 8.0 + 4.0),
    "directional_derivative": (lambda d: d.directional_derivative([2.0, -1.0]), norm_sq,
                               2.0 * 2.0 - 2.0),
    "advection_diffusion": (
        lambda d: d.scalar_mult(0.05).compose_with(d.laplace())
        - d.directional_derivative([1.0, 0.5]), norm_sq, 0.05 * 4.0 - 3.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_matches_jax(case):
    op, fun, value = CASES[case]
    got = op(diffops)(fun(torch))(torch.tensor(X0))
    want = np.asarray(op(jdiffops)(fun(jnp))(jnp.asarray(X0)))
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got, value, rtol=RTOL, atol=0)


def test_matmul_of_gradients_contracts_to_a_scalar():
    val = (diffops.gradient() @ diffops.gradient())(norm_sq(torch))(torch.tensor(X0))
    assert val.shape == ()


def test_argnums_differentiates_the_second_argument():
    def k(lib):
        return lambda x, y: lib.dot(x - y, x - y)

    x, y = np.ones(2), np.zeros(2)
    got = diffops.gradient()(k(torch), argnums=1)(torch.tensor(x), torch.tensor(y))
    want = jdiffops.gradient()(k(jnp), argnums=1)(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=0)
    np.testing.assert_allclose(got.numpy(), -2.0 * (x - y), rtol=RTOL, atol=0)


def test_directional_derivative_takes_the_operands_dtype():
    op = diffops.directional_derivative([2.0, -1.0])
    x = torch.tensor([1.0, 3.0], dtype=torch.float32)
    out = op(norm_sq(torch))(x)
    assert out.dtype == torch.float32
    assert float(out) == pytest.approx(2.0 * 2.0 - 6.0)
    assert repr(op) == "<DifferentialOperator object>"


@pytest.mark.parametrize("dim", [2, 3])
def test_advection_diffusion_through_a_kernel_under_vmap(dim):
    """L k and (L x L) k of kappa lap - v . grad pushed through the squared
    exponential, evaluated on a batch of point pairs by vmap (the stencil
    batch of fd_probabilistic), against JAX's."""
    velocity = [1.0, 0.5, 0.25][:dim]

    def op(d):
        return (d.scalar_mult(0.05).compose_with(d.laplace())
                - d.directional_derivative(velocity))

    rng = np.random.default_rng(dim)
    x, y = rng.uniform(size=(2, 7, dim))
    L_k, LL_k = pt.discretize._differentiate_kernel(
        op(diffops), pt.kernels.SquareExponential(input_scale=3.0))
    jL_k, jLL_k = jdiscretize._differentiate_kernel(
        op(jdiffops), jkernels.SquareExponential(input_scale=3.0))
    tx, ty = torch.tensor(x), torch.tensor(y)
    for got, want in ((L_k(tx, ty), jL_k(x, y)), (LL_k(tx, ty), jLL_k(x, y)),
                      (L_k(tx, ty.T), jL_k(x, y.T)), (LL_k(tx, ty.T), jLL_k(x, y.T))):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-13 * np.abs(want).max())
