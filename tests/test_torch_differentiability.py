"""Gradients through the port's default solve, against the JAX package's.

Counterparts of ``tests/test_solvers/test_differentiability.py``: the same
problem (``heat_1d_discretized(dx=0.2, tmax=0.5)``, ``Constant(0.1)``, the
``Matern52() + WhiteNoise()`` prior), 5 steps of the white step function
from the initial state, and the gradient of a loss of the final state with
respect to a scale of one cache operand. The port's gradient is held to
JAX's at 1e-10 relative and to central differences at JAX's rtol 1e-4.
Runs without gradients keep the R-only QR; the kernel routes raise under
autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pnmol_tpu_torch as pt  # noqa: E402
from pnmol_tpu import kernels  # noqa: E402
from pnmol_tpu.models import examples  # noqa: E402
from pnmol_tpu.odetools import step  # noqa: E402
from pnmol_tpu.solvers import white  # noqa: E402
from pnmol_tpu_torch.ops import qr_householder, sqrt  # noqa: E402

NUM_STEPS, DT = 5, 0.1


@pytest.fixture(scope="module")
def jax_setup():
    heat = examples.heat_1d_discretized(dx=0.2, tmax=0.5)
    solver = white.LinearWhiteNoiseEK1(steprule=step.Constant(DT),
                                       spatial_kernel=kernels.Matern52() + kernels.WhiteNoise())
    return heat, solver, solver.initialize(heat)


@pytest.fixture(scope="module")
def port_setup():
    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device="cpu")
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(DT),
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise())
    return heat, solver, solver.initialize(heat)


def _jax_rollout(cache, mean, cov):
    step_fn = white.make_white_step_fn(cache=cache, num_derivatives=2, f=None, df=None,
                                       linear=True)

    def body(carry, t_next):
        m, c = carry
        m, c, _, _, diff = step_fn(m, c, t_next, jnp.asarray(DT))
        return (m, c), diff

    (m, c), diffs = jax.lax.scan(body, (mean, cov), DT * jnp.arange(1, NUM_STEPS + 1))
    return m, diffs


def _port_rollout(cache, mean, cov, factorization=None):
    diffs = []
    for k in range(1, NUM_STEPS + 1):
        mean, cov, _, _, diff = pt.white.white_attempt_step(
            cache, mean, cov, k * DT, DT, num_derivatives=2, factorization=factorization)
        diffs.append(diff)
    return mean, torch.stack(diffs)


def _diffusion_scale_losses(jax_setup, port_setup):
    heat_j, solver_j, state_j = jax_setup
    heat, solver, state = port_setup
    base_j = heat_j.L / heat_j.diffop_scale
    base = heat.L / heat.diffop_scale

    def loss_j(scale):
        cache = solver_j._cache._replace(L=scale * base_j)
        m, _ = _jax_rollout(cache, state_j.y.mean, state_j.y.cov_sqrtm)
        return jnp.sum(m[0] ** 2)

    def loss(scale, factorization=None):
        cache = solver._cache._replace(L=scale * base)
        m, _ = _port_rollout(cache, state.y.mean, state.y.cov_sqrtm, factorization)
        return torch.sum(m[0] ** 2)

    return loss_j, loss


def _error_factor_losses(jax_setup, port_setup):
    _, solver_j, state_j = jax_setup
    _, solver, state = port_setup
    E_j = solver_j._cache.E_bc_sqrtm
    E = solver._cache.E_bc_sqrtm
    eye = torch.eye(E.shape[0], dtype=E.dtype)

    def loss_j(noise_scale):
        cache = solver_j._cache._replace(E_bc_sqrtm=noise_scale * E_j
                                         + 1e-8 * jnp.eye(E_j.shape[0]))
        _, diffs = _jax_rollout(cache, state_j.y.mean, state_j.y.cov_sqrtm)
        return jnp.mean(diffs)

    def loss(noise_scale):
        cache = solver._cache._replace(E_bc_sqrtm=noise_scale * E + 1e-8 * eye)
        _, diffs = _port_rollout(cache, state.y.mean, state.y.cov_sqrtm)
        return torch.mean(diffs)

    return loss_j, loss


def _grad(loss, at):
    x = torch.tensor(at, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(x), x)
    return g.item()


def test_grad_through_solve_wrt_diffusion_scale(jax_setup, port_setup):
    """d(final solution)/d(diffusion rate): JAX's gradient to 1e-10, central
    differences to JAX's rtol 1e-4."""
    loss_j, loss = _diffusion_scale_losses(jax_setup, port_setup)
    g_j = float(jax.grad(loss_j)(0.035))
    g = _grad(loss, 0.035)
    assert np.isfinite(g)
    assert abs(g - g_j) <= 1e-10 * abs(g_j)
    eps = 1e-6
    with torch.no_grad():
        up, down = (loss(torch.tensor(0.035 + s * eps, dtype=torch.float64)) for s in (1, -1))
        fd = (up - down).item() / (2 * eps)
    assert np.isclose(g, fd, rtol=1e-4)


def test_grad_through_calibration_wrt_error_factor(jax_setup, port_setup):
    """The diffusion quasi-MLE differentiates in the measurement noise: more
    assumed noise, smaller whitened residuals; JAX's gradient to 1e-10."""
    loss_j, loss = _error_factor_losses(jax_setup, port_setup)
    g_j = float(jax.grad(loss_j)(1.0))
    g = _grad(loss, 1.0)
    assert np.isfinite(g)
    assert g < 0.0
    assert abs(g - g_j) <= 1e-10 * abs(g_j)


def test_runs_without_gradients_keep_the_r_only_qr(port_setup, monkeypatch):
    """``triu_qr`` asks for ``mode="r"`` unless autograd records through its
    operand, and the two modes give the same R."""
    modes = []
    qr = torch.linalg.qr

    def recording_qr(mat, mode="reduced"):
        modes.append(mode)
        return qr(mat, mode=mode)

    monkeypatch.setattr(torch.linalg, "qr", recording_qr)
    mat = torch.tensor(np.random.default_rng(0).normal(size=(9, 5)))
    R = sqrt.triu_qr(mat)
    with torch.no_grad():
        sqrt.triu_qr(mat.clone().requires_grad_())
    R_grad = sqrt.triu_qr(mat.clone().requires_grad_())
    assert modes == ["r", "r", "reduced"]
    assert torch.equal(R, R_grad.detach())

    heat, solver, state = port_setup
    modes.clear()
    _port_rollout(solver._cache, state.y.mean, state.y.cov_sqrtm)
    assert modes and set(modes) == {"r"}


@pytest.mark.parametrize("route", ["panel_lq", "leaf_lq", "leaf_qr"])
def test_kernel_routes_raise_under_autograd(route):
    """The kernel wrappers have no backward: a slab that autograd records
    through raises (on the CPU as on the card), naming the plain route."""
    slab = torch.tensor(np.random.default_rng(1).normal(size=(4, 12)), requires_grad=True)
    calls = {"panel_lq": lambda x: qr_householder.panel_lq(x, 0),
             "leaf_lq": lambda x: qr_householder.leaf_lq(x, 0),
             "leaf_qr": lambda x: qr_householder.leaf_qr(x.T)}
    with pytest.raises(RuntimeError, match="no backward.*factorization=None"):
        calls[route](slab)
    with torch.no_grad():
        calls[route](slab)


def test_householder_solver_raises_under_autograd(jax_setup, port_setup):
    """Asking for a gradient through the ``"householder"`` panel route raises
    instead of falling back to the plain factorization."""
    _, loss = _diffusion_scale_losses(jax_setup, port_setup)
    hook = qr_householder.make_householder_lq_factorization(leaf=8, block=16)
    with pytest.raises(RuntimeError, match="no backward"):
        _grad(lambda x: loss(x, hook), 0.035)
