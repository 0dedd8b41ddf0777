"""The port's doubling (SDA) solver of the DARE, its residual certificate and
the closed-loop growth estimate, against the JAX package's on the same
seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.ops import dare as jdare
from pnmol_tpu_torch.ops import dare

torch.set_num_threads(1)


def _filter_system(seed, D=12, m=5):
    """A stable filter system ``(A, G, Q)`` with ``G = H^T R^{-1} H``."""
    rng = np.random.default_rng(seed)
    A = 0.9 * rng.standard_normal((D, D)) / np.sqrt(D) + 0.3 * np.eye(D)
    H = rng.standard_normal((m, D)) / np.sqrt(D)
    Lq = np.tril(rng.standard_normal((D, D))) / np.sqrt(D)
    Q = Lq @ Lq.T + 1e-3 * np.eye(D)
    Lr = np.tril(rng.standard_normal((m, m)))
    R = Lr @ Lr.T + 1e-2 * np.eye(m)
    return A, H.T @ np.linalg.solve(R, H), Q


def _slow_system():
    """A slow-mixing closed loop (contraction 1 - 1e-4): the plain recursion
    needs O(1e4) iterations, the doubling a handful."""
    A = np.diag([0.9999, 0.999, 0.99, 0.9, 0.5, 0.1])
    H = np.eye(2, 6)
    return A, H.T @ H, 1e-4 * np.eye(6)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


SYSTEMS = {"seed0": lambda: _filter_system(0), "seed1": lambda: _filter_system(1),
           "d24": lambda: _filter_system(2, D=24, m=9), "slow": _slow_system}


@pytest.mark.parametrize("system", list(SYSTEMS))
@pytest.mark.parametrize("solver", ["qr", "chol"])
def test_sda_matches_jax(system, solver):
    """The same doubling iterates in both packages: sigma to rel 1e-10 (LAPACK
    against XLA rounding, compounded over the quadratic composition), equal
    iteration counts, and the JAX package's own convergence statements."""
    A, G, Q = SYSTEMS[system]()
    want = jdare.sda(jnp.asarray(A), jnp.asarray(G), jnp.asarray(Q), tol=1e-13,
                     solver=solver)
    got = dare.sda(*(torch.from_numpy(x) for x in (A, G, Q)), tol=1e-13, solver=solver)
    assert got.iterations == int(want.iterations) < 64
    assert _rel(got.sigma, want.sigma) <= 1e-10
    assert got.anorm <= 1e-10 * np.abs(A).max()


@pytest.mark.parametrize("system", ["seed0", "seed1", "slow"])
def test_dare_residual_matches_jax(system):
    """The certificate at the SDA fixed point (both below 1e-9) and at a
    perturbed point (rel 1e-10)."""
    A, G, Q = SYSTEMS[system]()
    sigma = np.array(jdare.sda(jnp.asarray(A), jnp.asarray(G), jnp.asarray(Q), tol=1e-13).sigma)
    perturbed = sigma + 1e-3 * np.abs(sigma).max() * np.eye(sigma.shape[0])
    for point in (sigma, perturbed):
        want = float(jdare.dare_residual(*(jnp.asarray(x) for x in (point, A, G, Q))))
        got = dare.dare_residual(*(torch.from_numpy(x) for x in (point, A, G, Q))).item()
        if point is sigma:
            assert got < 1e-9 and want < 1e-9
        else:
            assert got == pytest.approx(want, rel=1e-10)


def test_sda_default_solver_is_qr_below_the_threshold():
    """Below CHOL_MIN_SIZE (4096, the JAX package's switch) the default body
    is the QR one, bitwise."""
    A, G, Q = (torch.from_numpy(x) for x in _filter_system(0))
    assert dare.CHOL_MIN_SIZE == 4096
    default, qr = dare.sda(A, G, Q), dare.sda(A, G, Q, solver="qr")
    assert torch.equal(default.sigma, qr.sigma) and default.iterations == qr.iterations


def test_sda_runs_at_least_one_doubling_and_leaves_its_inputs():
    """The stop rule ``it < 1 or delta >= tol``: one doubling at a tolerance
    every delta meets, as in the JAX package; the inputs are not written."""
    A, G, Q = _filter_system(1)
    tA, tG, tQ = (torch.from_numpy(x.copy()) for x in (A, G, Q))
    got = dare.sda(tA, tG, tQ, tol=np.inf)
    want = jdare.sda(jnp.asarray(A), jnp.asarray(G), jnp.asarray(Q), tol=np.inf)
    assert got.iterations == int(want.iterations) == 1
    assert _rel(got.sigma, want.sigma) <= 1e-12
    for x, t in ((A, tA), (G, tG), (Q, tQ)):
        np.testing.assert_array_equal(t.numpy(), x)


def test_closed_loop_growth_matches_jax():
    """The same power iteration from the same start vector: rel 1e-10, and
    within 5e-3 of the true radius 0.93 (the JAX package's test)."""
    rng = np.random.default_rng(3)
    Qm, _ = np.linalg.qr(rng.standard_normal((4, 4)))
    T = Qm @ np.diag([0.93, 0.5, 0.1, 0.05]) @ Qm.T
    v0 = rng.standard_normal(4)
    want = float(jdare.closed_loop_growth(lambda v: jnp.asarray(T) @ v, jnp.asarray(v0),
                                          num_iters=512))
    tT = torch.from_numpy(T)
    got = dare.closed_loop_growth(lambda v: tT @ v, torch.from_numpy(v0), num_iters=512).item()
    got_ops = dare.closed_loop_growth(lambda ops, v: ops @ v, torch.from_numpy(v0),
                                      num_iters=512, operands=tT).item()
    assert got == pytest.approx(want, rel=1e-10) and got_ops == got
    assert abs(got - 0.93) < 5e-3
