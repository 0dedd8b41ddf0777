"""The two gain solves of the large-N path, one torch call at every size:
the initialization's closed-form y0 gain (``structured_init_y0``) and the
Householder hooks' gain solve, against the JAX package's, which takes its
blocked panel substitution (``pnmol_tpu.ops.trisolve``) from 4096 rows on."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.ops import qr_householder as qh
from pnmol_tpu.solvers import white as jwhite
from pnmol_tpu_torch.ops import qr_householder as tq
from pnmol_tpu_torch.solvers import white as twhite

torch.set_num_threads(1)


@pytest.mark.parametrize("d", [40, 4096])
def test_structured_init_y0_matches_jax(d):
    """A squared-exponential Gram on d points with a 1e-3 nugget, y0 random,
    nu = 2 (three derivative blocks)."""
    rng = np.random.default_rng(3)
    n = 3
    x = np.linspace(0.0, 1.0, d)
    gram = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.05**2) + 1e-3 * np.eye(d)
    chol = np.linalg.cholesky(gram)
    y0 = rng.normal(size=d)
    u0, blocks = twhite.structured_init_y0(torch.from_numpy(gram), torch.from_numpy(chol),
                                           torch.from_numpy(y0), 1.0, 1e-3, n)
    ju0, jblocks = jwhite.structured_init_y0(jnp.asarray(gram), jnp.asarray(chol),
                                             jnp.asarray(y0), 1.0, 1e-3, n)
    # at 4096 points the Gram's condition number is about 5e5 (its 1e-3
    # nugget against a largest eigenvalue near 500): JAX's blocked and the
    # port's unblocked substitution round 6e-11 apart on entries near 2
    atol = 1e-12 if d < 4096 else 1e-10
    np.testing.assert_allclose(u0.numpy(), np.asarray(ju0), rtol=1e-10, atol=atol)
    assert len(blocks) == len(jblocks) == n
    for b, jb in zip(blocks, jblocks):
        np.testing.assert_allclose(b.numpy() @ b.numpy().T, np.asarray(jb) @ np.asarray(jb).T,
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("m", [30, 4096])
def test_gain_solve_matches_jax(m):
    """gain = L21 L1^{-1} for a lower Cholesky factor L1 of a well-conditioned
    SPD matrix and 12 rows of L21."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(m, m)) / np.sqrt(m)
    L1 = np.linalg.cholesky(A @ A.T + np.eye(m))
    L21 = rng.normal(size=(12, m))
    got = tq._gain_solve_lower(torch.from_numpy(L1), torch.from_numpy(L21)).numpy()
    want = np.asarray(qh._gain_solve_lower(jnp.asarray(L1), jnp.asarray(L21), None))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got @ L1, L21, rtol=0, atol=1e-10)
