"""The port's IWP prior and square-root Kalman blocks against the JAX
package, on the same NumPy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.ops import iwp as jiwp
from pnmol_tpu.ops import sqrt as jsqrt
from pnmol_tpu_torch.ops import iwp, rv, sqrt

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("dt", [0.1, 1e-3])
def test_nordsieck_scales_and_system_matrices(nu, dt):
    p, p_inv = iwp.nordsieck_scales_1d(nu, dt, **F64)
    jp, jp_inv = jiwp.nordsieck_scales_1d(nu, jnp.asarray(dt))
    # closed forms evaluated the same way: agreement to a few ulps
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-14)
    np.testing.assert_allclose(p_inv.numpy(), np.asarray(jp_inv), rtol=1e-14)
    A, LQ = iwp.system_matrices_1d(nu, **F64)
    jA, jLQ = jiwp.system_matrices_1d(nu, "float64")
    np.testing.assert_array_equal(A.numpy(), jA)
    np.testing.assert_array_equal(LQ.numpy(), jLQ)


def test_structured_operators_match_jax():
    rng = np.random.default_rng(0)
    n, d, K = 3, 5, 4
    A1d = rng.standard_normal((n, n))
    X = rng.standard_normal((n * d, K))
    x = rng.standard_normal(n * d)
    p = rng.standard_normal(n)
    t = {k: torch.from_numpy(v) for k, v in dict(A1d=A1d, X=X, x=x, p=p).items()}
    # pure data movement or one small product: equal to rounding
    close = dict(rtol=1e-14, atol=1e-14)
    for Y, jY in ((t["X"], X), (t["x"], x)):
        np.testing.assert_allclose(
            iwp.apply_stack_matrix(t["A1d"], Y).numpy(),
            np.asarray(jiwp.apply_stack_matrix(jnp.asarray(A1d), jnp.asarray(jY))), **close)
        np.testing.assert_allclose(
            iwp.scale_stack(t["p"], Y).numpy(),
            np.asarray(jiwp.scale_stack(jnp.asarray(p), jnp.asarray(jY))), **close)
        for i in range(n):
            np.testing.assert_array_equal(
                iwp.project_derivative(Y, i, n).numpy(),
                np.asarray(jiwp.project_derivative(jnp.asarray(jY), i, n)))
    M = rng.standard_normal((n, d))
    flat = iwp.mean_to_flat(torch.from_numpy(M))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jiwp.mean_to_flat(jnp.asarray(M))))
    np.testing.assert_array_equal(iwp.flat_to_mean(flat, n).numpy(), M)
    np.testing.assert_array_equal(
        iwp.point_major_perm(n, d, device="cpu").numpy(), np.asarray(jiwp.point_major_perm(n, d)))


def test_process_noise_factor_matches_jax():
    rng = np.random.default_rng(1)
    d, nu = 7, 2
    chol = np.tril(rng.standard_normal((d, d)))
    trans = iwp.IntegratedWienerTransition(
        num_derivatives=nu, wiener_process_dimension=d,
        wp_diffusion_sqrtm=torch.from_numpy(chol))
    jtrans = jiwp.IntegratedWienerTransition(
        num_derivatives=nu, wiener_process_dimension=d,
        wp_diffusion_sqrtm=jnp.asarray(chol))
    assert trans.state_dimension == jtrans.state_dimension == d * (nu + 1)
    # products of two numbers each: exact up to one rounding
    np.testing.assert_allclose(
        trans.process_noise_factor.numpy(), np.asarray(jtrans.process_noise_factor),
        rtol=1e-15, atol=0)
    np.testing.assert_array_equal(
        trans.preconditioned_discretize_1d[0].numpy(),
        np.asarray(jtrans.preconditioned_discretize_1d[0]))


def test_multivariate_normal_cov():
    C = torch.from_numpy(np.tril(np.random.default_rng(2).standard_normal((4, 4))))
    torch.testing.assert_close(rv.MultivariateNormal(torch.zeros(4, dtype=C.dtype), C).cov, C @ C.T)


def _grams(post, L21, L1):
    return post @ post.T, L21 @ L1.T, L1 @ L1.T


@pytest.mark.parametrize("m, D", [(4, 9), (10, 24)])
def test_sqrt_blocks_match_jax_by_grams(m, D):
    """QR sign conventions may differ between libraries: compare the
    factors' Grams (posterior covariance, cross covariance, innovation
    covariance). Tolerance: f64 rounding of QRs of O(1) matrices."""
    rng = np.random.default_rng(m + D)
    HACl, HQl = rng.standard_normal((m, D)), rng.standard_normal((m, D))
    ACl, Ql = rng.standard_normal((D, D)), np.tril(rng.standard_normal((D, D)))
    E = np.diag(rng.uniform(0.1, 1.0, m))
    args = (HACl, ACl, HQl, Ql, E)
    got = _grams(*sqrt.fused_predict_update_blocks(*map(torch.from_numpy, args)))
    want = _grams(*jsqrt.fused_predict_update_blocks(*map(jnp.asarray, args)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)

    args = (HACl, ACl, E)
    got = _grams(*sqrt.update_sqrt_from_products_blocks(*map(torch.from_numpy, args)))
    want = _grams(*jsqrt.update_sqrt_from_products_blocks(*map(jnp.asarray, args)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
