"""The port's textbook Kalman steps and dense square-root updates against the
JAX package's, from the same random factors (numpy seed): gains and means
to 1e-12, covariance factors by their Grams (the QR's row signs are free)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.ops import kalman as jkalman
from pnmol_tpu.ops import sqrt as jsqrt
from pnmol_tpu_torch.ops import kalman, sqrt

torch.set_num_threads(1)

TOL = 1e-12


def spd_factor(rng, n):
    w = rng.standard_normal((n, n))
    return np.linalg.cholesky(w @ w.T + n * np.eye(n))


def gram(C):
    C = np.asarray(C)
    return C @ C.T


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def setup():
    """The shapes of tests/test_ops/test_kalman.py: d = 4, two observations."""
    rng = np.random.default_rng(0)
    d = 4
    return dict(
        m=rng.standard_normal(d), sc=spd_factor(rng, d), phi=rng.standard_normal((d, d)),
        sq=spd_factor(rng, d), h=rng.standard_normal((2, d)), b=rng.standard_normal(2),
        data=rng.standard_normal(2), m_fut=rng.standard_normal(d), sc_fut=spd_factor(rng, d),
    )


def both(args):
    """The same arrays as JAX arrays and as torch tensors."""
    return [jnp.asarray(a) for a in args], [torch.from_numpy(np.asarray(a)) for a in args]


def test_filter_step_matches_jax(setup):
    s = setup
    jargs, targs = both([s[k] for k in ("m", "sc", "phi", "sq", "h", "b", "data")])
    want = jkalman.filter_step(*jargs)
    got = kalman.filter_step(*targs)
    m_new, sc_new, sgain, m_pred, sc_pred, x = got
    close(m_new, want[0])
    close(gram(sc_new), gram(want[1]))
    close(sgain, want[2])
    close(m_pred, want[3])
    close(gram(sc_pred), gram(want[4]))
    close(x, want[5])


@pytest.mark.parametrize("step", ["sqrt", "traditional"])
def test_smoother_steps_match_jax(setup, step):
    s = setup
    jargs, targs = both([s[k] for k in ("m", "sc", "phi", "sq", "h", "b", "data")])
    jf, tf = jkalman.filter_step(*jargs), kalman.filter_step(*targs)
    jfut, tfut = both([s["m_fut"], s["sc_fut"]])
    if step == "sqrt":
        want = jkalman.smoother_step_sqrt(jargs[0], jargs[1], *jfut, jf[2], jargs[3], jf[3], jf[5])
        got = kalman.smoother_step_sqrt(targs[0], targs[1], *tfut, tf[2], targs[3], tf[3], tf[5])
    else:
        want = jkalman.smoother_step_traditional(jargs[0], jargs[1], *jfut, jf[2], jf[3], jf[4])
        got = kalman.smoother_step_traditional(targs[0], targs[1], *tfut, tf[2], tf[3], tf[4])
    close(got[0], want[0])
    close(gram(got[1]), gram(want[1]))


def test_sqrt_and_traditional_smoother_agree(setup):
    """The square-root step against the dense one, as in the JAX tests."""
    s = setup
    _, targs = both([s[k] for k in ("m", "sc", "phi", "sq", "h", "b", "data")])
    f = kalman.filter_step(*targs)
    _, (m_fut, sc_fut) = both([s["m_fut"], s["sc_fut"]])
    m1, c1 = kalman.smoother_step_sqrt(targs[0], targs[1], m_fut, sc_fut, f[2], targs[3], f[3],
                                       f[5])
    m2, c2 = kalman.smoother_step_traditional(targs[0], targs[1], m_fut, sc_fut, f[2], f[3], f[4])
    close(m1, m2)
    close(gram(c1), gram(c2), 1e-10)


@pytest.mark.parametrize("name", ["update_sqrt", "update_sqrt_no_meascov",
                                  "update_sqrt_from_products",
                                  "update_sqrt_no_meascov_from_products"])
def test_sqrt_updates_match_jax(name):
    rng = np.random.default_rng(len(name))
    D, m = 7, 3
    C = np.tril(rng.standard_normal((D, D))) + 3 * np.eye(D)
    H = rng.standard_normal((m, D))
    R = np.tril(rng.standard_normal((m, m))) + 2 * np.eye(m)
    args = {
        "update_sqrt": [H, C, R],
        "update_sqrt_no_meascov": [H, C],
        "update_sqrt_from_products": [H @ C, C, R],
        "update_sqrt_no_meascov_from_products": [H @ C, C],
    }[name]
    jargs, targs = both(args)
    want = getattr(jsqrt, name)(*jargs)
    got = getattr(sqrt, name)(*targs)
    close(gram(got[0]), gram(want[0]))
    close(got[1], want[1])
    close(gram(got[2]), gram(want[2]))


def test_sqrtm_to_cholesky_matches_jax():
    St = np.random.default_rng(3).standard_normal((9, 5))
    got, want = sqrt.sqrtm_to_cholesky(torch.from_numpy(St)), jsqrt.sqrtm_to_cholesky(jnp.asarray(St))
    close(gram(got), gram(want))
    close(gram(got), St.T @ St)
    assert torch.all(torch.triu(got, 1) == 0)
