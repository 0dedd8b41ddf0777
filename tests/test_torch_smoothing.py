"""The port's RTS smoother against the JAX package's on white and latent
trajectories at dx = 0.2 (``Constant(0.1)``, tmax 0.5), from the same
filtered trajectory (means and covariance Grams to 1e-10), and against the
dense full-covariance RTS oracle of tests/test_solvers/test_smoothing.py."""

import numpy as np
import pytest
import torch

from pnmol_tpu import kernels as jkernels
from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.solvers import latent as jlatent
from pnmol_tpu.solvers import smoothing as jsmoothing
from pnmol_tpu.solvers import white as jwhite
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.ops import iwp
from pnmol_tpu_torch.solvers import pdefilter, smoothing

torch.set_num_threads(1)

CPU = "cpu"


def gram(C):
    return C @ C.transpose(-1, -2)


def rel_close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def tensor(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("family", ["white", "latent"])
def test_smooth_solution_matches_jax(family):
    """The port smooths JAX's filtered trajectory with JAX's cache."""
    jheat = jexamples.heat_1d_discretized(dx=0.2, tmax=0.5)
    prior = jkernels.Matern52() + jkernels.WhiteNoise()
    jcls = jwhite.LinearWhiteNoiseEK1 if family == "white" else jlatent.LinearLatentForceEK1
    jsolver = jcls(steprule=jstep.Constant(0.1), spatial_kernel=prior)
    jsol = jsolver.solve(jheat)
    want = jsmoothing.smooth_solution(jsolver, jsol)

    cls = pt.white.LinearWhiteNoiseEK1 if family == "white" else pt.latent.LinearLatentForceEK1
    solver = cls(steprule=pt.odetools.step.Constant(0.1))
    arrays = {k: np.asarray(v) for k, v in jsolver._cache._asdict().items()}
    make_cache = interop.white_cache if family == "white" else interop.latent_cache
    solver._cache = make_cache(**arrays, device=CPU)
    sol = pdefilter.PDESolution(t=tensor(jsol.t), mean=tensor(jsol.mean),
                                cov_sqrtm=tensor(jsol.cov_sqrtm), info=dict(jsol.info),
                                diffusion_squared_calibrated=tensor(
                                    jsol.diffusion_squared_calibrated))
    got = smoothing.smooth_solution(solver, sol)
    assert got.mean.shape == sol.mean.shape and got.cov_sqrtm.shape == sol.cov_sqrtm.shape
    rel_close(got.mean, want.mean, 1e-10)
    rel_close(gram(got.cov_sqrtm), gram(tensor(want.cov_sqrtm)), 1e-10)
    torch.testing.assert_close(got.t, sol.t, rtol=0, atol=0)


@pytest.fixture(scope="module")
def filtered():
    heat = pt.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=CPU)
    solver = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.1))
    return solver, solver.solve(heat)


def dense_rts_oracle(solver, sol):
    """Textbook full-covariance RTS smoother in raw coordinates."""
    K = sol.t.shape[0] - 1
    dts = torch.diff(sol.t)
    means, covs = [None] * (K + 1), [None] * (K + 1)
    means[K] = iwp.mean_to_flat(sol.mean[K])
    covs[K] = gram(sol.cov_sqrtm[K])
    for k in range(K - 1, -1, -1):
        A, LQ = solver.iwp.non_preconditioned_discretize(float(dts[k]))
        m_k, C_k = iwp.mean_to_flat(sol.mean[k]), gram(sol.cov_sqrtm[k])
        mp = A @ m_k
        Pp = A @ C_k @ A.T + LQ @ LQ.T
        gain = torch.linalg.solve(Pp.T, (C_k @ A.T).T).T
        means[k] = m_k + gain @ (means[k + 1] - mp)
        covs[k] = C_k + gain @ (covs[k + 1] - Pp) @ gain.T
    return means, covs


def test_smoothed_matches_dense_oracle(filtered):
    solver, sol = filtered
    smoothed = smoothing.smooth_solution(solver, sol)
    oracle_means, oracle_covs = dense_rts_oracle(solver, sol)
    for k in range(sol.t.shape[0]):
        torch.testing.assert_close(iwp.mean_to_flat(smoothed.mean[k]), oracle_means[k],
                                   rtol=1e-7, atol=1e-10)
        torch.testing.assert_close(gram(smoothed.cov_sqrtm[k]), oracle_covs[k],
                                   rtol=1e-6, atol=1e-9)


def test_smoothing_reduces_uncertainty(filtered):
    _, sol = filtered
    smoothed = smoothing.smooth_solution(filtered[0], sol)
    var_filt = torch.einsum("tij,tij->ti", sol.cov_sqrtm, sol.cov_sqrtm)
    var_smooth = torch.einsum("tij,tij->ti", smoothed.cov_sqrtm, smoothed.cov_sqrtm)
    assert torch.all(var_smooth <= var_filt + 1e-10)
    torch.testing.assert_close(smoothed.mean[-1], sol.mean[-1], rtol=0, atol=0)
