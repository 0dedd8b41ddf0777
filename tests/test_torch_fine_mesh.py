"""The heat problem on a fine mesh (2048 points, the dx-adapted FD kernel
``SquareExponential(input_scale=0.1/dx)``): the white-noise EK1 at nu = 1
with ``Constant(1e-3)``, two steps, against the JAX package's same solve.

At this mesh the solution's maximum does not decay: it rises by 2e-7 to
5e-7 a step, in the JAX package as in the port. The FD operator's row sum
at the initial peak is positive, so ``(L u0)`` points up there; and the FD error
covariance (the measurement noise of the white-noise filter) dwarfs
``(L u0)``, so the filter's initial derivative at the peak is that value
shrunk about 1700-fold, and the mean moves by about ``dt`` times it."""

import numpy as np
import torch

from pnmol_tpu import kernels as jkernels
from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.solvers import white as jwhite
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop

torch.set_num_threads(1)

POINTS, DT, STEPS = 2048, 1e-3, 2


def test_fine_mesh_heat_rises_as_in_jax():
    dx = 1.0 / (POINTS - 1)
    jheat = jexamples.heat_1d_discretized(
        dx=dx, tmax=STEPS * DT, kernel=jkernels.SquareExponential(input_scale=0.1 / dx))
    jprior = jkernels.Matern52() + jkernels.WhiteNoise()
    jsol = jwhite.LinearWhiteNoiseEK1(steprule=jstep.Constant(DT), num_derivatives=1,
                                      spatial_kernel=jprior).solve(jheat)
    heat = interop.discretized_problem(
        L=np.asarray(jheat.L), E_sqrtm=np.asarray(jheat.E_sqrtm), B=np.asarray(jheat.B),
        R_sqrtm=np.asarray(jheat.R_sqrtm), y0=np.asarray(jheat.y0),
        points=np.asarray(jheat.mesh_spatial.points), t0=jheat.t0, tmax=jheat.tmax,
        device="cpu",
    )
    prior = pt.kernels.Matern52() + pt.kernels.WhiteNoise()
    sol = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(DT),
                                       num_derivatives=1, spatial_kernel=prior).solve(heat)

    mean, jmean = sol.mean.numpy(), np.asarray(jsol.mean)
    assert mean.shape == jmean.shape == (STEPS + 1, 2, POINTS)
    np.testing.assert_allclose(mean, jmean, rtol=1e-8, atol=1e-10)

    L, E = np.asarray(jheat.L), np.asarray(jheat.E_sqrtm)
    u0 = mean[0, 0]
    peak = int(np.abs(u0).argmax())
    Lu0 = L[peak] @ u0
    assert L[peak].sum() > 0 and Lu0 > 0  # the operator points up at the peak
    assert np.linalg.norm(E[peak]) > 1e3 * Lu0  # the FD error dwarfs it
    assert 0 < mean[0, 1, peak] < 1e-3 * Lu0  # so the initial derivative is shrunk
    for m in (mean, jmean):  # and the maximum rises by about dt times it a step
        rise = np.diff(np.abs(m[:, 0]).max(axis=1))
        assert np.all(rise > 0)
        assert np.all(rise < 10 * DT * mean[0, 1, peak])
