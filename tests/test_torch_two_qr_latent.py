"""Whole latent-force solves through the two-QR pipeline (``fused=False``,
``propagate_band`` None / "banded" / "interleaved") against the JAX
package's same configuration, through the Householder hook (the port's on
its leaf route; JAX's Pallas kernels in interpret mode) and through the
plain QRs."""

import numpy as np
import pytest
import torch

from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.ops import qr_householder as qh
from pnmol_tpu.solvers import latent as jlatent
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.ops import qr_householder as tq

torch.set_num_threads(1)


def _port_problem(jheat):
    return interop.discretized_problem(
        L=np.asarray(jheat.L), E_sqrtm=np.asarray(jheat.E_sqrtm), B=np.asarray(jheat.B),
        R_sqrtm=np.asarray(jheat.R_sqrtm), y0=np.asarray(jheat.y0),
        points=np.asarray(jheat.mesh_spatial.points), t0=jheat.t0, tmax=jheat.tmax,
        device="cpu",
    )


@pytest.mark.parametrize("band", [None, "banded", "interleaved"], ids=str)
@pytest.mark.parametrize("with_hook", [True, False], ids=["householder-hook", "plain-qr"])
@pytest.mark.parametrize("dx", [0.1, 0.2])
def test_latent_two_qr_solve_matches_jax(monkeypatch, dx, with_hook, band):
    """The JAX package's own tolerances for the banded latent solves:
    means 1e-8 relative and 1e-10 absolute, covariance Grams 1e-7. The
    port's 16-row blocks take the leaf route here, as larger blocks do by
    the panel kernel's size rule."""
    monkeypatch.setattr(tq, "panel_takes_rows", lambda rows, itemsize: False)
    jheat = jexamples.heat_1d_discretized(dx=dx, tmax=0.1)
    jhook = (qh.make_householder_lq_factorization(leaf=8, block=16, lane_quant=64,
                                                  interpret=True) if with_hook else None)
    hook = tq.make_householder_lq_factorization(leaf=8, block=16) if with_hook else None
    jsol = jlatent.LinearLatentForceEK1(steprule=jstep.Constant(0.05), factorization=jhook,
                                        fused=False, propagate_band=band).solve(jheat)
    sol = pt.latent.LinearLatentForceEK1(steprule=pt.odetools.step.Constant(0.05),
                                         factorization=hook, fused=False,
                                         propagate_band=band).solve(_port_problem(jheat))
    np.testing.assert_allclose(sol.mean.numpy(), np.asarray(jsol.mean), rtol=1e-8, atol=1e-10)
    C, jC = sol.cov_sqrtm.numpy(), np.asarray(jsol.cov_sqrtm)
    np.testing.assert_allclose(np.einsum("kij,klj->kil", C, C),
                               np.einsum("kij,klj->kil", jC, jC), rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(float(sol.diffusion_squared_calibrated),
                               float(jsol.diffusion_squared_calibrated), rtol=1e-8)
