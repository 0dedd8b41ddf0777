"""Whole white-noise solves through the two-QR pipeline (``fused=False``,
``propagate_band`` None / "banded" / "interleaved") against the JAX
package's same configuration: through the Householder hook (the port's on
its leaf route; JAX's Pallas kernels in interpret mode) and through the
plain QRs."""

import numpy as np
import pytest
import torch

from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.ops import qr_householder as qh
from pnmol_tpu.solvers import white as jwhite
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.ops import qr_householder as tq

torch.set_num_threads(1)

BANDS = [None, "banded", "interleaved"]


def port_problem(jheat):
    """The JAX problem's arrays, handed to the port."""
    return interop.discretized_problem(
        L=np.asarray(jheat.L), E_sqrtm=np.asarray(jheat.E_sqrtm), B=np.asarray(jheat.B),
        R_sqrtm=np.asarray(jheat.R_sqrtm), y0=np.asarray(jheat.y0),
        points=np.asarray(jheat.mesh_spatial.points), t0=jheat.t0, tmax=jheat.tmax,
        device="cpu",
    )


def hooks(with_hook, monkeypatch):
    """(JAX hook, port hook): the Householder LQ at leaf 8, block 16 (the
    port on its leaf route, which the panel kernel's size rule sends only
    larger blocks to), or None for the plain QRs."""
    if not with_hook:
        return None, None
    monkeypatch.setattr(tq, "panel_takes_rows", lambda rows, itemsize: False)
    return (qh.make_householder_lq_factorization(leaf=8, block=16, lane_quant=64,
                                                 interpret=True),
            tq.make_householder_lq_factorization(leaf=8, block=16))


def assert_solutions_agree(sol, jsol):
    """The JAX package's own tolerances for the banded solves: means 1e-8
    relative and 1e-10 absolute, covariance Grams 1e-7, diffusion 1e-8."""
    np.testing.assert_allclose(sol.mean.numpy(), np.asarray(jsol.mean), rtol=1e-8, atol=1e-10)
    C, jC = sol.cov_sqrtm.numpy(), np.asarray(jsol.cov_sqrtm)
    np.testing.assert_allclose(np.einsum("kij,klj->kil", C, C),
                               np.einsum("kij,klj->kil", jC, jC), rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(float(sol.diffusion_squared_calibrated),
                               float(jsol.diffusion_squared_calibrated), rtol=1e-8)


@pytest.mark.parametrize("band", BANDS, ids=str)
@pytest.mark.parametrize("with_hook", [True, False], ids=["householder-hook", "plain-qr"])
@pytest.mark.parametrize("dx", [0.1, 0.2])
def test_two_qr_solve_matches_jax(monkeypatch, dx, with_hook, band):
    jheat = jexamples.heat_1d_discretized(dx=dx, tmax=0.15)
    jhook, hook = hooks(with_hook, monkeypatch)
    jsol = jwhite.LinearWhiteNoiseEK1(steprule=jstep.Constant(0.05), factorization=jhook,
                                      fused=False, propagate_band=band).solve(jheat)
    sol = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.05),
                                       factorization=hook, fused=False,
                                       propagate_band=band).solve(port_problem(jheat))
    assert_solutions_agree(sol, jsol)


def test_fused_hook_with_a_band_takes_its_banded_pre_array(monkeypatch):
    """fused=True with a band: the hook's .blocks_banded (the JAX branch
    order), against JAX's same configuration."""
    jheat = jexamples.heat_1d_discretized(dx=0.2, tmax=0.15)
    jhook, hook = hooks(True, monkeypatch)
    calls = []
    banded = hook.blocks_banded

    def spy(*args):
        calls.append(args[0].shape)
        return banded(*args)

    hook.blocks_banded = spy
    jsol = jwhite.LinearWhiteNoiseEK1(steprule=jstep.Constant(0.05), factorization=jhook,
                                      propagate_band="banded").solve(jheat)
    sol = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.05),
                                       factorization=hook,
                                       propagate_band="banded").solve(port_problem(jheat))
    assert len(calls) == 3
    assert_solutions_agree(sol, jsol)


def test_the_two_qr_pipeline_routes_through_the_hook():
    """A hook with .propagate and fused=False: one propagate and one update
    LQ a step (interleaved: the propagate's .interleaved), the init factor
    re-triangularized by the hook's .tri."""
    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.15, device="cpu")
    hook = tq.make_householder_lq_factorization(leaf=8, block=16)
    calls = []
    for name, owner in (("interleaved", hook.propagate),
                        ("blocks_banded", hook.update_from_products),
                        ("tri", hook), ("blocks", hook)):
        real = getattr(owner, name)
        setattr(owner, name, lambda *a, _real=real, _name=name: calls.append(_name) or _real(*a))
    pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.05), factorization=hook,
                                 fused=False, propagate_band="interleaved").solve(heat)
    assert calls == ["tri"] + ["interleaved", "blocks_banded"] * 3
