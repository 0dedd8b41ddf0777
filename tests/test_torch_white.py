"""The port's white-noise EK1 (initialize, one step, whole solves) against
the JAX package and the committed goldens."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu import kernels as jkernels
from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.solvers import white as jwhite
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.ops import qr_householder as tq

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "heat_trajectories.npz"
CPU = "cpu"


def _jax_problem(d):
    """JAX heat problem with d points; the full width d = 512 uses the
    dx-adapted FD kernel of the bench configuration."""
    if d == 6:
        return jexamples.heat_1d_discretized(dx=0.2, tmax=0.5)
    dx = 1.0 / (d - 1)
    kernel = jkernels.SquareExponential(input_scale=0.1 / dx) if d == 512 else None
    return jexamples.heat_1d_discretized(dx=dx, tmax=0.5, kernel=kernel)


def _port_problem(jheat):
    """The same discretized problem handed over as NumPy arrays."""
    return interop.discretized_problem(
        L=np.asarray(jheat.L), E_sqrtm=np.asarray(jheat.E_sqrtm),
        B=np.asarray(jheat.B), R_sqrtm=np.asarray(jheat.R_sqrtm),
        y0=np.asarray(jheat.y0), points=np.asarray(jheat.mesh_spatial.points),
        t0=jheat.t0, tmax=jheat.tmax, device=CPU,
    )


def _gram(C):
    C = np.asarray(C)
    return C @ C.T


@pytest.mark.parametrize("d", [6, 64])
def test_initialize_matches_jax(d):
    jheat = _jax_problem(d)
    jstate = jwhite.LinearWhiteNoiseEK1(steprule=jstep.Constant(0.1)).initialize(jheat)
    for factorization in (None, "householder"):
        solver = pt.white.LinearWhiteNoiseEK1(
            steprule=pt.odetools.step.Constant(0.1), factorization=factorization
        )
        state = solver.initialize(_port_problem(jheat))
        # one Gram Cholesky, one 3x3-block solve and one QR of O(1) data:
        # agreement to f64 rounding times the init's conditioning
        np.testing.assert_allclose(state.y.mean.numpy(), np.asarray(jstate.y.mean),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(_gram(state.y.cov_sqrtm), _gram(jstate.y.cov_sqrtm),
                                   rtol=0, atol=1e-10)


@pytest.fixture(scope="module", params=[64, 512], ids=["d64", "n512"])
def jax_step_setup(request):
    """JAX initialize at d points: its state and cache, and one JAX step."""
    d = request.param
    jsolver = jwhite.LinearWhiteNoiseEK1(steprule=jstep.Constant(1e-3))
    jstate = jsolver.initialize(_jax_problem(d))
    dt = 1e-3
    jout = jwhite.white_attempt_step(
        jsolver._cache, jstate.y.mean, jstate.y.cov_sqrtm, dt, jnp.asarray(dt),
        num_derivatives=2, f=None, df=None, linear=True, fused=True,
    )
    return d, jsolver._cache, jstate, dt, [np.asarray(x) for x in jout]


def test_one_step_from_the_same_state_matches_jax(jax_step_setup):
    d, jcache, jstate, dt, (jmean, jcov, jerror, jref, jdiff) = jax_step_setup
    cache = interop.white_cache(
        **{k: np.asarray(v) for k, v in jcache._asdict().items()}, device=CPU
    )
    state = interop.filter_state(
        t=0.0, mean=np.asarray(jstate.y.mean), cov_sqrtm=np.asarray(jstate.y.cov_sqrtm),
        device=CPU,
    )
    hooks = [None, tq.make_householder_lq_factorization(block=128 if d == 512 else 16)]
    for factorization in hooks:
        mean, cov, error, ref, diff = pt.white.white_attempt_step(
            cache, state.y.mean, state.y.cov_sqrtm, dt, dt,
            num_derivatives=2, factorization=factorization,
        )
        # one QR of the pre-array in each package. Measured: means 9e-13
        # and covariance Grams 7e-15 relative to their largest entry, the
        # diffusion 3e-14 relative; the bounds leave two digits of margin
        # (the diffusion gets the golden test's rtol: it whitens through the
        # near-singular innovation directions of the noise-free boundary rows)
        scale = np.abs(jmean).max()
        np.testing.assert_allclose(mean.numpy(), jmean, rtol=0, atol=1e-10 * scale)
        G = _gram(jcov)
        np.testing.assert_allclose(_gram(cov), G, rtol=0, atol=1e-12 * np.abs(G).max())
        np.testing.assert_allclose(ref.numpy(), jref, rtol=0, atol=1e-10 * scale)
        np.testing.assert_allclose(diff.numpy(), jdiff, rtol=1e-10)
        np.testing.assert_allclose(error.numpy(), jerror, rtol=1e-12)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("factorization", [None, "householder"])
def test_solve_matches_golden(golden, factorization):
    """The port's own discretization and solve at dx = 0.2, with the
    thresholds of tests/test_golden.py."""
    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=CPU)
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(0.1),
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
        factorization=factorization,
    )
    sol = solver.solve(heat)
    np.testing.assert_allclose(sol.mean.numpy(), golden["white_mean"], rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(float(sol.diffusion_squared_calibrated),
                               golden["white_diffusion"], rtol=1e-10)
    std = torch.sqrt(torch.einsum("ij,ij->i", sol.cov_sqrtm[-1], sol.cov_sqrtm[-1]))
    np.testing.assert_allclose(std.numpy(), golden["white_final_std"], rtol=1e-8, atol=1e-12)
    assert sol.info["num_steps"] == sol.info["num_attempted_steps"] == 5
    assert sol.mean.shape == (6, 3, 6) and sol.cov_sqrtm.shape == (6, 18, 18)
    np.testing.assert_allclose(sol.t.numpy(), [0.0, 0.1, 0.2, 0.3, 0.4, 0.5], atol=1e-15)

    final, info = solver.simulate_final_state(heat)
    torch.testing.assert_close(final.y.mean, sol.mean[-1], rtol=0, atol=1e-15)
    scaled = sol.cov_sqrtm[-1] * torch.sqrt(sol.diffusion_squared_calibrated)
    torch.testing.assert_close(final.y.cov_sqrtm, scaled, rtol=0, atol=1e-15)
    assert info["num_steps"] == 5


def test_multi_panel_hook_solve_matches_jax_default():
    """d = 64 through the Householder hook with 16-row panels (the step's
    258 x 450 pre-array takes 17 panels per sweep) against the JAX default
    (XLA QR) solver on the same problem."""
    jheat = _jax_problem(64)
    jsol = jwhite.LinearWhiteNoiseEK1(steprule=jstep.Constant(0.1)).solve(jheat)
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(0.1),
        factorization=tq.make_householder_lq_factorization(block=16),
    )
    sol = solver.solve(_port_problem(jheat))
    np.testing.assert_allclose(sol.mean.numpy(), np.asarray(jsol.mean), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_gram(sol.cov_sqrtm[-1]), _gram(jsol.cov_sqrtm[-1]),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(sol.diffusion_squared_calibrated),
                               float(jsol.diffusion_squared_calibrated), rtol=1e-9)


def test_point_major_blockdiag_matches_jax():
    rng = np.random.default_rng(5)
    blocks = [rng.standard_normal((4, 4)) for _ in range(3)]
    got = pt.white.point_major_blockdiag([torch.from_numpy(b) for b in blocks])
    want = jwhite.point_major_blockdiag([jnp.asarray(b) for b in blocks])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CONSTANT = pt.odetools.step.Constant(0.1)


@pytest.mark.parametrize(
    "make, item",
    [
        (lambda: pt.white.LinearWhiteNoiseEK1(steprule=CONSTANT, steady_state=True), None),
        (lambda: pt.white.LinearWhiteNoiseEK1(steprule=CONSTANT, steady_state={}), None),
        (lambda: pt.white.LinearWhiteNoiseEK1(steprule=CONSTANT, meascov_dt_scaled=True,
                                              steady_state=True), None),
        (lambda: pt.white.SemiLinearWhiteNoiseEK0(steprule=CONSTANT, steady_state=True),
         "LINEAR"),
        (lambda: pt.latent.LinearLatentForceEK1(steprule=CONSTANT, steady_state={}), None),
    ],
    ids=["steady", "steady-dict", "dt-scaled", "semilinear-ek0", "latent"],
)
def test_out_of_slice_options_raise(make, item):
    """Steady-state mode initializes the linear solvers (an empty options
    dict means on) with a finite stationary cache and a mean-only step, and
    refuses a semilinear solver at initialize with the JAX package's
    ValueError naming ``LINEAR``."""
    solver = make()
    if item is not None:
        spruce = pt.examples.spruce_budworm_1d_discretized(dx=0.2, tmax=0.5, device=CPU)
        with pytest.raises(ValueError, match=item):
            solver.initialize(spruce)
        return
    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=CPU)
    state = solver.initialize(heat)
    steady = solver.steady_cache
    assert steady is not None and torch.isfinite(steady.cov_inf).all()
    assert torch.equal(state.y.cov_sqrtm, steady.cov_inf)
    sol = solver.solve(heat)
    assert torch.isfinite(sol.mean).all() and sol.info["num_steps"] == 5


def test_hook_without_blocks_is_accepted_and_solves():
    """A hook with the legacy gain contract (no ``.blocks``): the step
    updates the mean with the explicit gain ``K z``. Here the gain form of
    the plain pipeline, so the solve equals the default one."""
    calls = []

    def gain_hook(HACl, ACl, HQl, Ql, E):
        calls.append(HACl.shape)
        C, L21, Sl = pt.ops.sqrt.fused_predict_update_blocks(HACl, ACl, HQl, Ql, E)
        return C, torch.linalg.solve_triangular(Sl.T, L21.T, upper=True).T, Sl

    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=CPU)
    sols = [
        pt.white.LinearWhiteNoiseEK1(steprule=CONSTANT, factorization=f).solve(heat)
        for f in (gain_hook, None)
    ]
    assert calls == [(8, 18)] * 5  # the five steps; the initialization stays plain
    torch.testing.assert_close(sols[0].mean, sols[1].mean, rtol=0, atol=1e-13)
    torch.testing.assert_close(sols[0].cov_sqrtm, sols[1].cov_sqrtm, rtol=0, atol=1e-13)
