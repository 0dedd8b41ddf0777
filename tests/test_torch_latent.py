"""The port's latent-force solvers against the JAX package and the committed
goldens: the dx = 0.2 heat golden through all three factorizations,
initialize and one step at d = 64 from the same state, the semilinear
latent solvers on Lotka-Volterra, and the stacked state space."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu import kernels as jkernels
from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.ops import iwp as jiwp
from pnmol_tpu.ops import stacked_ssm as jstacked
from pnmol_tpu.solvers import latent as jlatent
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.ops import qr_householder as tq

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "heat_trajectories.npz"
CPU = "cpu"
FACTORIZATIONS = {
    "qr": lambda: None,
    "householder": lambda: "householder",
    "r-form": tq.make_householder_factorization,
}


def gram(C):
    C = np.asarray(C)
    return C @ C.T


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("factorization", sorted(FACTORIZATIONS))
def test_solve_matches_golden(golden, factorization):
    """The port's own discretization and latent solve at dx = 0.2, with the
    thresholds of tests/test_golden.py."""
    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=CPU)
    solver = pt.latent.LinearLatentForceEK1(
        steprule=pt.odetools.step.Constant(0.1),
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
        factorization=FACTORIZATIONS[factorization](),
    )
    sol = solver.solve(heat)
    np.testing.assert_allclose(sol.mean.numpy(), golden["latent_mean"], rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(float(sol.diffusion_squared_calibrated),
                               golden["latent_diffusion"], rtol=1e-10)
    assert sol.mean.shape == (6, 3, 12) and sol.cov_sqrtm.shape == (6, 36, 36)
    assert sol.info["num_steps"] == sol.info["num_attempted_steps"] == 5


@pytest.fixture(scope="module")
def jax_d64():
    """JAX latent initialize at d = 64 and one JAX step from its state."""
    jheat = jexamples.heat_1d_discretized(dx=1.0 / 63, tmax=0.5)
    jsolver = jlatent.LinearLatentForceEK1(steprule=jstep.Constant(1e-3))
    jstate = jsolver.initialize(jheat)
    dt = 1e-3
    jout = jlatent.latent_attempt_step(
        jsolver._cache, jstate.y.mean, jstate.y.cov_sqrtm, dt, jnp.asarray(dt),
        num_derivatives=2, f=None, df=None, linear=True, fused=True,
    )
    heat = interop.discretized_problem(
        L=np.asarray(jheat.L), E_sqrtm=np.asarray(jheat.E_sqrtm), B=np.asarray(jheat.B),
        R_sqrtm=np.asarray(jheat.R_sqrtm), y0=np.asarray(jheat.y0),
        points=np.asarray(jheat.mesh_spatial.points), t0=jheat.t0, tmax=jheat.tmax,
        device=CPU,
    )
    return heat, jsolver, jstate, dt, [np.asarray(x) for x in jout]


@pytest.mark.parametrize("factorization", sorted(FACTORIZATIONS))
def test_initialize_matches_jax(jax_d64, factorization):
    heat, jsolver, jstate, _, _ = jax_d64
    solver = pt.latent.LinearLatentForceEK1(
        steprule=pt.odetools.step.Constant(1e-3), factorization=FACTORIZATIONS[factorization]())
    state = solver.initialize(heat)
    jmean = np.asarray(jstate.y.mean)
    assert state.y.mean.shape == jmean.shape == (3, 128)
    # measured: 5e-12 (mean) and 4e-16 (Gram) relative to the largest entry
    np.testing.assert_allclose(state.y.mean.numpy(), jmean, rtol=0,
                               atol=1e-9 * np.abs(jmean).max())
    G = gram(jstate.y.cov_sqrtm)
    np.testing.assert_allclose(gram(state.y.cov_sqrtm), G, rtol=0, atol=1e-10 * np.abs(G).max())
    np.testing.assert_allclose(solver._cache.Ql.numpy(), np.asarray(jsolver._cache.Ql),
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize(
    "hook",
    [None, tq.make_householder_lq_factorization(block=16),
     tq.make_householder_factorization(leaf=8, block=16)],
    ids=["qr", "lq-16-row-panels", "r-form-16-column-blocks"],
)
def test_one_step_from_the_same_state_matches_jax(jax_d64, hook):
    """d = 64: the step's pre-array is 450 x 834 (29 panels of 16 rows, or
    the R form's 834 x 450 in 57 leaves of 8 columns)."""
    _, jsolver, jstate, dt, (jmean, jcov, jerror, jref, jdiff) = jax_d64
    cache = interop.latent_cache(
        **{k: np.asarray(v) for k, v in jsolver._cache._asdict().items()}, device=CPU)
    state = interop.filter_state(t=0.0, mean=np.asarray(jstate.y.mean),
                                 cov_sqrtm=np.asarray(jstate.y.cov_sqrtm), device=CPU)
    mean, cov, error, ref, diff = pt.latent.latent_attempt_step(
        cache, state.y.mean, state.y.cov_sqrtm, dt, dt, num_derivatives=2,
        factorization=hook,
    )
    scale = np.abs(jmean).max()
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=0, atol=1e-10 * scale)
    G = gram(jcov)
    np.testing.assert_allclose(gram(cov), G, rtol=0, atol=1e-12 * np.abs(G).max())
    np.testing.assert_allclose(ref.numpy(), jref, rtol=0, atol=1e-10 * scale)
    # the diffusion whitens through the noise-free boundary rows
    np.testing.assert_allclose(diff.numpy(), jdiff, rtol=1e-8)
    np.testing.assert_allclose(error.numpy(), jerror, rtol=1e-10)


@pytest.fixture(scope="module")
def lotka_volterra():
    jpde = jexamples.lotka_volterra_1d_discretized(dx=0.1, tmax=0.2)
    recipe = pt.examples.lotka_volterra_1d()
    pde = interop.discretized_problem(
        L=np.asarray(jpde.L), E_sqrtm=np.asarray(jpde.E_sqrtm), B=np.asarray(jpde.B),
        R_sqrtm=np.asarray(jpde.R_sqrtm), y0=np.asarray(jpde.y0),
        points=np.asarray(jpde.mesh_spatial.points), t0=jpde.t0, tmax=jpde.tmax,
        device=CPU, boundary="neumann", f=recipe.f, df=recipe.df,
    )
    jprior = jkernels.duplicate(jkernels.Matern52() + jkernels.WhiteNoise(), 2)
    jsols = {ek: getattr(jlatent, f"SemiLinearLatentForce{ek}")(
        steprule=jstep.Constant(0.05), spatial_kernel=jprior).solve(jpde)
        for ek in ("EK0", "EK1")}
    return jsols, pde


@pytest.mark.parametrize("factorization", sorted(FACTORIZATIONS))
@pytest.mark.parametrize("ek", ["EK0", "EK1"])
def test_semilinear_latent_lotka_volterra_matches_jax(lotka_volterra, ek, factorization):
    jsols, pde = lotka_volterra
    jsol = jsols[ek]
    cls = getattr(pt.latent, f"SemiLinearLatentForce{ek}")
    sol = cls(steprule=pt.odetools.step.Constant(0.05),
              spatial_kernel=pt.duplicate(pt.kernels.Matern52() + pt.kernels.WhiteNoise(), 2),
              factorization=FACTORIZATIONS[factorization]()).solve(pde)
    jmean = np.asarray(jsol.mean)
    assert sol.mean.shape == jmean.shape == (5, 3, 44)
    # measured: 4e-11 (mean), 3e-15 (Gram) and 3e-11 (diffusion) relative
    np.testing.assert_allclose(sol.mean.numpy(), jmean, rtol=0, atol=1e-9 * np.abs(jmean).max())
    G = gram(jsol.cov_sqrtm[-1])
    np.testing.assert_allclose(gram(sol.cov_sqrtm[-1]), G, rtol=0, atol=1e-10 * np.abs(G).max())
    np.testing.assert_allclose(float(sol.diffusion_squared_calibrated),
                               float(jsol.diffusion_squared_calibrated), rtol=1e-8)


def test_solver_exposes_its_processes():
    heat = pt.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=CPU)
    solver = pt.latent.LinearLatentForceEK1(steprule=pt.odetools.step.Constant(0.1))
    solver.initialize(heat)
    d = heat.L.shape[0]
    assert solver.state_iwp.wiener_process_dimension == solver.lf_iwp.wiener_process_dimension == d
    assert solver.ssm.state_dimension == 2 * 3 * d
    assert solver.E0.shape == solver.E1.shape == (d, 3 * d)
    torch.testing.assert_close(solver.lf_iwp.wp_diffusion_sqrtm, heat.E_sqrtm)
    merged = solver.ssm.as_single_iwp()
    torch.testing.assert_close(merged.process_noise_factor, solver._cache.Ql)


def test_stacked_ssm_dense_api_matches_jax():
    rng = np.random.default_rng(4)
    factors = [np.tril(rng.standard_normal((k, k))) + 3 * np.eye(k) for k in (3, 2)]
    procs = [pt.ops.iwp.IntegratedWienerTransition(
        num_derivatives=2, wiener_process_dimension=f.shape[0],
        wp_diffusion_sqrtm=torch.from_numpy(f)) for f in factors]
    jprocs = [jiwp.IntegratedWienerTransition(
        num_derivatives=2, wiener_process_dimension=f.shape[0],
        wp_diffusion_sqrtm=jnp.asarray(f)) for f in factors]
    ssm, jssm = pt.ops.stacked_ssm.StackedSSM(procs), jstacked.StackedSSM(jprocs)
    assert ssm.state_dimension == jssm.state_dimension == 15 and ssm.is_homogeneous

    def check(got, want):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14, atol=1e-15)

    check(ssm.preconditioned_discretize, jssm.preconditioned_discretize)
    check(ssm.non_preconditioned_discretize(0.3), jssm.non_preconditioned_discretize(0.3))
    check(ssm.nordsieck_preconditioner(0.3), jssm.nordsieck_preconditioner(0.3))
    check([ssm.projection_matrix(1), ssm.projection_matrix(0, 1)],
          [jssm.projection_matrix(1), jssm.projection_matrix(0, 1)])
    merged, jmerged = ssm.as_single_iwp(), jssm.as_single_iwp()
    check([merged.process_noise_factor, merged.projection_matrix(2)],
          [jmerged.process_noise_factor, jmerged.projection_matrix(2)])
    mixed = pt.ops.stacked_ssm.StackedSSM([procs[0], pt.ops.iwp.IntegratedWienerTransition(
        num_derivatives=1, wiener_process_dimension=2,
        wp_diffusion_sqrtm=torch.from_numpy(factors[1]))])
    with pytest.raises(ValueError, match="num_derivatives"):
        mixed.as_single_iwp()
