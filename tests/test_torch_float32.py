"""The f32 precision policy of the port (``PNMOL_TPU_X32``, the runtime
switch ``config.enable_x64``) against the JAX package's f32 runs.

The counterparts of ``tests/test_solvers/test_float32.py``,
``test_dx_adapted_scale_is_f32_safe`` and
``test_boundary_classification_survives_f32_policy``. The steps, the bench
configuration, the fine-dx pipeline, the seeded steady state, the
work-precision row, the dx-adapted scale and the new public names are
held to the JAX package's own runs on the same inputs, solved here; the
whole solve at dx = 0.2 quotes JAX's CPU values. JAX runs its f32 legs
with ``jax_enable_x64`` off (its own ``f32_mode`` pattern) and the plain
factorization, and gets it back on afterwards.

What f32 can promise depends on where the problem is assembled. The step
loop alone (an f64 cache cast to f32, JAX's step test) tracks f64 to 1e-4.
Assembled in f32 end to end, as the JAX bench runs, the 3-point stencil
systems of ``SquareExponential(0.1/dx)`` (condition ~1e4) lose about four
digits of ``L``, so the highest derivatives of the mean are not determined
in f32, in JAX as in the port. There the solution ``u`` is held to JAX's
f32 ``u`` at 1e-4, and its distance from f64 to JAX's own (ROADMAP 3.5).
"""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import pnmol_tpu
from pnmol_tpu import discretize as jdiscretize
from pnmol_tpu import kernels as jkernels
from pnmol_tpu import mesh as jmesh
from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.ops import sqrt as jsqrt
from pnmol_tpu.solvers import latent as jlatent
from pnmol_tpu.solvers import white as jwhite
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.experiments import common
from pnmol_tpu_torch.ops import qr_householder as tq

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread, as ``torch.set_num_threads(1)`` gives torch: the
    JAX package's CPU LAPACK calls go through scipy's OpenBLAS (loaded
    here, so that the limit reaches it), whose threads (one a core in each
    of the suite's xdist workers) spin against each other (the N=512 JAX
    solves beside five busy workers: 23 s, against 290 s)."""
    import scipy.linalg  # noqa: F401

    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture
def port_f32():
    """The port's runtime switch to the f32 policy, restored afterwards."""
    previous = pt.config.enable_x64(False)
    try:
        yield
    finally:
        pt.config.enable_x64(previous)


@contextlib.contextmanager
def jax_f32():
    """JAX's own f32 mode (tests/test_solvers/test_float32.py's ``f32_mode``):
    x64 off, and on again afterwards."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _f32(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def x32_process():
    """One process that imports the port only, with ``PNMOL_TPU_X32=1``:
    the markers it prints, one for each check that held."""
    code = (
        "import sys, numpy as np, torch, pnmol_tpu_torch as pt\n"
        "from pnmol_tpu_torch import mesh\n"
        "assert not pt.config.x64_enabled() and pt.config.default_dtype() == torch.float32\n"
        "pt.config.enable_x64(True); pt.config.setup()\n"
        "assert pt.config.default_dtype() == torch.float32\n"
        "print('POLICY_OK')\n"
        "g1 = mesh.RectangularMesh.from_bbox_1d([0.0, 0.1], num=5, device='cpu')\n"
        "assert g1.points.dtype == torch.float32\n"
        "assert int(g1.boundary[1].sum()) == 2, g1.boundary[1]\n"
        "g2 = mesh.RectangularMesh.from_bbox_2d([[0.0, 1.0], [0.0, 0.3]], nums=(5, 5),"
        " device='cpu')\n"
        "assert int(g2.boundary[1].sum()) == 16, g2.boundary[1].sum()\n"
        "normals = g2.boundary_normals.numpy()\n"
        "assert normals.dtype == np.float32\n"
        "assert np.all(np.linalg.norm(normals, axis=1) > 0.99)\n"
        "print('BOUNDARY_OK')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'pnmol_tpu')]\n"
        "print('NO_JAX_OK')\n"
    )
    env = dict(os.environ, PNMOL_TPU_X32="1", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    return proc.stdout.split(), proc.stderr[-2000:]


# --- the policy --------------------------------------------------------------


def test_policy_defaults_to_f64_and_the_switch_restores():
    assert pt.config.x64_enabled() and pt.config.default_dtype() == torch.float64
    assert pt.config.enable_x64(False) is True
    try:
        assert not pt.config.x64_enabled()
        assert pt.config.default_dtype() == torch.float32
        assert pt.mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], num=4,
                                                    device=CPU).points.dtype == torch.float32
    finally:
        assert pt.config.enable_x64(True) is False
    assert pt.config.default_dtype() == torch.float64


def test_x32_environment_variable_selects_f32_at_import(x32_process):
    """``PNMOL_TPU_X32=1`` read at import selects f32; ``setup()`` applies
    it again over the runtime switch; the port loads no JAX."""
    markers, stderr = x32_process
    assert "POLICY_OK" in markers and "NO_JAX_OK" in markers, stderr


def test_boundary_classification_survives_f32_policy(x32_process):
    """Counterpart of tests/test_neumann_nd.py:132, importing the port only:
    under PNMOL_TPU_X32 the points are f32, and faces at bounds f32 does not
    represent (0.1, 0.3) keep their boundary points."""
    markers, stderr = x32_process
    assert "BOUNDARY_OK" in markers, stderr


@pytest.mark.parametrize("module, f64, f32", [("white", 1e-10, 1e-5), ("latent", 1e-6, 1e-4)])
def test_init_nuggets_are_dtype_aware(module, f64, f32, monkeypatch):
    """The JAX nuggets (white.py:1289-1292, latent.py:528-530): the f64
    values unchanged, the f32 ones above f32 resolution; and each solver's
    initialization takes its nugget from the problem's dtype."""
    mod = getattr(pt, module)
    assert pt.config.by_dtype(torch.float64, f64, f32) == f64
    assert pt.config.by_dtype(torch.float32, f64, f32) == f32
    seen = []
    original = mod.structured_init_y0

    def spy(gram, chol_gram, y0, diffuse_scale, nugget, n):
        seen.append((y0.dtype, nugget))
        return original(gram, chol_gram, y0, diffuse_scale, nugget, n)

    monkeypatch.setattr(mod, "structured_init_y0", spy)
    cls = pt.white.LinearWhiteNoiseEK1 if module == "white" else pt.latent.LinearLatentForceEK1
    for x64 in (True, False):
        previous = pt.config.enable_x64(x64)
        try:
            heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=CPU)
            state = cls(steprule=pt.odetools.step.Constant(0.1)).initialize(heat)
        finally:
            pt.config.enable_x64(previous)
        assert bool(torch.isfinite(state.y.mean).all())
    assert seen == [(torch.float64, f64), (torch.float32, f32)]


# --- the counterparts of tests/test_solvers/test_float32.py ------------------


def test_white_step_f32_stays_finite_and_tracks_f64_and_jax():
    """JAX's f64 cache, cast to f32 in both packages, through
    ``make_white_step_fn``: 20 steps against the f64 steps at JAX's 1e-4,
    and the port's f32 mean against JAX's f32 mean at 1e-4."""
    jheat = jexamples.heat_1d_discretized(dx=0.1, tmax=1.0)
    jsolver = jwhite.LinearWhiteNoiseEK1(steprule=jstep.Constant(0.05))
    jstate = jsolver.initialize(jheat)
    jcache32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jsolver._cache)
    jstep32 = jwhite.make_white_step_fn(cache=jcache32, num_derivatives=2, f=None, df=None,
                                        linear=True)
    cache64 = interop.white_cache(**{k: np.asarray(v) for k, v in jsolver._cache._asdict().items()},
                                  device=CPU)
    cache32 = interop.white_cache(**{k: _f32(v) for k, v in jsolver._cache._asdict().items()},
                                  device=CPU)
    assert all(x.dtype == torch.float32 for x in cache32)
    step64 = pt.white.make_white_step_fn(cache=cache64, num_derivatives=2)
    step32 = pt.white.make_white_step_fn(cache=cache32, num_derivatives=2)

    mean64 = torch.tensor(np.asarray(jstate.y.mean))
    cov64 = torch.tensor(np.asarray(jstate.y.cov_sqrtm))
    mean32, cov32 = mean64.float(), cov64.float()
    jmean32 = jstate.y.mean.astype(jnp.float32)
    jcov32 = jstate.y.cov_sqrtm.astype(jnp.float32)
    for k in range(20):
        t_next = 0.05 * (k + 1)
        mean64, cov64, *_ = step64(mean64, cov64, t_next, 0.05)
        mean32, cov32, error, reference, diffusion = step32(mean32, cov32, t_next, 0.05)
        jmean32, jcov32, *_ = jstep32(jmean32, jcov32, jnp.asarray(t_next, jnp.float32),
                                      jnp.asarray(0.05, jnp.float32))
    assert {x.dtype for x in (mean32, cov32, error, reference, diffusion)} == {torch.float32}
    assert bool(torch.isfinite(mean32).all() and torch.isfinite(cov32).all())
    assert _rel(mean32, mean64) < 1e-4
    assert _rel(mean32, jmean32) < 1e-4


def test_latent_step_f32_stays_finite_and_tracks_jax():
    jheat = jexamples.heat_1d_discretized(dx=0.1, tmax=1.0)
    jsolver = jlatent.LinearLatentForceEK1(steprule=jstep.Constant(0.05))
    jstate = jsolver.initialize(jheat)
    jcache32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jsolver._cache)
    jstep32 = jlatent.make_latent_step_fn(cache=jcache32, num_derivatives=2, f=None, df=None,
                                          linear=True)
    cache32 = interop.latent_cache(**{k: _f32(v) for k, v in jsolver._cache._asdict().items()},
                                   device=CPU)
    step32 = pt.latent.make_latent_step_fn(cache=cache32, num_derivatives=2)
    mean = torch.tensor(_f32(jstate.y.mean))
    cov = torch.tensor(_f32(jstate.y.cov_sqrtm))
    jmean, jcov = jstate.y.mean.astype(jnp.float32), jstate.y.cov_sqrtm.astype(jnp.float32)
    for k in range(10):
        t_next = 0.05 * (k + 1)
        mean, cov, *_ = step32(mean, cov, t_next, 0.05)
        jmean, jcov, *_ = jstep32(jmean, jcov, jnp.asarray(t_next, jnp.float32),
                                  jnp.asarray(0.05, jnp.float32))
    assert mean.dtype == cov.dtype == torch.float32
    assert bool(torch.isfinite(mean).all() and torch.isfinite(cov).all())
    d = jheat.L.shape[0]
    assert _rel(mean[:, :d], jmean[:, :d]) < 1e-4


def test_solve_under_x32_mode():
    """Whole pipeline (discretize + init + solve) in the f32 policy (JAX's
    test at dx = 0.2): every output f32 and finite, and the solution u
    within 1e-5 of the f64 solve's (the port 4.2e-6; the JAX package's own
    f32 u sits 4.6e-6 from its f64 u on the CPU, the top derivative 4.3e-4
    in both; JAX's f32 run itself is held in the bench configuration's test
    below)."""
    sols = {}
    for x64 in (False, True):
        previous = pt.config.enable_x64(x64)
        try:
            heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.4, device=CPU)
            sols[x64] = pt.white.LinearWhiteNoiseEK1(
                steprule=pt.odetools.step.Constant(0.1),
                spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
            ).solve(heat)
        finally:
            pt.config.enable_x64(previous)
    sol = sols[False]
    for x in (sol.t, sol.mean, sol.cov_sqrtm, sol.diffusion_squared_calibrated):
        assert x.dtype == torch.float32
    assert bool(torch.isfinite(sol.mean).all() and torch.isfinite(sol.cov_sqrtm).all())
    assert _rel_max(sol.mean[:, 0], sols[True].mean[:, 0]) < 1e-5


@pytest.fixture(scope="module")
def jax_512_f32():
    """The JAX package's f32 runs at 512 points with the dx-adapted FD
    kernel (one compilation for both): its fine-dx pipeline test's final
    mean (10 steps of 0.005) and its work-precision driver's heat_512 row
    at dt 0.1 (10 steps, its f32 device leg built as its ``_child`` builds
    it), the row's interior u."""
    dx = 1.0 / 511
    runs = {}
    with jax_f32():
        for name, tmax, dt in (("fine_dx", 0.05, 0.005), ("row", 1.0, 0.1)):
            pde = jexamples.heat_1d_discretized(
                dx=dx, tmax=tmax, kernel=jkernels.SquareExponential(input_scale=0.1 / dx))
            final, info = jwhite.LinearWhiteNoiseEK1(
                num_derivatives=2, steprule=jstep.Constant(dt),
                spatial_kernel=jkernels.Matern52() + jkernels.WhiteNoise(),
            ).simulate_final_state(pde)
            assert final.y.mean.dtype == jnp.float32 and int(info["num_steps"]) == 10
            runs[name] = np.asarray(final.y.mean, np.float64)
    runs["row"] = runs["row"][0][1:-1]
    return runs


def test_fine_dx_pipeline_under_x32_mode(port_f32, jax_512_f32):
    """The bench's f32 configuration at fine dx (N = 512: the dx-adapted FD
    scale, the stencil dedupe, the structured init, f32 steps): every state
    tensor f32, finite, and the heat decays; u within 1e-4 of the JAX
    package's f32 u (its same test's run; 9.7e-6 measured)."""
    N = 512
    dx = 1.0 / (N - 1)
    heat = pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=0.05, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx),
        device=CPU)
    for name in ("L", "E_sqrtm", "B", "R_sqrtm", "y0"):
        assert getattr(heat, name).dtype == torch.float32, name
    assert heat.mesh_spatial.points.dtype == torch.float32
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(0.005),
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
    )
    final, info = solver.simulate_final_state(heat)
    assert info["num_steps"] == 10
    assert all(x.dtype == torch.float32 for x in solver._cache)
    for x in (final.y.mean, final.y.cov_sqrtm, final.diffusion_squared_local):
        assert x.dtype == torch.float32
    assert bool(torch.isfinite(final.y.mean).all() and torch.isfinite(final.y.cov_sqrtm).all())
    assert final.y.mean[0].abs().max() <= heat.y0.abs().max() * 1.01
    assert _rel_max(final.y.mean[0], jax_512_f32["fine_dx"][0]) < 1e-4


# --- the bench configuration in f32, against JAX's f32 -----------------------


@pytest.fixture(scope="module")
def jax_bench_f32():
    """JAX's bench configuration (dx-adapted SquareExponential, nu = 2,
    Matern52 + WhiteNoise, Constant(1e-3)) at 64 points, 20 steps, in f32:
    the final mean."""
    with jax_f32():
        dx = 1.0 / 63
        jheat = jexamples.heat_1d_discretized(
            dx=dx, tmax=0.02, kernel=jkernels.SquareExponential(input_scale=0.1 / dx))
        final, _ = jwhite.LinearWhiteNoiseEK1(
            steprule=jstep.Constant(1e-3), num_derivatives=2,
            spatial_kernel=jkernels.Matern52() + jkernels.WhiteNoise(),
        ).simulate_final_state(jheat)
        mean = np.asarray(final.y.mean)
    assert mean.dtype == np.float32
    return mean


def _port_bench(x64, factorization=None):
    previous = pt.config.enable_x64(x64)
    try:
        dx = 1.0 / 63
        heat = pt.pde.examples.heat_1d_discretized(
            dx=dx, tmax=0.02, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx),
            device=CPU)
        solver = pt.white.LinearWhiteNoiseEK1(
            steprule=pt.odetools.step.Constant(1e-3), num_derivatives=2,
            spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
            factorization=factorization)
        return solver.simulate_final_state(heat)
    finally:
        pt.config.enable_x64(previous)


@pytest.mark.parametrize("factorization", [None, "householder"], ids=["plain", "householder"])
def test_bench_configuration_f32_end_to_end_matches_jax(jax_bench_f32, factorization):
    """Built, initialized and stepped in f32 end to end: every state tensor
    f32; the solution u within 1e-4 of JAX's f32 u (9e-6 measured) and
    within 1e-3 of the port's f64 u (9.5e-5 measured; JAX's own f32 u sits
    1.0e-4 from its f64 u: the f32 stencil solves, module docstring)."""
    final, info = _port_bench(False, factorization)
    assert info["num_steps"] == 20
    assert {final.y.mean.dtype, final.y.cov_sqrtm.dtype,
            final.diffusion_squared_local.dtype} == {torch.float32}
    u32 = final.y.mean[0].numpy()
    u64 = _port_bench(True)[0].y.mean[0].numpy()
    assert _rel_max(u32, jax_bench_f32[0]) < 1e-4
    assert _rel_max(u32, u64) < 1e-3


def test_adaptive_controller_stays_in_f32(port_f32):
    """The adaptive rule's quantities (error estimate, reference, scaled
    error, local diffusion) are f32 tensors at every accepted step: no
    silent promotion to f64; t and dt are host floats, as in every rule."""
    dx = 1.0 / 63
    heat = pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=0.02, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx), device=CPU)
    rule = pt.odetools.step.Adaptive()
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=rule, num_derivatives=2,
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise())
    steps = 0
    for state, info in solver.solution_generator(heat):
        if not info["num_steps"]:
            continue
        steps += 1
        scaled = rule.scale_error_estimate(1e-3 * state.error_estimate, state.reference_state)
        for x in (state.y.mean, state.y.cov_sqrtm, state.error_estimate, state.reference_state,
                  state.diffusion_squared_local, scaled):
            assert x.dtype == torch.float32
    assert info["num_attempted_steps"] >= steps > 0
    assert state.t == pytest.approx(0.02, abs=1e-12)


def test_householder_hooks_in_f32_match_plain(port_f32):
    """The f32 LQ and R-form sweeps (the kernels' plain versions on the CPU)
    against torch.linalg.qr's Gram, at every precision; on the CPU the
    precision changes nothing, bitwise."""
    rng = np.random.default_rng(0)
    W = torch.tensor(rng.standard_normal((70, 150)), dtype=torch.float32)
    G = W.double() @ W.double().T
    outs = {}
    for precision in tq.PRECISIONS:
        L = tq.blocked_lq_l(W, leaf=8, block=32, precision=precision)
        R = tq.blocked_qr_r(W.T.contiguous(), leaf=8, block=32, precision=precision)
        assert L.dtype == R.dtype == torch.float32
        for F in (L, R.T):
            assert _rel_max(F.double() @ F.double().T, G) < 1e-5
        outs[precision] = (L, R)
    for precision in ("default", "high"):
        assert all(torch.equal(a, b) for a, b in zip(outs[precision], outs["highest"]))
    with pytest.raises(ValueError, match="precision"):
        tq.make_householder_lq_factorization(precision="bf16")
    with pytest.raises(ValueError, match="precision"):
        tq.make_householder_factorization(precision="fast")


def test_tf32_scope_is_restored():
    """``matmul_precision`` touches cuBLAS's TF32 switch only for CUDA f32
    tensors, so on the CPU it leaves the switch as it found it."""
    before = torch.backends.cuda.matmul.allow_tf32
    with tq.matmul_precision("default", torch.zeros(2, dtype=torch.float32)):
        assert torch.backends.cuda.matmul.allow_tf32 == before
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_dx_adapted_scale_is_f32_safe(port_f32):
    """Counterpart of tests/test_discretize_dedupe.py:79 on the f32 policy:
    at scale t/dx the stencil systems stay well conditioned at 2048 points,
    so the f32 weights are (1 + O(t^2)) x classical and within JAX's 1e-2
    of the f64 weights; the scale is JAX's; every interior row is the same
    (dedupe)."""
    num, t = 2048, 0.1
    dx = 1.0 / (num - 1)
    grid = pt.mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], num=num, device=CPU)
    scale = pt.discretize.dx_adapted_input_scale(grid, target=t)
    assert scale == pytest.approx(t / dx, rel=1e-6)
    jgrid = jmesh.RectangularMesh.from_bbox_1d([0.0, 1.0], num=num)
    assert scale == jdiscretize.dx_adapted_input_scale(jgrid, target=t)
    L32, E32 = pt.discretize.fd_probabilistic(
        pt.diffops.laplace(), grid, kernel=pt.kernels.SquareExponential(input_scale=scale))
    assert L32.dtype == E32.dtype == torch.float32
    pt.config.enable_x64(True)
    grid64 = pt.mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], num=num, device=CPU)
    L64, _ = pt.discretize.fd_probabilistic(
        pt.diffops.laplace(), grid64, kernel=pt.kernels.SquareExponential(input_scale=scale))
    mid, third = num // 2, num // 3
    row = L32[mid, mid - 1:mid + 2].double() * dx**2
    np.testing.assert_allclose(row.numpy(), [1.0, -2.0, 1.0], rtol=3.0 * t**2)
    np.testing.assert_allclose(L32[mid, mid - 1:mid + 2].numpy(),
                               L64[mid, mid - 1:mid + 2].numpy(), rtol=1e-2)
    # the same row up to f32 rounding: the k-NN returns the two equidistant
    # neighbours in either order, so two mirrored offset patterns are solved
    np.testing.assert_allclose(L32[mid, mid - 1:mid + 2].numpy(),
                               L32[third, third - 1:third + 2].numpy(), rtol=1e-6)


STEADY_N, STEADY_STEPS, STEADY_DT = 64, 64, 1e-2
STEADY_OPTIONS = {"f32": True, "promoted": {"dtype": "float64"}}
PROBLEM_ARRAYS = ("L", "E_sqrtm", "B", "R_sqrtm", "y0")


def _steady_solver(package, opts):
    return package.white.LinearWhiteNoiseEK1(
        steprule=package.odetools.step.Constant(STEADY_DT), num_derivatives=2,
        spatial_kernel=package.kernels.Matern52() + package.kernels.WhiteNoise(),
        steady_state=opts)


def _frozen(final, steady_cache):
    """The final mean and the frozen blocks, sign-free: the stationary
    covariance's and innovation's Grams, the gain L21 Sl^-1, err_vec."""
    sc = {k: np.asarray(v, np.float64) for k, v in steady_cache._asdict().items()
          if k in ("cov_inf", "L21", "Sl", "Sl_inv", "err_vec")}
    return np.asarray(final.y.mean), {
        "cov Gram": sc["cov_inf"] @ sc["cov_inf"].T, "Sl Gram": sc["Sl"] @ sc["Sl"].T,
        "gain": sc["L21"] @ sc["Sl_inv"], "err_vec": sc["err_vec"]}


@pytest.fixture(scope="module")
def jax_steady_f32(jax_bench_f32):
    """The JAX package's seeded steady state on its f32 problem at the
    bench's 64 points (whose f32 assembly and init ``jax_bench_f32`` has
    compiled), the recursion in f32 and promoted to f64: the problem's
    arrays and, for each, the final mean and the frozen blocks."""
    with jax_f32():
        dx = 1.0 / (STEADY_N - 1)
        jheat = jexamples.heat_1d_discretized(
            dx=dx, tmax=STEADY_STEPS * STEADY_DT,
            kernel=jkernels.SquareExponential(input_scale=0.1 / dx))
        arrays = {k: np.asarray(getattr(jheat, k)) for k in PROBLEM_ARRAYS}
        arrays["points"] = np.asarray(jheat.mesh_spatial.points)
        runs = {}
        for name, opts in STEADY_OPTIONS.items():
            solver = _steady_solver(pnmol_tpu, opts)
            final, _ = solver.simulate_final_state(jheat)
            runs[name] = _frozen(final, solver.steady_cache)
    assert {a.dtype for a in arrays.values()} == {np.dtype(np.float32)}
    return arrays, runs


def test_steady_state_f32_seeded_and_promoted(jax_steady_f32):
    """The seeded steady state on the JAX package's f32 problem, carried
    across at f32: in f32 (the recursion in the problem's dtype, default
    tolerance 1e-5) and promoted with ``dtype="float64"``. Both caches f32,
    finite; against JAX's same runs, u 1e-5 (measured 1.9e-6 and 4.2e-7),
    the mean 1e-3 (norm; 4.6e-5, 3.5e-5), the stationary covariance's Gram
    1e-3 (5.6e-5, 1.6e-7), the gain L21 Sl^-1 1e-2 (f32: 2.4e-3 of its
    largest entry; promoted 8.8e-8), the innovation's Gram and err_vec
    1e-5; and u 1e-4 from the f64 recursion and steps on the same operators
    (2.7e-6, 3.8e-6)."""
    arrays, jruns = jax_steady_f32

    def run(opts, dtype):
        heat = interop.discretized_problem(
            **{k: v.astype(dtype) for k, v in arrays.items()}, t0=0.0,
            tmax=STEADY_STEPS * STEADY_DT, device=CPU)
        solver = _steady_solver(pt, opts)
        final, _ = solver.simulate_final_state(heat)
        return final, solver.steady_cache

    with common.precision_policy(torch.float32):
        runs = {name: run(opts, np.float32) for name, opts in STEADY_OPTIONS.items()}
    u64 = run(True, np.float64)[0].y.mean[0].numpy()
    tols = {"cov Gram": 1e-3, "Sl Gram": 1e-5, "gain": 1e-2, "err_vec": 1e-5}
    for name, (final, sc) in runs.items():
        assert all(x.dtype == torch.float32 for x in (sc.cov_inf, sc.L21, sc.Sl_inv, sc.err_vec))
        assert final.y.mean.dtype == torch.float32
        assert bool(torch.isfinite(final.y.mean).all()), name
        mean, blocks = _frozen(final, sc)
        jmean, jblocks = jruns[name]
        assert _rel_max(mean[0], jmean[0]) < 1e-5, name
        assert _rel(mean, jmean) < 1e-3, name
        for key, tol in tols.items():
            assert _rel_max(blocks[key], jblocks[key]) < tol, (name, key)
        assert _rel_max(mean[0], u64) < 1e-4, name


# --- the public names this slice adds ----------------------------------------


def test_fused_predict_update_matches_jax():
    rng = np.random.default_rng(1)
    m, D = 5, 9
    args = [rng.standard_normal(s) for s in ((m, D), (D, D), (m, D), (D, D))]
    R = np.tril(rng.standard_normal((m, m)))
    jout = jsqrt.fused_predict_update(*(jnp.asarray(a) for a in args), jnp.asarray(R))
    out = pt.ops.sqrt.fused_predict_update(*(torch.tensor(a) for a in args), torch.tensor(R))
    jpost, jgain, jinnov = (np.asarray(x) for x in jout)
    post, gain, innov = (x.numpy() for x in out)
    np.testing.assert_allclose(post @ post.T, jpost @ jpost.T, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(innov @ innov.T, jinnov @ jinnov.T, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gain, jgain, rtol=1e-9, atol=1e-12)


def test_batched_update_sqrt_matches_jax():
    rng = np.random.default_rng(2)
    H = rng.standard_normal((3, 4, 6))
    C = np.tril(rng.standard_normal((3, 6, 6)))
    jout = [np.asarray(x) for x in jsqrt.batched_update_sqrt(jnp.asarray(H), jnp.asarray(C))]
    out = [x.numpy() for x in pt.ops.sqrt.batched_update_sqrt(torch.tensor(H), torch.tensor(C))]
    assert [x.shape for x in out] == [x.shape for x in jout]
    for b in range(3):
        post, jpost = out[0][b], jout[0][b]
        np.testing.assert_allclose(post @ post.T, jpost @ jpost.T, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(out[1][b], jout[1][b], rtol=1e-8, atol=1e-10)


def test_mesh_base_class_and_native_availability():
    assert issubclass(pt.mesh.RectangularMesh, pt.mesh.Mesh)
    with pytest.raises(TypeError):
        pt.mesh.Mesh(np.zeros((3, 1)), device=CPU)
    grid = pt.mesh.RectangularMesh(np.linspace(0.0, 0.1, 5)[:, None], device=CPU,
                                   dtype=torch.float32)
    assert grid.points.dtype == torch.float32 and grid._points_host.dtype == np.float64
    assert int(grid.boundary[1].sum()) == 2
    from pnmol_tpu import native as jnative

    assert pt.native.available() == jnative.available()


def test_interop_carries_f32_arrays_at_their_dtype():
    source = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=CPU)
    arrays = {k: _f32(getattr(source, k)) for k in ("L", "E_sqrtm", "B", "R_sqrtm", "y0")}
    points = source.mesh_spatial.points.numpy()
    heat = interop.discretized_problem(**arrays, points=points, t0=0.0, tmax=0.5, device=CPU)
    assert {getattr(heat, k).dtype for k in arrays} == {torch.float32}
    assert heat.mesh_spatial.points.dtype == torch.float32
    heat64 = interop.discretized_problem(
        **{k: np.asarray(v, np.float64) for k, v in arrays.items()},
        points=points, t0=0.0, tmax=0.5, device=CPU)
    assert heat64.L.dtype == heat64.mesh_spatial.points.dtype == torch.float64


# --- the drivers' f32 legs ----------------------------------------------------


def test_scale_demo_step_under_the_f32_policy_with_steady_dtype(port_f32):
    from pnmol_tpu_torch.experiments import scale_demo

    assert scale_demo.steady_options(True, dtype="float64") == {"dtype": "float64"}
    record = scale_demo.step("cpu", n=33, dim=1, nu=1, steps=2, steady_state=True,
                             steady_dtype="float64", dt=1e-2)
    assert record["dtype"] == "float32" and record["nan_free"] and record["heat_decays"]
    with pytest.raises(SystemExit):
        scale_demo.main(["step", "--steady-dtype", "float16"])


def test_work_precision_f32_leg_matches_jax_f32_row(jax_512_f32):
    """A ``_f32`` leg builds and solves in f32 (its reference stays f64)
    and leaves the caller's policy as it was; ``heat_512`` in f32 at dt 0.1
    against the JAX package's f32 row, solved here: the RMSE within 1e-2
    (the port 0.15385, JAX 0.15366, 1.2e-3 apart: the f32 floor, ten times
    the f64 row's 0.0176, ROADMAP 3.5), the interior u within 1e-3 of its
    largest entry (3.7e-4)."""
    from pnmol_tpu_torch.experiments import work_precision as wp

    assert wp.parse_leg("heat_512_cuda_f32") == ("heat", 512, "cuda")
    assert wp.leg_dtype("lv_cpu_f32") == torch.float32 and wp.leg_dtype("lv_cpu") == torch.float64
    (row,) = wp.run_leg("lv_cpu_f32", dts=[0.316])["rows"]
    assert pt.config.default_dtype() == torch.float64
    assert row["dtype"] == "float32" and row["num_steps"] == 4 and np.isfinite(row["rmse_rel"])
    with common.precision_policy(torch.float32):
        problem = wp.Problem("heat", 512, torch.device(CPU))
        u_ref, _ = wp.reference(problem)
        extract, kept = problem.extract, {}

        def keep(final, solver):  # the row's interior mean, for the comparison
            kept["u"], cov = extract(final, solver)
            return kept["u"], cov

        problem.extract = keep
        row = wp.solve_row(problem, 0.1, u_ref, None, "cpu")
    u_jax = jax_512_f32["row"]
    rel = np.abs(u_jax - u_ref) / np.abs(u_ref)
    rmse_jax = np.linalg.norm(rel) / np.sqrt(rel.size)
    assert row["dtype"] == "float32" and row["num_steps"] == 10
    assert abs(row["rmse_rel"] / rmse_jax - 1) < 1e-2
    assert _rel_max(kept["u"].numpy(), u_jax) < 1e-3


ZOO = {
    "heat_neumann": lambda ex: ex.heat_1d_discretized(dx=0.1, tmax=0.1, bcond="neumann",
                                                      device=CPU),
    "sir": lambda ex: ex.sir_1d_discretized(dx=0.1, tmax=0.1, device=CPU),
    "lotka_volterra": lambda ex: ex.lotka_volterra_1d_discretized(dx=0.1, tmax=0.1, device=CPU),
    "spruce_budworm": lambda ex: ex.spruce_budworm_1d_discretized(dx=0.1, tmax=0.1, device=CPU),
    "heat_2d": lambda ex: ex.heat_2d_discretized(num_points=(6, 6), tmax=0.1, device=CPU),
    "advection_3d": lambda ex: ex.advection_diffusion_discretized(
        dim=3, num_points=(4, 4, 4), velocity=[1.0, 0.5, 0.2], tmax=0.1, device=CPU),
    "fisher_kpp_2d": lambda ex: ex.fisher_kpp_2d_discretized(num_points=(6, 6), tmax=0.1,
                                                             device=CPU),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_the_problem_zoo_builds_and_solves_in_f32(port_f32, name):
    """Every recipe's operators, boundary rows, initial value and
    nonlinearity come out f32 under the policy, and the white solver (the
    latent one too, for linear problems) steps them in f32 to finite
    values; the 1-D problems' MOL systems are f32 as well."""
    pde = ZOO[name](pt.pde.examples)
    for key in ("L", "E_sqrtm", "B", "R_sqrtm", "y0"):
        assert getattr(pde, key).dtype == torch.float32, key
    species = pde.L.shape[0] // pde.mesh_spatial.points.shape[0]
    kernel = pt.kernels.Matern52() + pt.kernels.WhiteNoise()
    if species > 1:
        kernel = pt.duplicate(kernel, species)
    linear = getattr(pde, "f", None) is None
    classes = ([pt.white.LinearWhiteNoiseEK1, pt.latent.LinearLatentForceEK1] if linear
               else [pt.white.SemiLinearWhiteNoiseEK1])
    if not linear:
        assert pde.f(0.0, pde.y0).dtype == pde.df(0.0, pde.y0).dtype == torch.float32
    for cls in classes:
        final, _ = cls(steprule=pt.odetools.step.Constant(0.05),
                       spatial_kernel=kernel).simulate_final_state(pde)
        assert final.y.mean.dtype == final.y.cov_sqrtm.dtype == torch.float32
        assert bool(torch.isfinite(final.y.mean).all())
    if pde.mesh_spatial.dimension == 1:
        ivp = pde.to_ivp()
        assert ivp.y0.dtype == ivp.f(0.0, ivp.y0).dtype == ivp.df(0.0, ivp.y0).dtype == torch.float32


def test_mol_baseline_and_collocation_in_f32(port_f32):
    heat = pt.pde.examples.heat_1d_discretized(dx=0.05, tmax=0.1, device=CPU)
    ivp = heat.to_ivp()
    for init in (pt.odetools.init.Stack(use_df=False), pt.odetools.init.TaylorMode(),
                 pt.odetools.init.RungeKutta()):
        sol, _ = pt.odetools.ek1.ReferenceEK1ConstantDiffusion(
            num_derivatives=2, steprule=pt.odetools.step.Constant(0.05),
            initialization=init).solve(ivp)
        assert sol.mean.dtype == torch.float32 and bool(torch.isfinite(sol.mean).all())
    D, E = pt.discretize.collocation_global(
        pt.diffops.laplace(), heat.mesh_spatial, kernel=pt.kernels.SquareExponential(5.0),
        nugget_gram_matrix=1e-6, nugget_cholesky_E=1e-3, symmetrize_cholesky_E=True)
    assert D.dtype == E.dtype == torch.float32 and bool(torch.isfinite(D).all())
