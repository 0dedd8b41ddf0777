"""The port's steady-state mode against the JAX package: the Riccati
convergence from the same factor, the doubling seed and the polish through
the whole solvers, the mean-only step, and the JAX package's own statements
of tests/test_solvers/test_steady_state.py mirrored on the port.

Seeded caches are compared to what the two packages' rounding allows: the
SDA fixed point carries a DARE residual of about 1e-8, so the seeded polish's
``delta`` (a change of the Gram diagonal of about 1e-9 to 1e-8) is held to
the polished factors' own agreement (absolute 1e-10), not to a relative
1e-6; unseeded and fixed-iteration ``delta`` values are held to rel 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.solvers import latent as jlatent
from pnmol_tpu.solvers import white as jwhite
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.ops import dare
from pnmol_tpu_torch.ops import qr_householder as tq

torch.set_num_threads(1)

CPU = "cpu"
TMAX = 0.2


def _port_problem(jheat):
    return interop.discretized_problem(
        L=np.asarray(jheat.L), E_sqrtm=np.asarray(jheat.E_sqrtm), B=np.asarray(jheat.B),
        R_sqrtm=np.asarray(jheat.R_sqrtm), y0=np.asarray(jheat.y0),
        points=np.asarray(jheat.mesh_spatial.points), t0=jheat.t0, tmax=jheat.tmax, device=CPU,
    )


@pytest.fixture(scope="module")
def heats():
    jheat = jexamples.heat_1d_discretized(dx=0.1, tmax=TMAX)
    return jheat, _port_problem(jheat)


@pytest.fixture(scope="module")
def jax_inits(heats):
    """The JAX package's (non-steady) white and latent solvers initialized on
    the module's problem, with their initial states."""
    out = {}
    for kind in SOLVERS:
        jsolver = SOLVERS[kind][0](steprule=jstep.Constant(0.05))
        out[kind] = (jsolver, jsolver.initialize(heats[0]))
    return out


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _gram(C):
    C = np.asarray(C)
    return C @ C.T


def _gain(cache):
    return np.asarray(cache.L21) @ np.asarray(cache.Sl_inv)


def _assert_caches_agree(got, want, *, gram=1e-9, gain=1e-8):
    """cov_inf Gram rel 1e-9, gain L21 Sl^{-1} rel 1e-8, err_vec rel 1e-12:
    the factors themselves are unique only up to rotations."""
    assert _rel(_gram(got.cov_inf), _gram(want.cov_inf)) <= gram
    assert _rel(_gain(got), _gain(want)) <= gain
    assert _rel(got.err_vec, want.err_vec) <= 1e-12


SOLVERS = {"white": (jwhite.LinearWhiteNoiseEK1, pt.white.LinearWhiteNoiseEK1),
           "latent": (jlatent.LinearLatentForceEK1, pt.latent.LinearLatentForceEK1)}


def _pair(kind, dt, **kw):
    jcls, tcls = SOLVERS[kind]
    return (jcls(steprule=jstep.Constant(dt), **kw),
            tcls(steprule=pt.odetools.step.Constant(dt), **kw))


def _port_cache(kind, jcache):
    arrays = {k: np.asarray(v) for k, v in jcache._asdict().items()}
    make = interop.white_cache if kind == "white" else interop.latent_cache
    return make(**arrays, device=CPU)


CONVERGE = {
    "white-fused": ("white", dict(fused=True), {}),
    "white-two-qr": ("white", dict(fused=False), {}),
    "white-dt-scaled": ("white", dict(fused=True), dict(meascov_dt_scaled=True)),
    "latent-fused": ("latent", dict(fused=True), {}),
    "latent-two-qr": ("latent", dict(fused=False), {}),
}


@pytest.mark.parametrize("case", list(CONVERGE))
def test_convergence_at_fixed_iterations_matches_jax(jax_inits, case):
    """Seven iterations of the covariance recursion from the JAX package's
    own initial factor (through interop), with the harvest: the caches to
    the stated tolerances, equal iterations, delta rel 1e-6."""
    kind, pipeline, extra = CONVERGE[case]
    jsolver, jstate = jax_inits[kind]
    C0 = jstate.y.cov_sqrtm
    jconverge = (jwhite.converge_white_steady_state if kind == "white"
                 else jlatent.converge_latent_steady_state)
    tconverge = (pt.white.converge_white_steady_state if kind == "white"
                 else pt.latent.converge_latent_steady_state)
    want = jconverge(jsolver._cache, C0, jnp.asarray(0.05), num_derivatives=2, tol=0.0,
                     max_iters=7, **pipeline, **extra)
    got = tconverge(_port_cache(kind, jsolver._cache), torch.tensor(np.asarray(C0)), 0.05,
                    num_derivatives=2, tol=0.0, max_iters=7, **pipeline, **extra)
    assert got.iterations == int(want.iterations) == 7
    assert got.delta == pytest.approx(float(want.delta), rel=1e-6)
    _assert_caches_agree(got, want)


@pytest.fixture(scope="module")
def whole_solves(heats):
    """Both packages' seeded white and unseeded latent steady solves at
    dt 0.05 and 0.01: ``{(kind, dt): (jax solver, jax solution, port solver,
    port solution)}``."""
    jheat, heat = heats
    out = {}
    for kind in SOLVERS:
        for dt in (0.05, 0.01):
            jsolver, tsolver = _pair(kind, dt, steady_state=True)
            out[kind, dt] = (jsolver, jsolver.solve(jheat), tsolver, tsolver.solve(heat))
    return out


@pytest.mark.parametrize("dt", [0.05, 0.01])
def test_whole_white_solver_matches_jax(whole_solves, dt):
    """``steady_state=True`` through initialize and solve: equal polish
    iterations, SDA iterations within 1, both DARE residuals below 1e-6,
    the caches, and the means to rel 1e-8."""
    jsolver, jsol, tsolver, tsol = whole_solves["white", dt]
    want, got = jsolver.steady_cache, tsolver.steady_cache
    jinfo, tinfo = jsolver.steady_diagnostics, tsolver.steady_diagnostics
    assert got.iterations == int(want.iterations)
    assert abs(tinfo["sda_iterations"] - int(jinfo["sda_iterations"])) <= 1
    assert tinfo["dare_residual"] < 1e-6 and jinfo["dare_residual"] < 1e-6
    assert abs(got.delta - float(want.delta)) <= 1e-10
    _assert_caches_agree(got, want)
    assert _rel(tsol.mean, jsol.mean) <= 1e-8
    np.testing.assert_allclose(tsol.t.numpy(), np.asarray(jsol.t), rtol=0, atol=1e-14)


@pytest.mark.parametrize("dt", [0.05, 0.01])
def test_whole_latent_solver_matches_jax(whole_solves, dt):
    """The latent steady solve (unseeded): equal iterations, delta rel 1e-6,
    the caches, the state half of the mean to rel 1e-8 and the stacked mean
    to 1e-6 (the noise-free measurement's conditioning)."""
    jsolver, jsol, tsolver, tsol = whole_solves["latent", dt]
    want, got = jsolver.steady_cache, tsolver.steady_cache
    assert got.iterations == int(want.iterations) < 200
    assert got.delta == pytest.approx(float(want.delta), rel=1e-6)
    _assert_caches_agree(got, want)
    d = jsol.mean.shape[-1] // 2
    assert _rel(tsol.mean[..., :d], np.asarray(jsol.mean)[..., :d]) <= 1e-8
    assert _rel(tsol.mean, jsol.mean) <= 1e-6


def test_mean_only_step_matches_jax(jax_inits, whole_solves):
    """The JAX package's frozen blocks handed to the port's mean-only step
    (interop.steady_cache): five steps from the same state, rel 1e-12."""
    jsolver = whole_solves["white", 0.05][0]
    steady = interop.steady_cache(
        **{k: (v if k in ("iterations", "delta") else np.asarray(v))
           for k, v in jsolver.steady_cache._asdict().items()}, device=CPU)
    assert steady.iterations == int(jsolver.steady_cache.iterations)
    step = pt.white.make_steady_state_white_step(
        cache=_port_cache("white", jsolver._cache), steady=steady, num_derivatives=2)
    jmean = jax_inits["white"][1].y.mean
    mean = torch.tensor(np.asarray(jmean))
    cov = steady.cov_inf
    for k in range(1, 6):
        jmean, _, jerr, jref, jdiff = jsolver._step_fn(jmean, None, 0.05 * k, jnp.asarray(0.05))
        mean, cov_out, err, ref, diff = step(mean, cov, 0.05 * k, 0.05)
        assert cov_out is cov
        assert _rel(mean, jmean) <= 1e-12 and _rel(ref, jref) <= 1e-12
        assert _rel(err, jerr) <= 1e-12 and diff.item() == pytest.approx(float(jdiff), rel=1e-12)


def test_meascov_dt_scaled_matches_jax(heats):
    """``meascov_dt_scaled=True`` (noise factor sqrt(dt) E) in the seed, the
    polish and the step."""
    jheat, heat = heats
    jsolver, tsolver = _pair("white", 0.01, steady_state=True, meascov_dt_scaled=True)
    jsol, tsol = jsolver.solve(jheat), tsolver.solve(heat)
    assert tsolver.steady_cache.iterations == int(jsolver.steady_cache.iterations)
    assert tsolver.steady_diagnostics["dare_residual"] < 1e-6
    # the smaller noise factor leaves the seed worse conditioned: the polished
    # gains agree to 1.0e-8 (measured), so the gain is held to 1e-7 here
    _assert_caches_agree(tsolver.steady_cache, jsolver.steady_cache, gain=1e-7)
    assert _rel(tsol.mean, jsol.mean) <= 1e-8


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_dense_system_matches_jax(jax_inits, kind):
    """The dense (A, H, Q, R, p) of the doubling seed, bitwise up to rounding."""
    jsolver = jax_inits[kind][0]
    cache = _port_cache(kind, jsolver._cache)
    if kind == "white":
        want = jwhite.white_dense_system(jsolver._cache, 0.05, num_derivatives=2)
        got = pt.white.white_dense_system(cache, 0.05, num_derivatives=2)
    else:
        want = jlatent.latent_dense_system(jsolver._cache, 0.05, num_derivatives=2)
        got = pt.latent.latent_dense_system(cache, 0.05, num_derivatives=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13, atol=1e-15)


def test_promoted_dtype_matches_jax(jax_inits):
    """``dtype="float64"`` on an f32 cache and factor: the recursion runs in
    f64 at tol 1e-8, the blocks come back in f32, and they agree with the
    JAX package's promoted run to f32 rounding (rel 1e-6)."""
    jsolver, jstate = jax_inits["white"]
    C0 = np.asarray(jstate.y.cov_sqrtm)
    jcache32 = jax.tree.map(lambda x: x.astype(jnp.float32), jsolver._cache)
    want = jwhite.run_steady_convergence(
        jwhite.converge_white_steady_state, jcache32, jnp.asarray(C0, jnp.float32),
        jnp.asarray(0.05, jnp.float32), {"dtype": "float64"}, 1e-5, num_derivatives=2)
    cache32 = type(_port_cache("white", jsolver._cache))(
        *(x.float() for x in _port_cache("white", jsolver._cache)))
    got = pt.white.run_steady_convergence(
        pt.white.converge_white_steady_state, cache32, torch.tensor(C0, dtype=torch.float32),
        float(np.float32(0.05)), {"dtype": "float64"}, 1e-5, num_derivatives=2)
    assert got.cov_inf.dtype == got.Sl_inv.dtype == got.err_vec.dtype == torch.float32
    assert got.iterations == int(want.iterations) and got.delta < 1e-8
    assert _rel(_gram(got.cov_inf), _gram(want.cov_inf)) <= 1e-6
    assert _rel(_gain(got), _gain(want)) <= 1e-5
    assert _rel(got.err_vec, want.err_vec) <= 1e-6


def test_frozen_gain_gap_matches_jax(heats, whole_solves):
    """Reference behaviour: the seeded cache (polish capped at 4 iterations)
    stops short of the recursion's fixed point. At dt 0.01 the default
    cache's gain is 5e-5 from that of an unseeded cache converged to tol
    1e-10 (at bench's N=128 it is 0.9%); the port's gap equals the JAX
    package's to rel 1e-6."""
    jseeded, _, tseeded, _ = whole_solves["white", 0.01]
    jsolver, tsolver = _pair("white", 0.01, steady_state={"seed": False, "tol": 1e-10,
                                                          "max_iters": 3000})
    jsolver.initialize(heats[0])
    tsolver.initialize(heats[1])
    assert tsolver.steady_cache.iterations == int(jsolver.steady_cache.iterations)
    jgap = _rel(_gain(jseeded.steady_cache), _gain(jsolver.steady_cache))
    tgap = _rel(_gain(tseeded.steady_cache), _gain(tsolver.steady_cache))
    assert tgap == pytest.approx(jgap, rel=1e-6) and tgap > 1e-5


def test_factored_dare_residual_matches_dense_and_jax(jax_inits):
    """The operator-form certificate equals the dense one to its own
    rounding (the JAX package's statement) and the JAX package's factored
    one to rel 1e-6."""
    jsolver = jax_inits["white"][0]
    cache = _port_cache("white", jsolver._cache)
    A, H, Q, R, _ = pt.white.white_dense_system(cache, 1e-3, num_derivatives=2)
    R_eps = R.clone()
    scale = torch.maximum(R.diagonal().max(), torch.einsum("ij,ij->i", H @ Q, H).max())
    R_eps.diagonal().add_(1e-12 * scale)
    Wh = torch.linalg.solve_triangular(torch.linalg.cholesky(R_eps), H, upper=False)
    G0 = Wh.T @ Wh
    sigma = dare.sda(A, G0, Q, tol=1e-12).sigma
    dense = dare.dare_residual(sigma, A, G0, Q).item()
    factored = pt.white._factored_dare_residual(sigma, Wh, cache.A1d, cache.Ql)
    assert abs(dense - factored) <= 1e-7 + 0.1 * max(dense, factored)
    want = float(jwhite._factored_dare_residual(
        jnp.asarray(sigma.numpy()), jnp.asarray(Wh.numpy()), jsolver._cache.A1d,
        jsolver._cache.Ql))
    assert factored == pytest.approx(want, rel=1e-6)


def test_factored_dare_residual_is_nan_where_sigma_has_no_cholesky(jax_inits):
    """Reference behaviour kept: an indefinite sigma makes the certificate
    NaN in both packages (the port reads cholesky_ex's info where JAX's
    factor is NaN); it is reported, never replaced."""
    jsolver = jax_inits["white"][0]
    cache = _port_cache("white", jsolver._cache)
    D = cache.Ql.shape[0]
    m = cache.E_bc_sqrtm.shape[0]
    sigma = np.eye(D)
    sigma[3, 3] = -1.0
    Wh = np.random.default_rng(0).standard_normal((m, D))
    want = float(jwhite._factored_dare_residual(jnp.asarray(sigma), jnp.asarray(Wh),
                                                jsolver._cache.A1d, jsolver._cache.Ql))
    got = pt.white._factored_dare_residual(torch.tensor(sigma), torch.tensor(Wh), cache.A1d,
                                           cache.Ql)
    assert math.isnan(want) and math.isnan(got)


def test_max_iters_zero_raises_in_both(heats):
    """``{"max_iters": 0}``: the JAX package dereferences an unset chunk
    (UnboundLocalError); the port refuses the option by name."""
    jheat, heat = heats
    jsolver, tsolver = _pair("white", 0.05, steady_state={"max_iters": 0})
    with pytest.raises(UnboundLocalError):
        jsolver.initialize(jheat)
    with pytest.raises(ValueError, match="max_iters"):
        tsolver.initialize(heat)


# --- the JAX package's own statements (tests/test_solvers/test_steady_state.py),
# on the port


def _port_solver(kind, **kw):
    return SOLVERS[kind][1](steprule=pt.odetools.step.Constant(0.05), **kw)


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_converged_factors_are_a_fixed_point(heats, kind):
    solver = _port_solver(kind, steady_state=True)
    solver.initialize(heats[1])
    steady = solver.steady_cache
    assert steady.iterations < 200 and steady.delta < 1e-8
    converge = (pt.white.converge_white_steady_state if kind == "white"
                else pt.latent.converge_latent_steady_state)
    again = converge(solver._cache, steady.cov_inf, 0.05, num_derivatives=2, max_iters=1)
    np.testing.assert_allclose(_gram(again.cov_inf), _gram(steady.cov_inf), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_frozen_step_matches_full_step_at_the_fixed_point(heats, kind):
    """Seeded at the stationary covariance, the full step's gain is the
    frozen one: eight frozen and eight full steps agree to rtol 1e-5."""
    heat = heats[1]
    solver, full = _port_solver(kind, steady_state=True), _port_solver(kind)
    state = solver.initialize(heat)
    full.initialize(heat)
    mean_full = mean_steady = state.y.mean
    cov = solver.steady_cache.cov_inf
    for k in range(1, 9):
        mean_full, cov, _, _, diff_full = full._step_fn(mean_full, cov, 0.05 * k, 0.05)
        mean_steady, _, _, _, diff_steady = solver._step_fn(
            mean_steady, solver.steady_cache.cov_inf, 0.05 * k, 0.05)
        np.testing.assert_allclose(mean_steady.numpy(), mean_full.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(diff_steady.item(), diff_full.item(), rtol=1e-5, atol=1e-9)


def test_seed_reaches_the_unseeded_fixed_point(heats):
    seeded = _port_solver("white", steady_state=True)
    seeded.initialize(heats[1])
    unseeded = _port_solver("white", steady_state={"seed": False, "max_iters": 5000,
                                                   "tol": 1e-12})
    unseeded.initialize(heats[1])
    a, b = seeded.steady_cache, unseeded.steady_cache
    np.testing.assert_allclose(_gram(a.cov_inf), _gram(b.cov_inf), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(_gain(a), _gain(b), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(a.err_vec.numpy(), b.err_vec.numpy(), rtol=1e-8)
    assert a.iterations <= 8 and b.iterations > a.iterations
    info = seeded.steady_diagnostics
    assert info["dare_residual"] < 1e-6 and info["sda_iterations"] < 64
    assert unseeded.steady_diagnostics == {}


@pytest.mark.parametrize("kind, bound", [("white", 1.0), ("latent", 1.05)])
def test_closed_loop_radius(heats, kind, bound):
    """The white frozen loop is contracting; the latent one reads slightly
    above 1 (undetectable integrator modes: a polynomial transient)."""
    solver = _port_solver(kind, steady_state=True)
    solver.initialize(heats[1])
    module = pt.white if kind == "white" else pt.latent
    rho = module.steady_closed_loop_radius(solver._cache, solver.steady_cache, 0.05,
                                           num_derivatives=2).item()
    assert 0.0 < rho < bound


def test_latent_steady_state_is_unseeded(heats):
    """The latent DARE has no finite solution: the dense recursion's
    diagonal keeps growing while its gain settles, so the latent solver
    converges the recursion itself and runs no doubling seed."""
    solver = _port_solver("latent", steady_state=True)
    solver.initialize(heats[1])
    assert solver.steady_diagnostics == {}
    assert torch.isfinite(solver.steady_cache.cov_inf).all()
    A, H, Q, _ = (x.numpy() for x in pt.latent.latent_dense_system(
        solver._cache, 0.05, num_derivatives=2)[:4])
    Sigma, diags, gains = Q.copy(), [], []
    for k in range(600):
        K = Sigma @ H.T @ np.linalg.inv(H @ Sigma @ H.T)
        Sigma = A @ (Sigma - K @ H @ Sigma) @ A.T + Q
        if k in (199, 399, 599):
            diags.append(np.diag(Sigma).max())
            gains.append(K)
    assert diags[2] > diags[1] > diags[0] and diags[2] - diags[0] > 0.2 * diags[0]
    assert np.abs(gains[2] - gains[1]).max() / np.abs(gains[2]).max() < 1e-2


def test_householder_hook_matches_the_plain_path(heats):
    """The small two-QR Householder hook (leaf 8, block 16, interleaved
    propagate) against the plain path: Grams of cov_inf and Sl to rtol 1e-6."""
    hook = tq.make_householder_lq_factorization(leaf=8, block=16)
    plain = _port_solver("white", steady_state=True)
    plain.initialize(heats[1])
    hooked = _port_solver("white", steady_state=True, factorization=hook, fused=False,
                          propagate_band="interleaved")
    hooked.initialize(heats[1])
    a, b = hooked.steady_cache, plain.steady_cache
    np.testing.assert_allclose(_gram(a.cov_inf), _gram(b.cov_inf), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(_gram(a.Sl), _gram(b.Sl), rtol=1e-6, atol=1e-9)
    assert a.iterations == b.iterations


@pytest.mark.parametrize(
    "make, match",
    [
        (lambda: pt.white.LinearWhiteNoiseEK1(steady_state=True), "Constant"),
        (lambda: pt.latent.LinearLatentForceEK1(steady_state=True), "Constant"),
        (lambda: pt.white.SemiLinearWhiteNoiseEK1(
            steprule=pt.odetools.step.Constant(0.05), steady_state=True), "LINEAR"),
        (lambda: pt.latent.SemiLinearLatentForceEK1(
            steprule=pt.odetools.step.Constant(0.05), steady_state=True), "LINEAR"),
    ],
    ids=["white-adaptive", "latent-adaptive", "white-semilinear", "latent-semilinear"],
)
def test_guards_raise_as_in_jax(heats, make, match):
    """Adaptive rules and semilinear solvers are refused at initialize (the
    semilinear ones on the module's heat arrays with a zero nonlinearity)."""
    jheat = heats[0]
    pde = heats[1] if match == "Constant" else interop.discretized_problem(
        L=np.asarray(jheat.L), E_sqrtm=np.asarray(jheat.E_sqrtm), B=np.asarray(jheat.B),
        R_sqrtm=np.asarray(jheat.R_sqrtm), y0=np.asarray(jheat.y0),
        points=np.asarray(jheat.mesh_spatial.points), t0=jheat.t0, tmax=jheat.tmax,
        device=CPU, f=lambda t, x: torch.zeros_like(x),
        df=lambda t, x: torch.zeros((x.shape[0], x.shape[0]), dtype=x.dtype))
    with pytest.raises(ValueError, match=match):
        make().initialize(pde)
