"""The port's sharded tier against the JAX package's, on 4 gloo ranks.

One counterpart for each case of ``tests/test_parallel.py`` outside the
steady-state tier. The port runs on 4 gloo CPU ranks, spawned once for the
file (``torch_parallel_ranks.parallel_cases``, a module that imports no
JAX); JAX runs here on ``meshes.make_mesh(4, batch=1)`` of the 8 virtual CPU
devices. Solver states and caches are JAX's, handed to the ranks as numpy
arrays (``interop``); matrices come from numpy seeds.

Tolerances: R factors by Gram to 1e-12 relative; Cholesky factors and
triangular solves 1e-12; a step's mean 1e-10. A step's covariance Gram and
a multi-step trajectory carry the Gram-based CholeskyQR panels' eps*cond
error, which depends on how the pre-array's rows are split: on the dx=1/15
heat the fused step's posterior Gram is 2e-8 from the unsharded one on the
port's 4-rank split, 1.6e-10 on JAX's 4-device split and 6.7e-9 on JAX's
one device. The fused distributed step is held to 1e-7 there; the others
hold JAX's own tolerances of ``tests/test_parallel.py`` (the
factorization-hook trajectory JAX's 1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pnmol_tpu_torch as pt  # noqa: E402
from pnmol_tpu import diffops, discretize, kernels, mesh  # noqa: E402
from pnmol_tpu.models import examples  # noqa: E402
from pnmol_tpu.odetools import step as step_module  # noqa: E402
from pnmol_tpu.parallel import ensembles as jens  # noqa: E402
from pnmol_tpu.parallel import meshes as jmeshes  # noqa: E402
from pnmol_tpu.parallel import sharded_filter as jfilter  # noqa: E402
from pnmol_tpu.parallel import sharded_linalg as jlinalg  # noqa: E402
from pnmol_tpu.solvers import latent, white  # noqa: E402
from pnmol_tpu_torch.parallel import distributed, sharded_linalg  # noqa: E402

import torch_parallel_ranks  # noqa: E402

PRIOR = kernels.Matern52() + kernels.WhiteNoise()


def _problem_arrays(pde):
    return dict(L=np.asarray(pde.L), E_sqrtm=np.asarray(pde.E_sqrtm), B=np.asarray(pde.B),
                R_sqrtm=np.asarray(pde.R_sqrtm), y0=np.asarray(pde.y0),
                points=np.asarray(pde.mesh_spatial.points), t0=float(pde.t0),
                tmax=float(pde.tmax))


def _solver_arrays(solver, state):
    arrays = {k: np.asarray(v) for k, v in solver._cache._asdict().items()}
    arrays.update(mean=np.asarray(state.y.mean), cov=np.asarray(state.y.cov_sqrtm))
    return arrays


def _white_setup(pde, dt, cls=white.LinearWhiteNoiseEK1, **kw):
    solver = cls(steprule=step_module.Constant(dt), spatial_kernel=PRIOR, **kw)
    state = solver.initialize(pde)
    return solver, state


@pytest.fixture(scope="module")
def jax_mesh():
    return jmeshes.make_mesh(4, batch=1)


@pytest.fixture(scope="module")
def setups():
    heat15 = examples.heat_1d_discretized(dx=1.0 / 15, tmax=1.0)
    out = {"heat15": heat15}
    out["white15"] = _white_setup(heat15, 0.05)
    lat = latent.LinearLatentForceEK1(steprule=step_module.Constant(0.05))
    out["latent15"] = (lat, lat.initialize(heat15))
    heat2d = examples.heat_2d_discretized(num_points=(8, 8), tmax=1.0)
    out["white2d"] = _white_setup(heat2d, 0.01)
    spruce = examples.spruce_budworm_1d_discretized(bbox=[0.0, 1.0], dx=1.0 / 15, tmax=1.0)
    out["spruce"] = (spruce,) + _white_setup(spruce, 0.01, white.SemiLinearWhiteNoiseEK1)
    heat8 = examples.heat_1d_discretized(dx=0.125, tmax=1.0)
    out["sweep"] = (heat8,) + _white_setup(heat8, 0.5)
    heat4 = examples.heat_1d_discretized(dx=0.25, tmax=1.0)
    members = []
    for s in (0.8, 1.0, 1.2, 1.4):
        solver = white.LinearWhiteNoiseEK1(
            steprule=step_module.Constant(0.05),
            spatial_kernel=kernels.Matern52(input_scale=s) + kernels.WhiteNoise())
        members.append((solver, solver.initialize(heat4)))
    out["ensemble"] = members
    heat15s = examples.heat_1d_discretized(dx=1.0 / 15, tmax=0.25)
    for latent_mode in (False, True):
        cls = latent.LinearLatentForceEK1 if latent_mode else white.LinearWhiteNoiseEK1
        solver = cls(steprule=step_module.Constant(0.05), steady_state=True)
        out[f"steady15_{latent_mode}"] = (heat15s, solver, solver.initialize(heat15s))
    heat23 = examples.heat_1d_discretized(dx=1 / 23, tmax=1.0)
    out["seeded23"] = (heat23,) + _white_setup(heat23, 0.01, steady_state=True)
    steadies = []
    for dt in SWEEP_DTS:
        solver = white.LinearWhiteNoiseEK1(steprule=step_module.Constant(dt),
                                           spatial_kernel=PRIOR, steady_state=True)
        final, _ = solver.simulate_final_state(heat8)
        steadies.append((solver, final))
    out["steady_sweep"] = steadies
    out["grid32"] = mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], num=32)
    out["grid96"] = mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], num=96)
    out["rule"] = step_module.Adaptive(abstol=1e-4, reltol=1e-2)
    return out


SWEEP_DTS = (0.5, 0.2, 0.09)


def _steady_arrays(steady):
    return {k: np.asarray(v) for k, v in steady._asdict().items()}


def _sda_inputs():
    """The (A, G, Q) of the JAX package's doubling test, numpy seed 3."""
    rng = np.random.default_rng(3)
    D = 24
    M = rng.normal(size=(D, D))
    A = 0.9 * M / np.max(np.abs(np.linalg.eigvals(M)))
    Gh = rng.normal(size=(D, D))
    G = Gh @ Gh.T / D + 0.1 * np.eye(D)
    Qh = rng.normal(size=(D, D))
    Q = Qh @ Qh.T / D + 0.1 * np.eye(D)
    return dict(A=A, G=G, Q=Q)


@pytest.fixture(scope="module")
def port(setups):
    """The port's results of every case, from 4 gloo ranks (rank 0's dict
    first)."""
    s = setups
    payload = dict(
        grid32=np.asarray(s["grid32"].points), grid96=np.asarray(s["grid96"].points),
        heat15=_solver_arrays(*s["white15"]), latent15=_solver_arrays(*s["latent15"]),
        heat2d=_solver_arrays(*s["white2d"]), spruce=_solver_arrays(*s["spruce"][1:]),
        sweep=_solver_arrays(*s["sweep"][1:]), sweep_dts=SWEEP_DTS,
        ensemble=[_solver_arrays(*m) for m in s["ensemble"]],
        problem15=_problem_arrays(s["heat15"]),
        adaptive_dt0=float(s["rule"].first_dt(
            examples.heat_1d_discretized(dx=1.0 / 15, tmax=0.3))),
        steady15_white=dict(_solver_arrays(*s["steady15_False"][1:]),
                            steady=_steady_arrays(s["steady15_False"][1].steady_cache)),
        steady15_latent=dict(_solver_arrays(*s["steady15_True"][1:]),
                             steady=_steady_arrays(s["steady15_True"][1].steady_cache)),
        seeded23=_solver_arrays(*s["seeded23"][1:]), sda=_sda_inputs(),
        steady_sweep=_solver_arrays(s["steady_sweep"][0][0],
                                    s["steady_sweep"][0][0].initialize(s["sweep"][0])),
        sweep_steadies=[_steady_arrays(solver.steady_cache) for solver, _ in s["steady_sweep"]],
    )
    runs = distributed.spawn_ranks(torch_parallel_ranks.parallel_cases, 4, backend="gloo",
                                   device="cpu", payload=payload, timeout=600)
    return [result for result, _ in runs]


def _gram(x):
    return x @ x.T


def _close_gram(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    ga, gb = a.T @ a, b.T @ b
    return np.abs(ga - gb).max() <= rtol * np.abs(gb).max()


def _jit(fn, *args, **kw):
    """A JAX sharded function under ``jit`` (eager shard_map dispatch
    compiles op by op)."""
    return jax.jit(lambda *a: fn(*a, **kw))(*args)


def _step_expected(solver, state, dt):
    return solver._step_fn(state.y.mean, state.y.cov_sqrtm, jnp.asarray(dt), jnp.asarray(dt))


def test_make_mesh_shapes(port):
    got = port[0]
    assert got["mesh_default"] == {"batch": 2, "space": 2}
    assert got["mesh_batch4"] == {"batch": 4, "space": 1}
    assert got["mesh_batch3"] == "ValueError"
    assert sorted(r["rank"] for r in port) == [0, 1, 2, 3]


def test_sharded_gram_matches_local(port, setups, jax_mesh):
    grid = setups["grid32"]
    kernel = kernels.SquareExponential(input_scale=2.0)
    expected = np.asarray(jlinalg.sharded_gram(kernel, grid.points, jax_mesh))
    assert np.allclose(port[0]["gram"], expected, rtol=0, atol=1e-12)


@pytest.mark.parametrize("key,grid", [("collocation", "grid32"), ("collocation96", "grid96")],
                         ids=["32", "96"])
def test_sharded_collocation_matches_local(port, setups, jax_mesh, key, grid):
    # ill-conditioned Grams: the JAX test's own tolerances, on D's action
    # on a smooth function and on E's Gram
    grid = setups[grid]
    kwargs = dict(kernel=kernels.SquareExponential(input_scale=2.0), nugget_gram_matrix=1e-8,
                  nugget_cholesky_E=1e-10, symmetrize_cholesky_E=True)
    D_j, E_j = jlinalg.sharded_collocation_global(diffops.laplace(), grid, jax_mesh, **kwargs)
    D_l, E_l = discretize.collocation_global(diffops.laplace(), grid, **kwargs)
    got = port[0][key]
    f = np.sin(3.0 * np.asarray(grid.points)[:, 0])
    for D, E in ((np.asarray(D_j), np.asarray(E_j)), (np.asarray(D_l), np.asarray(E_l))):
        assert np.allclose(got["D"] @ f, D @ f, atol=1e-6)
        assert np.allclose(_gram(got["E"]), _gram(E), atol=1e-8)
    assert np.allclose(got["E"], np.tril(got["E"]), atol=0)
    assert all(r[key]["local"][0] < len(f) for r in port)


def test_tsqr_matches_dense_qr(port, jax_mesh):
    mat = jnp.asarray(np.random.default_rng(0).normal(size=(256, 32)))
    R_j = np.asarray(_jit(jlinalg.tsqr_r, mat, mesh=jax_mesh))
    assert port[0]["tsqr"].shape == (32, 32)
    assert _close_gram(port[0]["tsqr"], R_j)


def test_tsqr_rejects_short_blocks(port, jax_mesh):
    with pytest.raises(ValueError):
        jlinalg.tsqr_r(jnp.ones((16, 32)), jax_mesh)
    assert all(r["tsqr_short"] == "ValueError" for r in port)


def test_sharded_triangular_solve_matches_dense(port, jax_mesh):
    rng = np.random.default_rng(3)
    R = jnp.asarray(np.triu(rng.normal(size=(24, 24)) + 3 * np.eye(24)))
    B = jnp.asarray(rng.normal(size=(24, 50)))
    X_j = np.asarray(_jit(jlinalg.sharded_triangular_solve, R, B, mesh=jax_mesh))
    assert np.allclose(port[0]["trisolve"], X_j, rtol=0, atol=1e-12)


@pytest.mark.parametrize("key,seed,shape,panel", [
    ("blocked_qr", 1, (200, 96), 32), ("blocked_qr_uneven", 2, (160, 50), 16)],
    ids=["squarish", "uneven_panels"])
def test_blocked_qr_matches_dense_qr(port, jax_mesh, key, seed, shape, panel):
    mat = jnp.asarray(np.random.default_rng(seed).normal(size=shape))
    R_j = np.asarray(_jit(jlinalg.blocked_qr_r, mat, mesh=jax_mesh, panel_size=panel))
    got = port[0][key]
    assert got.shape == (shape[1], shape[1])
    assert np.allclose(got, np.triu(got), atol=0)
    assert _close_gram(got, R_j)
    assert _close_gram(got, np.linalg.qr(np.asarray(mat), mode="r"))


def test_blocked_qr_r_sharded_matches_replicated(port, jax_mesh):
    for (mat, R, local), ps in zip(port[0]["blocked_qr_sharded"], (32, 16, 16)):
        R_j = np.asarray(_jit(jlinalg.blocked_qr_r_sharded, jnp.asarray(mat), mesh=jax_mesh,
                              panel_size=ps, loop="unrolled"))
        cols = mat.shape[1]
        assert R.shape == (cols, cols)
        assert np.allclose(R, np.triu(R), atol=0)
        assert _close_gram(R, R_j)
        assert local[0] < cols  # each rank holds its rows only
    assert sum(r["blocked_qr_sharded"][0][2][0] for r in port) == 96


def test_blocked_cholesky_matches_dense(port, jax_mesh):
    for (G, L, local), panel in zip(port[0]["cholesky"], (8, 16, 8)):
        L_j = np.asarray(_jit(jlinalg.blocked_cholesky, jnp.asarray(G), mesh=jax_mesh,
                              panel_size=panel))
        assert np.allclose(L, L_j, rtol=0, atol=1e-12)
        assert np.allclose(L, np.linalg.cholesky(G), rtol=0, atol=1e-12)
        assert local[0] == -(-G.shape[0] // 4)


def test_blocked_tri_solve_matches_dense(port, jax_mesh):
    got = port[0]["tri_solve"]
    L, B = jnp.asarray(got["L"]), jnp.asarray(got["B"])
    fwd = _jit(jlinalg.blocked_tri_solve_lower, L, B, mesh=jax_mesh, panel_size=8)
    bwd = _jit(jlinalg.blocked_tri_solve_lower, L, B, mesh=jax_mesh, panel_size=8,
               transpose=True)
    cho = _jit(jlinalg.blocked_cho_solve, L, B, mesh=jax_mesh, panel_size=8)
    for key, ref in (("fwd", fwd), ("bwd", bwd), ("cho", cho)):
        assert np.allclose(got[key], np.asarray(ref), rtol=0, atol=1e-12), key
    assert np.allclose(got["cho"], jax.scipy.linalg.cho_solve((L, True), B), atol=1e-12)


def test_ring_matmul_matches_dense(port, jax_mesh):
    for A, X, out in port[0]["ring"]:
        ref = np.asarray(_jit(jlinalg.ring_matmul, jnp.asarray(A), jnp.asarray(X), mesh=jax_mesh))
        assert out.shape == (A.shape[0], X.shape[1])
        assert np.allclose(out, ref, rtol=0, atol=1e-12)
        assert np.allclose(out, A @ X, rtol=0, atol=1e-12)


def test_gram_rowsharded_and_whiten_pipeline(port, jax_mesh):
    import scipy.linalg as sla

    for X, S, z, w in port[0]["whiten"]:
        m = X.shape[0]
        S_j = np.asarray(_jit(jlinalg.gram_rowsharded, jnp.asarray(X), mesh=jax_mesh))
        assert S.shape == S_j.shape
        assert np.allclose(S, S_j, rtol=0, atol=1e-12)
        if S.shape[0] > m:
            assert np.array_equal(S[m:, m:], np.eye(S.shape[0] - m))
            assert np.array_equal(S[:m, m:], np.zeros((m, S.shape[0] - m)))
        L_j = _jit(jlinalg.blocked_cholesky, jnp.asarray(S_j), mesh=jax_mesh)
        w_j = np.asarray(_jit(jlinalg.blocked_cho_solve, L_j, jnp.asarray(z), mesh=jax_mesh))
        assert np.allclose(w, w_j, rtol=0, atol=1e-12)
        assert np.allclose(w, sla.cho_solve((np.linalg.cholesky(S), True), z), atol=1e-9)


def test_chol_pad_geometry_bounded_in_devices():
    from unittest import mock

    d = 123944
    for P in (8, 32, 64, 256):
        grid = mock.Mock()
        grid.shape = {"space": P}
        b, r_loc, d_pad = sharded_linalg._chol_pad_geometry(d, grid, "space", 16384)
        assert (b, r_loc, d_pad) == jlinalg._chol_pad_geometry(d, grid, "space", 16384)
        assert b <= -(-d // P)
        assert d_pad < 2 * d


def _jax_step(cache, mesh_, state, dt, **kw):
    step = jfilter.make_space_sharded_white_step(cache=cache, num_derivatives=2, mesh=mesh_,
                                                 linear=True, **kw)
    with mesh_:
        return step(state.y.mean, state.y.cov_sqrtm, jnp.asarray(dt), jnp.asarray(dt))


@pytest.mark.parametrize("key,setup,dt,panel,gram_atol", [
    ("step_dqr", "white15", 0.05, 16, 1e-7), ("step_dqr_2d", "white2d", 0.01, 32, 1e-7)],
    ids=["1d", "2d"])
def test_space_sharded_step_distributed_qr_matches_unsharded(port, setups, jax_mesh, key, setup,
                                                             dt, panel, gram_atol):
    solver, state = setups[setup]
    expected = _step_expected(solver, state, dt)
    cache = jfilter.shard_cache(solver._cache, jax_mesh, distributed_qr=True)
    sharded = _jax_step(cache, jax_mesh, state, dt, distributed_qr=True, panel_size=panel)
    got = port[0][key]
    for ref in (expected, sharded):
        assert np.allclose(got["mean"], ref[0], rtol=0, atol=1e-10)
        assert np.allclose(_gram(got["cov"]), _gram(np.asarray(ref[1])), atol=gram_atol)
        assert np.allclose(got["diff"], ref[4], rtol=1e-8)
        assert np.allclose(got["err"], ref[2], rtol=1e-6, atol=1e-12)
    D = got["cov"].shape[0]
    assert got["local"] == (D, -(-D // 4))


def test_space_sharded_white_step_matches_unsharded(port, setups, jax_mesh):
    solver, state = setups["white15"]
    expected = _step_expected(solver, state, 0.05)
    sharded = _jax_step(jfilter.shard_cache(solver._cache, jax_mesh), jax_mesh, state, 0.05)
    got = port[0]["step_rows"]
    for ref in (expected, sharded):
        assert np.allclose(got["mean"], ref[0], rtol=0, atol=1e-10)
        assert np.allclose(_gram(got["cov"]), _gram(np.asarray(ref[1])), atol=1e-12)
    assert got["local"] == (12, 48)


def test_space_sharded_step_two_qr_matches_unsharded(port, setups, jax_mesh):
    solver, state = setups["white15"]
    expected = _step_expected(solver, state, 0.05)
    cache = jfilter.shard_cache(solver._cache, jax_mesh, distributed_qr=True,
                                shard_operands=True)
    sharded = _jax_step(cache, jax_mesh, state, 0.05, distributed_qr=True, panel_size=16,
                        two_qr=True)
    got = port[0]["step_two_qr"]
    for ref in (expected, sharded):
        assert np.allclose(got["mean"], ref[0], rtol=0, atol=1e-9)
        assert np.allclose(_gram(got["cov"]), _gram(np.asarray(ref[1])), atol=1e-5)
        assert np.allclose(got["diff"], ref[4], rtol=1e-6)
        assert np.allclose(got["err"], ref[2], rtol=1e-4, atol=1e-12)
    assert got["local"] == (48, 12)


def test_space_sharded_latent_step_matches_unsharded(port, setups, jax_mesh):
    solver, state = setups["latent15"]
    expected = _step_expected(solver, state, 0.05)
    cache = jfilter.shard_cache(solver._cache, jax_mesh, distributed_qr=True)
    step = jfilter.make_space_sharded_latent_step(cache=cache, num_derivatives=2,
                                                  mesh=jax_mesh, linear=True,
                                                  distributed_qr=True, panel_size=16)
    with jax_mesh:
        sharded = step(state.y.mean, state.y.cov_sqrtm, jnp.asarray(0.05), jnp.asarray(0.05))
    got = port[0]["step_latent"]
    for ref in (expected, sharded):
        assert np.allclose(got["mean"], ref[0], rtol=0, atol=1e-8)
        assert np.allclose(_gram(got["cov"]), _gram(np.asarray(ref[1])), atol=1e-7)
        assert np.allclose(got["diff"], ref[4], rtol=1e-7)
    assert got["local"] == (96, 24)


def test_space_sharded_semilinear_step_matches_unsharded(port, setups, jax_mesh):
    spruce, solver, state = setups["spruce"]
    expected = _step_expected(solver, state, 0.01)
    cache = jfilter.shard_cache(solver._cache, jax_mesh, distributed_qr=True)
    step = jfilter.make_space_sharded_white_step(cache=cache, num_derivatives=2, mesh=jax_mesh,
                                                 f=spruce.f, df=spruce.df, linear=False,
                                                 distributed_qr=True, panel_size=16)
    with jax_mesh:
        sharded = step(state.y.mean, state.y.cov_sqrtm, jnp.asarray(0.01), jnp.asarray(0.01))
    got = port[0]["step_semilinear"]
    for ref in (expected, sharded):
        assert np.allclose(got["mean"], ref[0], rtol=0, atol=1e-10)
        assert np.allclose(_gram(got["cov"]), _gram(np.asarray(ref[1])), atol=1e-7)
        assert np.allclose(got["diff"], ref[4], rtol=1e-6)


def test_solver_level_factorization_hook():
    """The port's white solver takes the distributed pre-array QR as its
    factorization on a one-rank mesh (no process group): the trajectory
    holds JAX's own 1e-4 against the plain solve and against JAX's run of
    the same hook."""
    from pnmol_tpu_torch.parallel import meshes, sharded_filter

    heat_j = examples.heat_1d_discretized(dx=0.125, tmax=0.5)
    trivial = jmeshes.make_mesh(1, batch=1)
    fact = functools.partial(jfilter.pre_array_blocked_qr, mesh=trivial, panel_size=16)
    alt_j = white.LinearWhiteNoiseEK1(steprule=step_module.Constant(0.1), spatial_kernel=PRIOR,
                                      factorization=fact).solve(heat_j)
    heat = pt.pde.examples.heat_1d_discretized(dx=0.125, tmax=0.5, device="cpu")
    prior = pt.kernels.Matern52() + pt.kernels.WhiteNoise()
    hook = functools.partial(sharded_filter.pre_array_blocked_qr, mesh=meshes.make_mesh(),
                             panel_size=16)
    base = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.1),
                                        spatial_kernel=prior).solve(heat)
    alt = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.1),
                                       spatial_kernel=prior, factorization=hook).solve(heat)
    for ref_mean, ref_diff in ((base.mean, base.diffusion_squared_calibrated),
                               (alt_j.mean, alt_j.diffusion_squared_calibrated)):
        assert np.allclose(alt.mean.numpy(), np.asarray(ref_mean), atol=1e-4)
        assert np.allclose(float(alt.diffusion_squared_calibrated), float(ref_diff), rtol=1e-4)


def test_sharded_init_matches_single_device(port, setups):
    """The distributed init on JAX's problem arrays against JAX's
    single-device init: mean 1e-10, factor in Gram; and its cache and state
    drive the distributed-QR step to JAX's single-device step."""
    solver, state = setups["white15"]
    got = port[0]["init_False"]
    assert np.allclose(got["mean"], state.y.mean, rtol=0, atol=1e-10)
    C = np.asarray(state.y.cov_sqrtm)
    assert np.allclose(_gram(got["cov"]), _gram(C), atol=1e-8)
    D, d = C.shape[0], got["chol_gram"].shape[0]
    assert all(r["init_False"]["local_cov"] == (D, D // 4) for r in port)
    assert all(r["init_False"]["local_chol"] == (d // 4, d) for r in port)
    expected = _step_expected(solver, state, 0.05)
    assert np.allclose(got["step_mean"], expected[0], atol=1e-8)
    assert np.allclose(_gram(got["step_cov"]), _gram(np.asarray(expected[1])), atol=1e-7)


def test_sharded_latent_init_matches_single_device(port, setups):
    solver, state = setups["latent15"]
    got = port[0]["init_True"]
    assert got["mean"].shape == state.y.mean.shape
    assert np.allclose(got["mean"], state.y.mean, rtol=0, atol=1e-10)
    C = np.asarray(state.y.cov_sqrtm)
    assert np.allclose(_gram(got["cov"]), _gram(C), atol=1e-8)
    assert all(r["init_True"]["local_cov"] == (C.shape[0], C.shape[0] // 4) for r in port)
    expected = _step_expected(solver, state, 0.05)
    assert np.allclose(got["step_mean"], expected[0], atol=1e-8)
    assert np.allclose(_gram(got["step_cov"]), _gram(np.asarray(expected[1])), atol=1e-7)


@pytest.mark.parametrize("latent_mode", [False, True], ids=["white", "latent"])
def test_space_sharded_constant_solve_matches_final_state(port, latent_mode):
    heat = examples.heat_1d_discretized(dx=1.0 / 15, tmax=0.25)
    cls = latent.LinearLatentForceEK1 if latent_mode else white.LinearWhiteNoiseEK1
    final, info = cls(steprule=step_module.Constant(0.05)).simulate_final_state(heat)
    assert info["num_steps"] == 5
    got = port[0][f"constant_{latent_mode}"]
    assert np.allclose(got["mean"], final.y.mean, atol=1e-7 if latent_mode else 1e-8)
    assert np.allclose(_gram(got["cov"]), _gram(np.asarray(final.y.cov_sqrtm)),
                       atol=1e-6 if latent_mode else 1e-7)
    assert np.allclose(got["diff"], final.diffusion_squared_local,
                       rtol=1e-5 if latent_mode else 1e-6)
    assert got["local"][1] == got["local"][0] // 4


@pytest.mark.parametrize("latent_mode", [False, True], ids=["white", "latent"])
def test_space_sharded_adaptive_solve_matches_final_state(port, setups, latent_mode):
    heat = examples.heat_1d_discretized(dx=1.0 / 15, tmax=0.3)
    cls = latent.LinearLatentForceEK1 if latent_mode else white.LinearWhiteNoiseEK1
    final, info = cls(steprule=setups["rule"]).simulate_final_state(heat)
    for r in port:  # every rank took the same decisions
        got = r[f"adaptive_{latent_mode}"]
        assert got["n_steps"] == info["num_steps"]
        assert got["n_attempts"] == info["num_attempted_steps"]
        assert abs(got["t"] - float(final.t)) <= 1e-12
    got = port[0][f"adaptive_{latent_mode}"]
    assert np.allclose(got["mean"], final.y.mean, rtol=1e-3, atol=2e-5)
    assert np.allclose(_gram(got["cov"]), _gram(np.asarray(final.y.cov_sqrtm)), rtol=1e-3,
                       atol=1e-5)
    assert np.allclose(got["diff"], final.diffusion_squared_local, rtol=1e-4)


def test_dt_sweep_matches_sequential_final_states(port, setups, jax_mesh):
    heat, solver, state = setups["sweep"]
    means_j, covs_j, diff_j = jens.dt_sweep_final_states(
        cache=solver._cache, num_derivatives=2, f=None, df=None, linear=True,
        mean0=state.y.mean, cov0=state.y.cov_sqrtm, t0=heat.t0, tmax=heat.tmax,
        dts=SWEEP_DTS, mesh=jax_mesh)
    got = port[0]["sweep"]
    for i, dt in enumerate(SWEEP_DTS):
        final, _ = white.LinearWhiteNoiseEK1(steprule=step_module.Constant(dt),
                                             spatial_kernel=PRIOR).simulate_final_state(heat)
        for mean, diff, cov in ((final.y.mean, final.diffusion_squared_local, final.y.cov_sqrtm),
                                (means_j[i], diff_j[i], covs_j[i])):
            assert np.allclose(got["means"][i], mean, rtol=0, atol=1e-10), dt
            assert np.allclose(got["diffs"][i], diff, rtol=1e-9)
            assert np.allclose(_gram(got["covs"][i]), _gram(np.asarray(cov)), atol=1e-9)


def test_ensemble_step_matches_sequential(port, setups, jax_mesh):
    members = setups["ensemble"]
    cache_b = jens.stack_caches([s._cache for s, _ in members])
    step = jens.make_ensemble_step_fn(num_derivatives=2, f=None, df=None, linear=True,
                                      mesh=jax_mesh)
    with jax_mesh:
        out_j = step(cache_b, jnp.stack([st.y.mean for _, st in members]),
                     jnp.stack([st.y.cov_sqrtm for _, st in members]), jnp.asarray(0.05),
                     jnp.asarray(0.05))
    got = port[0]["ensemble"]
    for i, (solver, state) in enumerate(members):
        single = _step_expected(solver, state, 0.05)
        for mean, cov, diff in ((single[0], single[1], single[4]),
                                (out_j[0][i], out_j[1][i], out_j[4][i])):
            assert np.allclose(got["mean"][i], mean, rtol=0, atol=1e-10)
            assert np.allclose(_gram(got["cov"][i]), _gram(np.asarray(cov)), atol=1e-9)
            assert np.allclose(got["diff"][i], diff, rtol=0, atol=1e-10)



# ---------------------------------------------------------------------------
# the steady tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("latent_mode", [False, True], ids=["white", "latent"])
def test_space_sharded_steady_state_matches_single_device(port, setups, latent_mode):
    """The sharded Riccati convergence (unseeded, from the converged state)
    and the sharded mean-only solve against JAX's single-device steady mode:
    the Grams of cov_inf and Sl to JAX's 1e-7, the 5-step mean to 1e-7 and
    the diffusion to 1e-5 against the single-device frozen recursion; and
    JAX's frozen blocks, placed by ``shard_steady_cache``, drive the sharded
    solve to that recursion at 1e-10."""
    heat, solver, state0 = setups[f"steady15_{latent_mode}"]
    reference = solver.steady_cache
    got = port[0][f"steady_{latent_mode}"]
    assert np.allclose(_gram(got["cov_inf"]), _gram(np.asarray(reference.cov_inf)), atol=1e-7)
    assert np.allclose(_gram(got["Sl"]), _gram(np.asarray(reference.Sl)), atol=1e-7)
    D = got["cov_inf"].shape[0]
    assert all(r[f"steady_{latent_mode}"]["local_cov"] == (D, D // 4) for r in port)
    assert all(r[f"steady_{latent_mode}"]["local_L21"][0] == D // 4 for r in port)
    assert all(r[f"steady_{latent_mode}"]["placed_cov"] == (D // 4, D) for r in port)

    make = latent.make_steady_state_latent_step if latent_mode else \
        white.make_steady_state_white_step
    step_local = make(cache=solver._cache, steady=reference, num_derivatives=2)
    m_ref, diff_sum = state0.y.mean, 0.0
    for i in range(5):
        m_ref, _, _, _, dsq = step_local(m_ref, reference.cov_inf, heat.t0 + (i + 1) * 0.05,
                                         jnp.asarray(0.05))
        diff_sum += float(dsq)
    assert np.allclose(got["mean"], m_ref, atol=1e-7)
    assert np.allclose(got["diff"], diff_sum / 5, rtol=1e-5)
    # JAX's own frozen blocks placed by shard_steady_cache: the same recursion
    assert np.allclose(got["mean_single"], m_ref, rtol=0, atol=1e-10)
    assert all(r[f"steady_{latent_mode}"]["single_L21"] == (D // 4, got["L21"].shape[1])
               for r in port)


def test_sharded_steady_convergence_chunked_and_promoted(port, setups):
    """Chunked convergence lands where one run does, and dtype="float64"
    runs the recursion in f64 on an f32 problem and returns f32 blocks (JAX's
    tolerances; the distributed panels' delta floor needs tol 1e-4). Each
    run also sits in that tol-neighborhood of JAX's single-device fixed
    point."""
    runs = port[0]["steady_chunked"]
    tol = 1e-4
    one, chunked, promoted = runs["one"], runs["chunked"], runs["promoted"]
    assert chunked["delta"] < tol and chunked["iterations"] < 200
    assert np.allclose(_gram(chunked["cov_inf"]), _gram(one["cov_inf"]), rtol=1e-3, atol=2e-5)
    assert promoted["dtype"] == "torch.float32"
    assert promoted["Sl_inv"].dtype == np.float32
    assert promoted["delta"] < tol
    assert np.allclose(_gram(promoted["cov_inf"]), _gram(one["cov_inf"]).astype(np.float32),
                       rtol=5e-3, atol=2e-5)
    reference = setups["steady15_False"][1].steady_cache
    assert np.allclose(_gram(one["cov_inf"]), _gram(np.asarray(reference.cov_inf)), rtol=1e-3,
                       atol=2e-5)


def test_sda_sharded_matches_dense_doubling(port):
    """The distributed doubling reproduces JAX's dense SDA fixed point at
    JAX's rtol 1e-9 / atol 1e-11, certified by the DARE residual."""
    from pnmol_tpu.ops import dare as jdare

    inputs = _sda_inputs()
    dense = jdare.sda(*(jnp.asarray(inputs[k]) for k in ("A", "G", "Q")), tol=1e-13)
    got = port[0]["sda"]
    np.testing.assert_allclose(got["sigma"], np.asarray(dense.sigma), rtol=1e-9, atol=1e-11)
    assert got["residual"] < 1e-10
    assert got["iterations"] <= int(dense.iterations) + 2
    assert all(r["sda"]["local"] == (6, 24) for r in port)


def test_sda_sharded_doubling_collectives_equal_comm_model(port):
    """One doubling's schedule collectives on 4 ranks are two blocked
    Cholesky factorizations and two blocked cho_solves of D columns."""
    from pnmol_tpu_torch.utils import comm_model

    parts = [comm_model.blocked_cholesky_cost(24, 4, panel=4)] * 2 + \
        [comm_model.blocked_cho_solve_cost(24, 24, 4, panel=4)] * 2
    model = {}
    for part in parts:
        for coll in part.collectives:
            model[coll.kind] = model.get(coll.kind, 0) + coll.total_payload
    assert all(r["sda"]["schedule"] == model for r in port)


def test_sharded_steady_seed_polishes_in_few_iterations(port, setups):
    """The seeded sharded convergence polishes in a few iterations and
    matches JAX's single-device steady cache at JAX's tolerances."""
    _, solver, _ = setups["seeded23"]
    ref = solver.steady_cache
    got = port[0]["steady_seeded"]
    assert got["iterations"] <= 10
    assert got["dare_residual"] < 1e-5
    np.testing.assert_allclose(got["L21"] @ got["Sl_inv"], np.asarray(ref.L21 @ ref.Sl_inv),
                               rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(_gram(got["cov_inf"]), _gram(np.asarray(ref.cov_inf)), rtol=5e-3,
                               atol=1e-4)
    assert all(r["steady_seeded"]["iterations"] == got["iterations"] for r in port)


def test_steady_dt_sweep_matches_sequential(port, setups):
    """The frozen-gain dt sweep over the batch axis reproduces JAX's
    sequential steady simulate_final_state of each dt."""
    got = port[0]["steady_sweep"]
    for i, (solver, final) in enumerate(setups["steady_sweep"]):
        dt = SWEEP_DTS[i]
        assert np.allclose(got["means"][i], final.y.mean, atol=1e-10), f"dt={dt}"
        assert np.allclose(got["diffs"][i], final.diffusion_squared_local, rtol=1e-9)
        expected = np.asarray(solver.steady_cache.cov_inf) * np.sqrt(got["diffs"][i])
        assert np.allclose(_gram(got["covs"][i]), _gram(expected), atol=1e-9)
