"""Rank bodies of the port's sharded-tier tests (imports no JAX).

``tests/test_torch_parallel.py`` and ``tests/test_torch_comm_model.py``
spawn gloo ranks on the CPU with
:func:`pnmol_tpu_torch.parallel.distributed.spawn_ranks`; each rank imports
this module to unpickle its target, so it must stay free of JAX. Inputs
come from a numpy seed or, for solver states and caches, as numpy arrays in
the payload (computed by the JAX package in the test process). Every rank
returns a dict of numpy results: sharded outputs gathered to full tensors,
and its local block shapes.
"""

import functools

import numpy as np
import torch

import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.ops import dare
from pnmol_tpu_torch.parallel import (
    distributed,
    ensembles,
    meshes,
    sharded_dare,
    sharded_filter,
    sharded_init,
    sharded_linalg,
)
from pnmol_tpu_torch.utils import comm_model


def _np(x):
    return x.detach().cpu().numpy()


def _cov_shard(arrays, mesh, spec=(None, "space")):
    """The rank's block of a JAX state's covariance factor, column-sharded
    unless ``spec`` says otherwise."""
    return interop.local_shard(arrays["cov"], mesh, spec, device="cpu")


class _Ctx:
    """The rank's mesh and the gather helpers of the rank bodies."""

    def __init__(self, mesh):
        self.mesh = mesh

    def sizes(self, n):
        return meshes.block_sizes(n, self.mesh.shape["space"])

    def rows(self, x, n):
        return _np(self.mesh.gather_rows(x, self.sizes(n), "space"))

    def cols(self, x, n):
        return _np(self.mesh.gather_rows(x.T, self.sizes(n), "space").T)


def _problem(arrays, device="cpu"):
    return interop.discretized_problem(
        L=arrays["L"], E_sqrtm=arrays["E_sqrtm"], B=arrays["B"], R_sqrtm=arrays["R_sqrtm"],
        y0=arrays["y0"], points=arrays["points"], t0=float(arrays["t0"]),
        tmax=float(arrays["tmax"]), device=device,
    )


def _white(arrays, device="cpu"):
    return interop.white_cache(**{k: arrays[k] for k in ("A1d", "Ql", "L", "B", "E_bc_sqrtm")},
                               device=device)


def _latent(arrays, device="cpu"):
    return interop.latent_cache(**{k: arrays[k] for k in ("A1d", "Ql", "L", "B")},
                                device=device)


def _state(arrays):
    return torch.tensor(arrays["mean"]), torch.tensor(arrays["cov"])


# ---------------------------------------------------------------------------
# the cases of tests/test_torch_parallel.py
# ---------------------------------------------------------------------------


def _mesh_cases(out):
    m = meshes.make_mesh(4)
    out["mesh_default"] = dict(m.shape)
    out["mesh_batch4"] = dict(meshes.make_mesh(4, batch=4).shape)
    try:
        meshes.make_mesh(4, batch=3)
        out["mesh_batch3"] = "no error"
    except ValueError:
        out["mesh_batch3"] = "ValueError"


def _linalg_cases(c, out, grid_points):
    mesh = c.mesh
    points = torch.tensor(grid_points)
    kernel = pt.kernels.SquareExponential(input_scale=2.0)
    out["gram"] = c.rows(sharded_linalg.sharded_gram(kernel, points, mesh), 32)

    rng = np.random.default_rng(0)
    mat = torch.tensor(rng.normal(size=(256, 32)))
    out["tsqr"] = _np(sharded_linalg.tsqr_r(mesh.shard(mat, meshes.space_sharding(rank=2)), mesh))
    try:
        sharded_linalg.tsqr_r(mesh.shard(torch.ones((16, 32), dtype=torch.float64),
                                         meshes.space_sharding(rank=2)), mesh)
        out["tsqr_short"] = "no error"
    except ValueError:
        out["tsqr_short"] = "ValueError"

    rng = np.random.default_rng(3)
    R = torch.tensor(np.triu(rng.normal(size=(24, 24)) + 3 * np.eye(24)))
    B = torch.tensor(rng.normal(size=(24, 50)))
    X = sharded_linalg.sharded_triangular_solve(R, mesh.shard(B, meshes.column_sharding()), mesh)
    out["trisolve"] = c.cols(X, 50)

    rows = meshes.space_sharding(rank=2)
    mat = torch.tensor(np.random.default_rng(1).normal(size=(200, 96)))
    out["blocked_qr"] = _np(sharded_linalg.blocked_qr_r(mesh.shard(mat, rows), mesh,
                                                         panel_size=32))
    mat = torch.tensor(np.random.default_rng(2).normal(size=(160, 50)))
    out["blocked_qr_uneven"] = _np(sharded_linalg.blocked_qr_r(mesh.shard(mat, rows), mesh,
                                                                panel_size=16))

    rng = np.random.default_rng(7)
    out["blocked_qr_sharded"] = []
    for nr, nc, ps in ((200, 96, 32), (160, 50, 16), (64, 200, 16)):
        mat = torch.tensor(rng.normal(size=(nr, nc)))
        R_loc = sharded_linalg.blocked_qr_r_sharded(mesh.shard(mat, rows), mesh, panel_size=ps)
        _, _, owned = sharded_linalg.qr_row_blocks(nc, mesh, panel_size=ps)
        full = mesh.gather_rows(R_loc, [b - a for a, b in owned])
        out["blocked_qr_sharded"].append((_np(mat), _np(full), tuple(R_loc.shape)))

    rng = np.random.default_rng(7)
    out["cholesky"] = []
    for d, panel in ((40, 8), (64, 16), (96, 8)):
        A = rng.normal(size=(d, d))
        G = torch.tensor(A @ A.T + d * np.eye(d))
        L = sharded_linalg.blocked_cholesky(mesh.shard(G, rows), mesh, panel_size=panel)
        out["cholesky"].append((_np(G), c.rows(L, d), tuple(L.shape)))

    rng = np.random.default_rng(8)
    d, K = 48, 20
    A = rng.normal(size=(d, d))
    G = torch.tensor(A @ A.T + d * np.eye(d))
    L = torch.linalg.cholesky(G)
    B = torch.tensor(rng.normal(size=(d, K)))
    Ls, Bs = mesh.shard(L, rows), mesh.shard(B, rows)
    out["tri_solve"] = dict(
        L=_np(L), B=_np(B),
        fwd=c.rows(sharded_linalg.blocked_tri_solve_lower(Ls, Bs, mesh, panel_size=8), d),
        bwd=c.rows(sharded_linalg.blocked_tri_solve_lower(Ls, Bs, mesh, panel_size=8,
                                                          transpose=True), d),
        cho=c.rows(sharded_linalg.blocked_cho_solve(Ls, Bs, mesh, panel_size=8), d),
    )

    rng = np.random.default_rng(3)
    out["ring"] = []
    for ra, k, cx in ((64, 48, 80), (50, 33, 71), (8, 8, 8), (3, 17, 5)):
        A = torch.tensor(rng.normal(size=(ra, k)))
        X = torch.tensor(rng.normal(size=(k, cx)))
        got = sharded_linalg.ring_matmul(mesh.shard(A, rows),
                                         mesh.shard(X, meshes.column_sharding()), mesh, rows=ra)
        out["ring"].append((_np(A), _np(X), c.cols(got, cx)))

    rng = np.random.default_rng(4)
    out["whiten"] = []
    for m, k in ((48, 96), (50, 65)):
        X = torch.tensor(rng.normal(size=(m, k)))
        S = sharded_linalg.gram_rowsharded(mesh.shard(X, meshes.column_sharding()), mesh)
        m_pad = S.shape[1]
        Lc = sharded_linalg.blocked_cholesky(S, mesh)
        z = torch.tensor(rng.normal(size=(m_pad, 1)))
        w = sharded_linalg.blocked_cho_solve(Lc, mesh.shard(z, rows), mesh)
        out["whiten"].append((_np(X), c.rows(S, m_pad), _np(z), c.rows(w, m_pad)))


def _collocation(c, out, points, key):
    mesh_spatial = pt.mesh.RectangularMesh(points, device="cpu")
    D, E = sharded_linalg.sharded_collocation_global(
        pt.diffops.laplace(), mesh_spatial, c.mesh,
        kernel=pt.kernels.SquareExponential(input_scale=2.0), nugget_gram_matrix=1e-8,
        nugget_cholesky_E=1e-10, symmetrize_cholesky_E=True,
    )
    N = points.shape[0]
    out[key] = dict(D=c.rows(D, N), E=c.rows(E, N), local=tuple(E.shape))


def _step_cases(c, out, p):
    mesh = c.mesh
    cols = sharded_filter.cov_layout(True)
    for key, arrays, dt, ps, kw in (
        ("step_dqr", p["heat15"], 0.05, 16, {}),
        ("step_dqr_2d", p["heat2d"], 0.01, 32, {}),
        ("step_two_qr", p["heat15"], 0.05, 16, dict(two_qr=True)),
    ):
        mean, cov = _state(arrays)
        cache = sharded_filter.shard_cache(_white(arrays), mesh, distributed_qr=True,
                                           shard_operands="two_qr" in kw)
        step = sharded_filter.make_space_sharded_white_step(
            cache=cache, num_derivatives=2, mesh=mesh, distributed_qr=True, panel_size=ps, **kw)
        mesh.reset_counts()
        got = step(mean, _cov_shard(arrays, mesh), dt, dt)
        D = cov.shape[0]
        out[key] = dict(mean=_np(got[0]), cov=c.cols(got[1], D), err=_np(got[2]),
                        diff=float(got[4]), local=tuple(got[1].shape),
                        schedule=mesh.totals("schedule"))

    arrays = p["heat15"]
    mean, cov = _state(arrays)
    cache = sharded_filter.shard_cache(_white(arrays), mesh)
    step = sharded_filter.make_space_sharded_white_step(cache=cache, num_derivatives=2,
                                                        mesh=mesh)
    got = step(mean, _cov_shard(arrays, mesh, ("space", None)), 0.05, 0.05)
    out["step_rows"] = dict(mean=_np(got[0]), cov=c.rows(got[1], cov.shape[0]),
                            local=tuple(got[1].shape))

    arrays = p["latent15"]
    mean, cov = _state(arrays)
    cache = sharded_filter.shard_cache(_latent(arrays), mesh, distributed_qr=True)
    step = sharded_filter.make_space_sharded_latent_step(cache=cache, num_derivatives=2,
                                                         mesh=mesh, panel_size=16)
    got = step(mean, _cov_shard(arrays, mesh), 0.05, 0.05)
    out["step_latent"] = dict(mean=_np(got[0]), cov=c.cols(got[1], cov.shape[0]),
                              diff=float(got[4]), local=tuple(got[1].shape))

    # semilinear: the port's spruce budworm nonlinearity on JAX's arrays
    arrays = p["spruce"]
    spruce = pt.pde.examples.spruce_budworm_1d_discretized(bbox=[0.0, 1.0], dx=1.0 / 15,
                                                           tmax=1.0, device="cpu")
    mean, cov = _state(arrays)
    cache = sharded_filter.shard_cache(_white(arrays), mesh, distributed_qr=True)
    step = sharded_filter.make_space_sharded_white_step(
        cache=cache, num_derivatives=2, mesh=mesh, f=spruce.f, df=spruce.df, linear=False,
        distributed_qr=True, panel_size=16)
    got = step(mean, _cov_shard(arrays, mesh), 0.01, 0.01)
    out["step_semilinear"] = dict(mean=_np(got[0]), cov=c.cols(got[1], cov.shape[0]),
                                  diff=float(got[4]), local=tuple(got[1].shape))


def _solve_cases(c, out, p):
    mesh = c.mesh
    cols = sharded_filter.cov_layout(True)
    for latent in (False, True):
        arrays = p["latent15" if latent else "heat15"]
        mean, cov = _state(arrays)
        cache = sharded_filter.shard_cache((_latent if latent else _white)(arrays), mesh,
                                           distributed_qr=True)
        solve = sharded_filter.make_space_sharded_constant_solve(
            cache=cache, num_derivatives=2, mesh=mesh, dt=0.05, num_steps=5, latent=latent,
            panel_size=16)
        m, C, diff = solve(mean, _cov_shard(arrays, mesh), 0.0)
        out[f"constant_{latent}"] = dict(mean=_np(m), cov=c.cols(C, cov.shape[0]),
                                         diff=float(diff), local=tuple(C.shape))

        rule = pt.odetools.step.Adaptive(abstol=1e-4, reltol=1e-2)
        solve = sharded_filter.make_space_sharded_adaptive_solve(
            cache=cache, num_derivatives=2, mesh=mesh, steprule=rule, t0=0.0, tmax=0.3,
            latent=latent, panel_size=16)
        cov0 = _cov_shard(arrays, mesh)
        t, m, C, diff, n_steps, n_attempts = solve(mean, cov0, float(p["adaptive_dt0"]))
        out[f"adaptive_{latent}"] = dict(t=t, mean=_np(m), cov=c.cols(C, cov.shape[0]),
                                         diff=float(diff), n_steps=n_steps,
                                         n_attempts=n_attempts, local=tuple(C.shape))


def _init_cases(c, out, p):
    mesh = c.mesh
    pde = _problem(p["problem15"])
    kernel = pt.kernels.Matern52() + pt.kernels.WhiteNoise()
    for latent in (False, True):
        init = sharded_init.sharded_latent_initialize if latent else \
            sharded_init.sharded_white_initialize
        mesh.reset_counts()
        mean0, C0, chol_gram = init(pde, mesh, num_derivatives=2, spatial_kernel=kernel,
                                    panel_size=8)
        schedule = mesh.totals("schedule")
        build = sharded_init.sharded_latent_cache if latent else sharded_init.sharded_white_cache
        cache = build(pde, chol_gram, mesh, num_derivatives=2)
        make = sharded_filter.make_space_sharded_latent_step if latent else \
            sharded_filter.make_space_sharded_white_step
        step = make(cache=cache, num_derivatives=2, mesh=mesh, distributed_qr=True,
                    panel_size=16)
        got = step(mean0, C0, 0.05, 0.05)
        D = C0.shape[0]
        out[f"init_{latent}"] = dict(
            mean=_np(mean0), cov=c.cols(C0, D), chol_gram=c.rows(chol_gram, pde.L.shape[0]),
            local_cov=tuple(C0.shape), local_chol=tuple(chol_gram.shape), schedule=schedule,
            step_mean=_np(got[0]), step_cov=c.cols(got[1], D),
        )


def _ensemble_cases(out, p):
    mesh = meshes.make_mesh(4, batch=2)
    sweep = p["sweep"]
    mean, cov = _state(sweep)
    means, covs, diffs = ensembles.dt_sweep_final_states(
        cache=_white(sweep), num_derivatives=2, f=None, df=None, linear=True, mean0=mean,
        cov0=cov, t0=0.0, tmax=1.0, dts=list(p["sweep_dts"]), mesh=mesh)
    out["sweep"] = dict(means=_np(means), covs=_np(covs), diffs=_np(diffs))

    members = p["ensemble"]
    caches = [_white(a) for a in members]
    step = ensembles.make_ensemble_step_fn(num_derivatives=2, f=None, df=None, linear=True,
                                           mesh=mesh)
    got = step(ensembles.stack_caches(caches), torch.stack([_state(a)[0] for a in members]),
               torch.stack([_state(a)[1] for a in members]), 0.05, 0.05)
    out["ensemble"] = dict(mean=_np(got[0]), cov=_np(got[1]), diff=_np(got[4]))


def _steady(arrays):
    return interop.steady_cache(**{k: arrays[k] for k in (
        "cov_inf", "L21", "Sl", "Sl_inv", "err_vec", "iterations", "delta")}, device="cpu")


def _steady_out(c, steady):
    """A sharded steady cache's blocks, gathered, its scalars and its local
    block shapes."""
    full = {name: _np(sharded_filter._full(steady, name, c.mesh, "space"))
            for name in ("cov_inf", "L21", "Sl", "Sl_inv")}
    local = steady.local
    return dict(full, err_vec=_np(local.err_vec), iterations=local.iterations, delta=local.delta,
                local_cov=tuple(local.cov_inf.shape), local_L21=tuple(local.L21.shape),
                dtype=str(local.cov_inf.dtype))


def _steady_cases(c, out, p):
    """The counterparts of the JAX steady tier's five tests."""
    mesh = c.mesh
    # the sharded recursion (unseeded) from the converged state, then the
    # sharded mean-only solve of 5 steps
    for latent in (False, True):
        arrays = p["steady15_latent" if latent else "steady15_white"]
        mean, _ = _state(arrays)
        cache = sharded_filter.shard_cache((_latent if latent else _white)(arrays), mesh,
                                           distributed_qr=True)
        steady = sharded_filter.converge_space_sharded_steady_state(
            cache=cache, cov0=_cov_shard(arrays, mesh), dt=0.05, num_derivatives=2, mesh=mesh,
            latent=latent, panel_size=16, seed=False)
        placed = sharded_filter.shard_steady_cache(steady, mesh)
        solve = sharded_filter.make_space_sharded_steady_solve(
            cache=cache, steady=placed, num_derivatives=2, mesh=mesh, dt=0.05, num_steps=5,
            latent=latent)
        m, diff = solve(mean, 0.0)
        # JAX's single-device frozen blocks, placed by the same plan
        single = sharded_filter.shard_steady_cache(_steady(arrays["steady"]), mesh)
        m_single, _ = sharded_filter.make_space_sharded_steady_solve(
            cache=cache, steady=single, num_derivatives=2, mesh=mesh, dt=0.05, num_steps=5,
            latent=latent)(mean, 0.0)
        out[f"steady_{latent}"] = dict(_steady_out(c, steady), mean=_np(m), diff=float(diff),
                                       placed_cov=tuple(placed.local.cov_inf.shape),
                                       mean_single=_np(m_single),
                                       single_L21=tuple(single.local.L21.shape))

    # chunked and f64-promoted convergence from the transient state
    arrays = p["heat15"]
    cache = sharded_filter.shard_cache(_white(arrays), mesh, distributed_qr=True)
    runs = {}
    for key, kw in (("one", {}), ("chunked", dict(chunk_iters=3))):
        runs[key] = _steady_out(c, sharded_filter.converge_space_sharded_steady_state(
            cache=cache, cov0=_cov_shard(arrays, mesh), dt=0.05, num_derivatives=2, mesh=mesh,
            panel_size=16, tol=1e-4, **kw))
    cache32 = cache._replace(local=type(cache.local)(*(x.float() for x in cache.local)))
    runs["promoted"] = _steady_out(c, sharded_filter.converge_space_sharded_steady_state(
        cache=cache32, cov0=_cov_shard(arrays, mesh).float(), dt=0.05, num_derivatives=2,
        mesh=mesh, panel_size=16, dtype="float64", tol=1e-4, chunk_iters=5))
    out["steady_chunked"] = runs

    # the doubling against the dense one, and its counted collectives
    A, G, Q = (torch.tensor(p["sda"][k]) for k in ("A", "G", "Q"))
    rows = meshes.space_sharding(rank=2)
    res = sharded_dare.sda_sharded(mesh.shard(A, rows), mesh.shard(G, rows), mesh.shard(Q, rows),
                                   mesh, tol=1e-13, panel_size=4)
    sigma = c.rows(res.sigma, A.shape[0])
    mesh.reset_counts()
    sharded_dare.sda_sharded(mesh.shard(A, rows), mesh.shard(G, rows), mesh.shard(Q, rows), mesh,
                             max_iters=1, panel_size=4)
    out["sda"] = dict(sigma=sigma, iterations=res.iterations, local=tuple(res.sigma.shape),
                      residual=float(dare.dare_residual(torch.tensor(sigma), A, G, Q)),
                      schedule=mesh.totals("schedule"), calls=mesh.calls("schedule"))

    # the seeded convergence polishes in a few iterations
    arrays = p["seeded23"]
    cache = sharded_filter.shard_cache(_white(arrays), mesh, distributed_qr=True)
    diagnostics = {}
    steady = sharded_filter.converge_space_sharded_steady_state(
        cache=cache, cov0=_cov_shard(arrays, mesh), dt=0.01, num_derivatives=2, mesh=mesh,
        panel_size=8, diagnostics=diagnostics)
    out["steady_seeded"] = dict(_steady_out(c, steady), **diagnostics)

    # the frozen-gain dt sweep over the batch axis
    sweep = p["steady_sweep"]
    mean, _ = _state(sweep)
    means, covs, diffs = ensembles.steady_dt_sweep_final_states(
        cache=_white(sweep), num_derivatives=2, mean0=mean, t0=0.0, tmax=1.0,
        dts=list(p["sweep_dts"]), mesh=meshes.make_mesh(4, batch=2),
        steady_caches=ensembles.stack_caches([_steady(s) for s in p["sweep_steadies"]]))
    out["steady_sweep"] = dict(means=_np(means), covs=_np(covs), diffs=_np(diffs))


def parallel_cases(payload, device):
    """Every port-side case of ``tests/test_torch_parallel.py`` on this rank."""
    torch.set_num_threads(1)
    out = {"rank": distributed.global_mesh(batch=1).rank}
    _mesh_cases(out)
    c = _Ctx(meshes.make_mesh(4, batch=1))
    _linalg_cases(c, out, payload["grid32"])
    _collocation(c, out, payload["grid32"], "collocation")
    _collocation(c, out, payload["grid96"], "collocation96")
    _step_cases(c, out, payload)
    _solve_cases(c, out, payload)
    _init_cases(c, out, payload)
    _ensemble_cases(out, payload)
    _steady_cases(c, out, payload)
    return out


# ---------------------------------------------------------------------------
# the cases of tests/test_torch_comm_model.py: counted collectives
# ---------------------------------------------------------------------------


def _counted(mesh, fn):
    mesh.reset_counts()
    fn()
    return mesh.totals("schedule")


def comm_cases(payload, device):
    """Counted schedule collectives of each primitive and of the two-QR
    step on a 4-rank space mesh, beside the model's counts."""
    torch.set_num_threads(1)
    mesh = meshes.make_mesh(4, batch=1)
    P = 4
    rows, cols = meshes.space_sharding(rank=2), meshes.column_sharding()
    ones = functools.partial(torch.ones, dtype=torch.float64)
    out = {}

    def model(parts):
        parts = parts if isinstance(parts, list) else [parts]
        totals = {}
        for part in parts:
            for coll in part.collectives:
                totals[coll.kind] = totals.get(coll.kind, 0) + coll.total_payload
        return totals

    out["ring_matmul"] = (
        _counted(mesh, lambda: sharded_linalg.ring_matmul(
            mesh.shard(ones((32, 16)), rows), mesh.shard(ones((16, 24)), cols), mesh, rows=32)),
        model(comm_model.ring_matmul_cost(32, 16, 24, P)))
    out["gram_rowsharded"] = (
        _counted(mesh, lambda: sharded_linalg.gram_rowsharded(mesh.shard(ones((24, 40)), cols),
                                                              mesh)),
        model(comm_model.gram_rowsharded_cost(24, 40, P)))
    out["blocked_qr_r_sharded"] = (
        _counted(mesh, lambda: sharded_linalg.blocked_qr_r_sharded(
            mesh.shard(ones((64, 32)), rows), mesh, panel_size=2)),
        model(comm_model.blocked_qr_r_sharded_cost(64, 32, P, panel=2, loop="unrolled")))
    out["blocked_qr_r_sharded_ragged"] = (
        _counted(mesh, lambda: sharded_linalg.blocked_qr_r_sharded(
            mesh.shard(ones((50, 30)), rows), mesh, panel_size=4)),
        model(comm_model.blocked_qr_r_sharded_cost(50, 30, P, panel=4, loop="unrolled")))
    out["blocked_qr_r"] = (
        _counted(mesh, lambda: sharded_linalg.blocked_qr_r(mesh.shard(ones((64, 24)), rows),
                                                           mesh, panel_size=4)),
        model(comm_model.blocked_qr_r_cost(64, 24, P, panel=4)))
    eye = 2.0 * torch.eye(32, dtype=torch.float64)
    out["blocked_cholesky"] = (
        _counted(mesh, lambda: sharded_linalg.blocked_cholesky(mesh.shard(eye, rows), mesh,
                                                               panel_size=2)),
        model(comm_model.blocked_cholesky_cost(32, P, panel=2)))
    out["blocked_tri_solve"] = (
        _counted(mesh, lambda: sharded_linalg.blocked_tri_solve_lower(
            mesh.shard(eye, rows), mesh.shard(ones((32, 3)), rows), mesh, panel_size=2)),
        model(comm_model.blocked_tri_solve_cost(32, 3, P, panel=2)))
    out["blocked_cho_solve"] = (
        _counted(mesh, lambda: sharded_linalg.blocked_cho_solve(
            mesh.shard(eye, rows), mesh.shard(ones((32, 3)), rows), mesh, panel_size=2)),
        model(comm_model.blocked_cho_solve_cost(32, 3, P, panel=2)))

    # the two-QR memory-bounded step on JAX's arrays, and the distributed init
    arrays = payload["two_qr"]
    d, nu, panel = int(arrays["d"]), int(arrays["nu"]), 8
    cache = sharded_filter.shard_cache(_white(arrays), mesh, distributed_qr=True,
                                       shard_operands=True)
    step = sharded_filter.make_space_sharded_white_step(
        cache=cache, num_derivatives=nu, mesh=mesh, distributed_qr=True, two_qr=True,
        panel_size=panel)
    mean, cov = _state(arrays)
    n_bc = cache.shapes["B"][0]
    mesh.reset_counts()
    step(mean, _cov_shard(arrays, mesh), 1e-3, 1e-3)
    out["two_qr_step"] = (mesh.totals("schedule"), model(comm_model.two_qr_step_cost(
        d, nu, n_bc, P, panel=panel)), mesh.totals("layout"))
    pde = _problem(payload["two_qr_problem"])
    mesh.reset_counts()
    sharded_init.sharded_white_initialize(pde, mesh, num_derivatives=nu, panel_size=panel)
    out["init"] = (mesh.totals("schedule"), model(comm_model.distributed_init_cost(
        d, nu, n_bc, P, panel=panel, sharded_r=False)))
    return out


# ---------------------------------------------------------------------------
# tests/torch_steady_gain_spread.py: the port's side
# ---------------------------------------------------------------------------


def steady_spread_rank(payload, device):
    """The seeded sharded steady state (4 polish iterations) of the N-point
    heat of ``payload``, on this rank's blocks; returns the blocks gathered."""
    torch.set_num_threads(2)
    mesh = distributed.global_mesh(batch=1)
    n_points, nu, dt = payload["N"], payload["nu"], payload["dt"]
    dx = 1.0 / (n_points - 1)
    heat = pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=1.0, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx), device="cpu")
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(dt), num_derivatives=nu,
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise())
    state = solver.initialize(heat)
    cache = sharded_filter.shard_cache(solver._cache, mesh, distributed_qr=True)
    steady = sharded_filter.converge_space_sharded_steady_state(
        cache=cache, cov0=mesh.shard(state.y.cov_sqrtm, sharded_filter.cov_layout(True)), dt=dt,
        num_derivatives=nu, mesh=mesh, max_iters=4)
    out = {name: _np(sharded_filter._full(steady, name, mesh, "space"))
           for name in ("cov_inf", "L21", "Sl", "Sl_inv")}
    out["err_vec"] = _np(steady.local.err_vec)
    return out
