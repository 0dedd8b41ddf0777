"""Space-sharded single-instance filter steps and solves (the large-N tier).

Counterpart of :mod:`pnmol_tpu.parallel.sharded_filter` as explicit SPMD:
each rank holds its block of the covariance factor and of the cache, the
mean is replicated, and the collectives are named.

* ``distributed_qr=False``: the factor (and ``Ql``) is ROW-sharded and
  gathered for one local fused step, the collective GSPMD inserts for that
  layout; each rank keeps its rows of the result.
* ``distributed_qr=True``: the factor and ``Ql`` are COLUMN-sharded, so the
  sqrt-Kalman pre-array (built from the factor transposes) is row-sharded
  with no reshard, and the factorization is the distributed blocked panel
  QR of :func:`pnmol_tpu_torch.parallel.sharded_linalg.blocked_qr_r`, whose
  (m+D, m+D) R factor is replicated. ``two_qr=True`` splits predict and
  update into two sharded-output panel QRs
  (:func:`~pnmol_tpu_torch.parallel.sharded_linalg.blocked_qr_r_sharded`)
  and adds the measurement hooks that keep the step O(D^2 / P) per rank:
  the ring matmul for the operator products and the row-sharded innovation
  whitening.

The steady tier converges the Riccati recursion on column blocks through
the distributed factorization (seeded by the row-sharded doubling of
:mod:`pnmol_tpu_torch.parallel.sharded_dare`), places the frozen blocks in
row blocks and steps the mean only.

The steps are built from the single-device step's pieces
(:mod:`pnmol_tpu_torch.solvers.white`); the single-device
``white_attempt_step`` and ``latent_attempt_step`` are unchanged (the
steady convergence takes one more argument, ``row_sums``). Hooks take
local blocks: the operators enter ``operator_matmul`` as the rank's row block,
the measurement-noise factor enters every hook as the rank's column block.
"""

import math
from typing import NamedTuple

import torch

from pnmol_tpu_torch.ops import iwp
from pnmol_tpu_torch.parallel import meshes, sharded_linalg
from pnmol_tpu_torch.solvers import latent as latent_module
from pnmol_tpu_torch.solvers import pdefilter
from pnmol_tpu_torch.solvers import white as white_module


class ShardedCache(NamedTuple):
    """A step cache placed on a mesh: each field's local block, its layout
    and its global shape (the port's tensors do not carry their sharding)."""

    local: NamedTuple  # WhiteSolverCache or LatentSolverCache of local blocks
    layouts: dict  # field -> meshes.Layout
    shapes: dict  # field -> global shape


def cov_layout(distributed_qr):
    """The covariance factor's layout for a ``distributed_qr`` setting."""
    return meshes.column_sharding() if distributed_qr else meshes.space_sharding(rank=2)


def shard_cache(cache, mesh, distributed_qr=False, shard_operands=False):
    """Place the step cache on the mesh: ``Ql`` sharded as the step's
    covariance factor, the small operands replicated.

    ``shard_operands=True`` also ROW-shards ``L`` and ``B`` (the ring
    matmul's operands) and COLUMN-shards ``E_bc_sqrtm`` (the layout its
    consumers read: the update pre-array's noise rows and the innovation
    factor's columns), at any size: the blocks may be uneven or empty.
    """
    layouts = {}
    for name, value in cache._asdict().items():
        if name == "Ql":
            layouts[name] = cov_layout(distributed_qr)
        elif shard_operands and name in ("L", "B"):
            layouts[name] = meshes.space_sharding(rank=2)
        elif shard_operands and name == "E_bc_sqrtm":
            layouts[name] = meshes.column_sharding()
        else:
            layouts[name] = meshes.replicated()
    local = type(cache)(**{k: mesh.shard(v, layouts[k]) for k, v in cache._asdict().items()})
    shapes = {k: tuple(v.shape) for k, v in cache._asdict().items()}
    return ShardedCache(local=local, layouts=layouts, shapes=shapes)


def _sizes(n, mesh, axis):
    return meshes.block_sizes(n, mesh.shape[axis])


def _full(sc, name, mesh, axis):
    """A cache field gathered to its full tensor (a layout collective when
    it is sharded)."""
    value = getattr(sc.local, name)
    spec = sc.layouts[name].spec
    rows, cols = sc.shapes[name]
    if spec[:1] == ("space",):
        return mesh.gather_rows(value, _sizes(rows, mesh, axis), axis)
    if spec[1:2] == ("space",):
        return mesh.gather_rows(value.T, _sizes(cols, mesh, axis), axis).T
    return value


def _rows(sc, name, mesh, axis):
    """The rank's row block of a cache field (its block, or a slice)."""
    value = getattr(sc.local, name)
    if sc.layouts[name].spec[:1] == ("space",):
        return value
    start, stop = mesh.bounds(value.shape[0], axis)
    return value[start:stop]


def _columns(sc, name, mesh, axis):
    """The rank's column block of a square cache field."""
    value = getattr(sc.local, name)
    if sc.layouts[name].spec[1:2] == ("space",):
        return value
    start, stop = mesh.bounds(value.shape[1], axis)
    return value[:, start:stop]


# ---------------------------------------------------------------------------
# The distributed factorization hooks
# ---------------------------------------------------------------------------


def _fused_pre_array(HACl, ACl, HQl, Ql, R_noise):
    """The rank's rows of the fused (2D + m, m + D) pre-array: its columns
    of the factors transposed, and its columns of the noise factor."""
    m, D = HACl.shape[0], ACl.shape[0]
    top = torch.cat((HACl.T, ACl.T), dim=1)
    mid = torch.cat((HQl.T, Ql.T), dim=1)
    bottom = torch.cat((R_noise.T, R_noise.new_zeros((R_noise.shape[1], D))), dim=1)
    return torch.cat((top, mid, bottom), dim=0), m


def pre_array_blocked_qr(HACl, ACl, HQl, Ql, R_noise, *, mesh, axis="space", panel_size=None):
    """Distributed fused predict + update with the gain: the contract of
    :func:`pnmol_tpu_torch.ops.sqrt.fused_predict_update` on column blocks
    (one mesh rank: the whole matrices). Returns ``(posterior column block,
    gain (D, m), innovation factor)``."""
    pre, m = _fused_pre_array(HACl, ACl, HQl, Ql, R_noise)
    R = sharded_linalg.blocked_qr_r(pre, mesh, axis=axis, panel_size=panel_size)
    D = ACl.shape[0]
    start, stop = mesh.bounds(D, axis)
    # the gain solve rides the column-sharded triangular solve; the mean
    # update reads the whole gain (a layout gather)
    gain_cols = sharded_linalg.sharded_triangular_solve(R[:m, :m], R[:m, m + start:m + stop],
                                                        mesh, axis)
    gain = mesh.gather_rows(gain_cols.T, _sizes(D, mesh, axis), axis)
    return R[m + start:m + stop, m:].T, gain, R[:m, :m].T


def make_distributed_factorization(*, mesh, axis="space", panel_size=None,
                                   memory_bounded=False):
    """Distributed pre-array factorization hook with ``.blocks``,
    ``.propagate`` and ``.update_from_products`` (with ``.blocks``).

    ``.blocks`` returns ``(posterior column block, L21, L1)`` without the
    gain solve, L21 and L1 replicated. The two-QR pair runs the propagate
    LQ of the (2D, D) pre-array and the update LQ of the (m+D, m+D) one,
    each through the sharded-output panel QR: the propagated factor comes
    back in the QR's owner-aligned column blocks, the posterior in the
    covariance's blocks (a layout reshard of R's rows), L21 and L1 gathered.

    ``memory_bounded=True`` adds ``operator_matmul(Op, X, rows)`` (the ring
    matmul; ``Op`` the rank's row block of a ``rows``-row operator) and
    ``innovation_whiten(HQl, E_noise, z)`` (row-sharded innovation Gram,
    blocked Cholesky and cho_solve: ``(diag(S), S^{-1} z)``).
    """
    def blocks(HACl, ACl, HQl, Ql, R_noise):
        pre, m = _fused_pre_array(HACl, ACl, HQl, Ql, R_noise)
        R = sharded_linalg.blocked_qr_r(pre, mesh, axis=axis, panel_size=panel_size)
        start, stop = mesh.bounds(ACl.shape[0], axis)
        return R[m + start:m + stop, m:].T, R[:m, m:].T, R[:m, :m].T

    def factorization(HACl, ACl, HQl, Ql, R_noise):
        return pre_array_blocked_qr(HACl, ACl, HQl, Ql, R_noise, mesh=mesh, axis=axis,
                                    panel_size=panel_size)

    def propagate(ACl, Ql):
        stacked = torch.cat((ACl.T, Ql.T), dim=0)  # the rank's rows of (2D, D)
        R_loc = sharded_linalg.blocked_qr_r_sharded(stacked, mesh, axis=axis,
                                                    panel_size=panel_size)
        return R_loc.T  # (D, owned) lower-triangular columns

    def update_blocks(HClp, Clp, R_noise):
        m, D = HClp.shape[0], Clp.shape[0]
        top = torch.cat((R_noise.T, R_noise.new_zeros((R_noise.shape[1], D))), dim=1)
        bottom = torch.cat((HClp.T, Clp.T), dim=1)
        R_loc = sharded_linalg.blocked_qr_r_sharded(torch.cat((top, bottom)), mesh, axis=axis,
                                                    panel_size=panel_size)
        _, _, owned = sharded_linalg.qr_row_blocks(m + D, mesh, axis, panel_size)
        start, _ = owned[mesh.index[axis]]
        # rows [0, m) of R carry L21 and L1: gathered
        top_sizes = [max(0, min(b, m) - a) for a, b in owned]
        R_top = mesh.gather_rows(R_loc[:top_sizes[mesh.index[axis]]], top_sizes, axis)
        # rows [m, m + D) carry the posterior: to the covariance's blocks
        src = [(max(a, m) - m, max(b, m) - m) for a, b in owned]
        post = mesh.reshard_rows(R_loc[max(m - start, 0):, m:], src,
                                 meshes.all_block_bounds(D, mesh.shape[axis]), axis)
        return post.T, R_top[:, m:].T, R_top[:, :m].T

    def update_from_products(HClp, Clp, R_noise):
        Cl_new, L21, Sl = update_blocks(HClp, Clp, R_noise)
        K = torch.linalg.solve_triangular(Sl.T, L21.T, upper=True).T
        return Cl_new, K, Sl

    update_from_products.blocks = update_blocks
    factorization.blocks = blocks
    factorization.propagate = propagate
    factorization.update_from_products = update_from_products

    if memory_bounded:
        def operator_matmul(Op, X, rows):
            return sharded_linalg.ring_matmul(Op, X, mesh, axis=axis, rows=rows)

        def innovation_whiten(HQl, E_noise, z):
            m = z.shape[0]
            # diag(S) without S: shard-local row sums of squares, summed
            diag_S = mesh.psum((HQl * HQl).sum(1) + (E_noise * E_noise).sum(1), axis,
                               region="layout")
            S = sharded_linalg.gram_rowsharded(torch.cat((HQl, E_noise), dim=1), mesh, axis=axis)
            m_pad = S.shape[1]
            Lc = sharded_linalg.blocked_cholesky(S, mesh, axis=axis, panel_size=panel_size)
            zp = z.new_zeros(m_pad)
            zp[:m] = z
            start, stop = mesh.bounds(m_pad, axis)
            w = sharded_linalg.blocked_cho_solve(Lc, zp[start:stop, None], mesh, axis=axis,
                                                 panel_size=panel_size)
            w = mesh.gather_rows(w, _sizes(m_pad, mesh, axis), axis)
            return diag_S, w[:m, 0]

        factorization.operator_matmul = operator_matmul
        factorization.innovation_whiten = innovation_whiten

    return factorization


# ---------------------------------------------------------------------------
# The sharded attempt step
# ---------------------------------------------------------------------------


def _gathered_attempt(sc, mesh, axis, *, latent, num_derivatives, f, df, linear):
    """``distributed_qr=False``: the row-sharded factor and the cache are
    gathered for one local fused step; each rank keeps its rows."""
    attempt = latent_module.latent_attempt_step if latent else white_module.white_attempt_step
    layout = cov_layout(False)

    def step(mean, cov, t_next, dt):
        cache = type(sc.local)(**{k: _full(sc, k, mesh, axis) for k in sc.local._fields})
        full = mesh.gather_rows(cov, _sizes(sc.shapes["Ql"][0], mesh, axis), axis)
        M, C, err, ref, diff = attempt(cache, mean, full, t_next, dt,
                                       num_derivatives=num_derivatives, f=f, df=df,
                                       linear=linear, fused=True)
        return M, mesh.shard(C, layout), err, ref, diff

    return step


def _distributed_attempt(sc, mesh, axis, *, latent, num_derivatives, f, df, linear,
                         panel_size, two_qr):
    """``distributed_qr=True``: the white (or latent) attempt on column blocks
    of the factor, through the distributed factorization."""
    factorization = make_distributed_factorization(mesh=mesh, axis=axis, panel_size=panel_size,
                                                   memory_bounded=two_qr)
    ring = getattr(factorization, "operator_matmul", None)
    whiten = getattr(factorization, "innovation_whiten", None)
    n = num_derivatives + 1
    A1d = sc.local.A1d
    Ql = sc.local.Ql
    d = sc.shapes["L"][1]
    b_rows = sc.shapes["B"][0]
    m_dim = d + b_rows

    def operators(Jx):
        """``(G, B)`` as the step reads them: row blocks for the ring
        matmul, else whole (a layout gather when they are sharded)."""
        if ring is not None:
            L, B = _rows(sc, "L", mesh, axis), _rows(sc, "B", mesh, axis)
            if Jx is not None:
                start, stop = mesh.bounds(d, axis)
                L = Jx[start:stop] + L
            return L, B
        L, B = _full(sc, "L", mesh, axis), _full(sc, "B", mesh, axis)
        return (L if Jx is None else Jx + L), B

    def times(Op, x, rows):
        """``Op @ x`` for a replicated vector ``x`` from the operator as read."""
        if ring is None:
            return Op @ x
        return mesh.gather_rows(Op @ x, _sizes(rows, mesh, axis), axis)

    def matmul(Op, X, rows):
        return ring(Op, X, rows) if ring is not None else Op @ X

    if latent:
        start, stop = mesh.bounds(m_dim, axis)
        E_loc = Ql.new_zeros((m_dim, stop - start))
    else:
        E_loc = _columns(sc, "E_bc_sqrtm", mesh, axis)

    def step(mean, cov, t_next, dt):
        p, p_inv = iwp.nordsieck_scales_1d(num_derivatives, dt, dtype=mean.dtype,
                                           device=mean.device)
        # [Precondition] and [Predict mean]
        M = mean * p_inv[:, None]
        Cl = iwp.scale_stack(p_inv, cov)
        Mp = A1d @ M
        state_at = p[0] * Mp[0, :d]
        if linear:
            Jx, shift = None, torch.zeros_like(state_at)
        else:
            fx = f(t_next, state_at)
            Jx = df(t_next, state_at)
            shift = Jx @ state_at - fx
        G, B = operators(Jx)

        def apply_H(X):
            X0s = p[0] * iwp.project_derivative(X, 0, n)
            X1 = iwp.project_derivative(X, 1, n)
            ode = p[1] * X1[:d] - matmul(G, X0s[:d], d)
            if latent:
                ode = ode - X0s[d:]
            return torch.cat((ode, matmul(B, X0s[:d], b_rows)), dim=0)

        z_ode = p[1] * Mp[1, :d] - times(G, state_at, d) + shift
        if latent:
            z_ode = z_ode - p[0] * Mp[0, d:]
        z = torch.cat((z_ode, times(B, state_at, b_rows)))

        # [Error estimate] S = H Q H^T + E E^T, summed over the column blocks
        HQl = apply_H(Ql)
        if whiten is not None:
            diag_S, whitened = whiten(HQl, E_loc, z)
        else:
            S = mesh.psum(HQl @ HQl.T + E_loc @ E_loc.T, axis, region="layout")
            whitened = torch.cholesky_solve(z[:, None], torch.linalg.cholesky(S))[:, 0]
            diag_S = torch.diagonal(S)
        sigma_sq = z @ whitened / m_dim
        error = dt * (torch.sqrt(diag_S) * torch.sqrt(sigma_sq))[:d]

        # [Predict + update covariance] and [Calibrate + mean update]
        ACl = iwp.apply_stack_matrix(A1d, Cl)
        Cl_new, L21, K, Sl = white_module._predict_update(
            factorization, not two_qr, None, apply_H, ACl, HQl, Ql, E_loc, n)
        M_new, C_new, diff = white_module._calibrate_and_update(Mp, Cl_new, L21, K, Sl, z, p, n,
                                                                m_dim)
        return M_new, C_new, error, torch.abs(M_new[0, :d]), diff

    return step


def _attempt(cache, mesh, axis, *, latent, num_derivatives, f, df, linear, distributed_qr,
             panel_size, two_qr=False):
    if not isinstance(cache, ShardedCache):
        raise TypeError("place the cache with shard_cache (or sharded_init's "
                        "sharded_white_cache / sharded_latent_cache) first")
    if distributed_qr:
        return _distributed_attempt(cache, mesh, axis, latent=latent,
                                    num_derivatives=num_derivatives, f=f, df=df, linear=linear,
                                    panel_size=panel_size, two_qr=two_qr)
    if two_qr:
        raise ValueError("two_qr is a distributed_qr configuration")
    return _gathered_attempt(cache, mesh, axis, latent=latent, num_derivatives=num_derivatives,
                             f=f, df=df, linear=linear)


def make_space_sharded_white_step(*, cache, num_derivatives, mesh, f=None, df=None,
                                  linear=True, distributed_qr=False, panel_size=None,
                                  two_qr=False, axis="space"):
    """White-noise EK1 step sharded over the mesh's 'space' axis.

    Returns ``step(mean, cov, t_next, dt) -> (mean, cov, error, reference,
    diffusion_sq)`` with the mean replicated and ``cov`` the rank's block of
    the factor in :func:`cov_layout` (``distributed_qr``). ``cache`` comes
    from :func:`shard_cache` with the same ``distributed_qr``. ``two_qr``
    (with ``distributed_qr``) is the memory-bounded split; place the cache
    with ``shard_operands=True`` for it.
    """
    return _attempt(cache, mesh, axis, latent=False, num_derivatives=num_derivatives, f=f,
                    df=df, linear=linear, distributed_qr=distributed_qr,
                    panel_size=panel_size, two_qr=two_qr)


def make_space_sharded_latent_step(*, cache, num_derivatives, mesh, f=None, df=None,
                                   linear=True, distributed_qr=True, panel_size=None,
                                   axis="space"):
    """Latent-force EK1 step sharded over the mesh's 'space' axis: the
    stacked ``(n, 2d)`` mean and ``(2D, 2D)`` factor, the white step's
    contract, a zero measurement-noise block (the panel QR's jitter handles
    the exactly singular pre-array)."""
    return _attempt(cache, mesh, axis, latent=True, num_derivatives=num_derivatives, f=f,
                    df=df, linear=linear, distributed_qr=distributed_qr,
                    panel_size=panel_size)


def make_space_sharded_constant_solve(*, cache, num_derivatives, mesh, dt, num_steps, f=None,
                                      df=None, linear=True, latent=False, distributed_qr=True,
                                      panel_size=None, two_qr=False, axis="space"):
    """Space-sharded constant-step solve: ``num_steps`` steps of the sharded
    step, the diffusion calibrated as the mean of the per-step quasi-MLE
    locals and the final factor scaled by its square root (the
    ``simulate_final_state`` semantics of constant steps). Returns
    ``solve(mean0, cov0, t0) -> (mean, cov, diffusion_sq)``."""
    if two_qr and latent:
        raise ValueError("two_qr is a white-solver configuration")
    step = _attempt(cache, mesh, axis, latent=latent, num_derivatives=num_derivatives, f=f,
                    df=df, linear=linear, distributed_qr=distributed_qr,
                    panel_size=panel_size, two_qr=two_qr)

    def solve(mean0, cov0, t0):
        mean, cov = mean0, cov0
        diff_sum = mean0.new_zeros(())
        for i in range(num_steps):
            mean, cov, _, _, diff_sq = step(mean, cov, t0 + (i + 1) * dt, dt)
            diff_sum = diff_sum + diff_sq
        diffusion_sq = diff_sum / num_steps
        return mean, cov * torch.sqrt(diffusion_sq), diffusion_sq

    return solve


def make_space_sharded_adaptive_solve(*, cache, num_derivatives, mesh, steprule, t0, tmax,
                                      f=None, df=None, linear=True, latent=False,
                                      distributed_qr=True, panel_size=None, axis="space"):
    """Space-sharded adaptive solve: every attempt through the controller of
    the single-device solves (:func:`pnmol_tpu_torch.solvers.pdefilter.
    adaptive_attempt`), the factor carried in its layout across attempts.

    Every rank takes the same decision: the error estimate and reference
    that the controller reads are rank 0's, broadcast over the space axis
    (a layout collective), so the accept/reject and the next dt agree
    bitwise. A non-finite suggested dt ends the loop early (the returned
    ``t`` falls short of ``tmax``). Returns ``solve(mean0, cov0, dt0) -> (t,
    mean, cov, diffusion_sq, n_steps, n_attempts)`` with the factor scaled
    by ``sqrt(diffusion_sq)``.
    """
    step = _attempt(cache, mesh, axis, latent=latent, num_derivatives=num_derivatives, f=f,
                    df=df, linear=linear, distributed_qr=distributed_qr,
                    panel_size=panel_size)
    rate = num_derivatives + 1
    tmax = float(tmax)
    t_eps = 1e-12 * max(1.0, abs(tmax))

    def step_fn(mean, cov, t_next, dt):
        M, C, err, ref, diff = step(mean, cov, t_next, dt)
        return M, C, mesh.broadcast(err, axis), mesh.broadcast(ref, axis), diff

    def solve(mean0, cov0, dt0):
        t, mean, cov, dt = float(t0), mean0, cov0, float(dt0)
        diff_sum = mean0.new_zeros(())
        n_steps = n_attempts = 0
        while tmax - t > t_eps and math.isfinite(dt):
            t, mean, cov, dt, accepted, _, _, diff_sq, _ = pdefilter.adaptive_attempt(
                step_fn, steprule, rate, t, mean, cov, dt, tmax)
            if accepted:
                diff_sum = diff_sum + diff_sq
                n_steps += 1
            n_attempts += 1
        diffusion_sq = diff_sum / max(n_steps, 1)
        return t, mean, cov * torch.sqrt(diffusion_sq), diffusion_sq, n_steps, n_attempts

    return solve


# ---------------------------------------------------------------------------
# The steady tier: the sharded Riccati convergence and the mean-only solve
# ---------------------------------------------------------------------------


def _tiles(n, mesh, axis):
    return n % mesh.shape[axis] == 0


def _steady_layouts(shapes, mesh, axis, cov):
    """The placement plan of the frozen blocks: ``cov_inf`` in ``cov``,
    ``L21`` and ``Sl_inv`` row-sharded where their leading dimension tiles
    the mesh, the rest replicated."""
    layouts = dict.fromkeys(white_module.SteadyStateCache._fields, meshes.replicated())
    layouts["cov_inf"] = cov
    for name in ("L21", "Sl_inv"):
        if _tiles(shapes[name][0], mesh, axis):
            layouts[name] = meshes.space_sharding(rank=2)
    return layouts


def converge_space_sharded_steady_state(*, cache, cov0, dt, num_derivatives, mesh, latent=False,
                                        panel_size=None, tol=None, max_iters=200,
                                        meascov_dt_scaled=False, dtype=None, chunk_iters=None,
                                        seed=None, diagnostics=None, axis="space"):
    """Riccati fixed point of the sharded step (linear problems, constant
    dt): the steady-state convergence with the pre-array factorized by the
    distributed panel QR (:func:`make_distributed_factorization`), the
    factor column-sharded throughout.

    ``cache`` comes from :func:`shard_cache` with ``distributed_qr=True``;
    ``cov0`` is this rank's columns of the initial factor. Each chunk of
    ``chunk_iters`` iterations (all ``max_iters`` by default) is one call of
    the single-device convergence (``converge_white_steady_state`` or
    ``converge_latent_steady_state``) on the rank's column blocks, its Gram
    diagonals summed over the ranks; convergence is checked between chunks.
    Each chunk ends with one more step (its frozen blocks), which the next
    chunk starts from: that seam step counts, the last chunk's does not, as
    in the JAX tier. ``seed`` (default on for the white solver, off for the
    latent one) starts from :func:`~pnmol_tpu_torch.parallel.sharded_dare.
    sharded_steady_seed` (its ``info`` merged into ``diagnostics``), so the
    recursion only polishes. ``dtype`` (e.g. ``"float64"`` on an f32
    problem) runs the seed and the recursion in that type, the distributed
    factorization kept, and casts the blocks back.

    Returns a :class:`ShardedCache` of a
    :class:`~pnmol_tpu_torch.solvers.white.SteadyStateCache`: ``cov_inf``
    column-sharded, ``L21`` and ``Sl_inv`` row-sharded where their leading
    dimension tiles the mesh, the rest replicated.
    """
    from pnmol_tpu_torch.parallel import sharded_dare

    if not isinstance(cache, ShardedCache) or cache.layouts["Ql"] != cov_layout(True):
        raise TypeError("place the cache with shard_cache(distributed_qr=True) first")
    if max_iters < 1:
        raise ValueError(f"max_iters must be at least 1, got {max_iters}")
    out_dtype = cov0.dtype
    promote = dtype is not None and white_module._torch_dtype(dtype) != out_dtype
    if promote:
        ric_dtype = white_module._torch_dtype(dtype)
        cache = cache._replace(local=type(cache.local)(*(x.to(ric_dtype) for x in cache.local)))
        cov0 = cov0.to(ric_dtype)
    # the rank's view of the cache: Ql (and the white noise factor) its
    # columns, the operators whole
    local = cache.local._replace(L=_full(cache, "L", mesh, axis), B=_full(cache, "B", mesh, axis))
    if latent:
        converge, kwargs = latent_module.converge_latent_steady_state, {}
    else:
        local = local._replace(E_bc_sqrtm=_columns(cache, "E_bc_sqrtm", mesh, axis))
        converge = white_module.converge_white_steady_state
        kwargs = {"meascov_dt_scaled": meascov_dt_scaled}
    if seed is None:
        seed = not latent
    if seed and not latent:
        cov0, seed_info = sharded_dare.sharded_steady_seed(
            cache, dt, mesh, num_derivatives=num_derivatives, axis=axis,
            meascov_dt_scaled=meascov_dt_scaled, panel_size=panel_size)
        if diagnostics is not None:
            diagnostics.update(seed_info)
    if tol is None:
        tol = 1e-8 if cov0.dtype == torch.float64 else 1e-5
    chunk = min(chunk_iters or max_iters, max_iters)
    factorization = make_distributed_factorization(mesh=mesh, axis=axis, panel_size=panel_size)

    def row_sums(x):
        return mesh.psum(x, axis, region="layout")

    total, delta, C_cur, chunks = 0, float("inf"), cov0, 0
    while total < max_iters and (chunks == 0 or delta >= tol):
        steady = converge(local, C_cur, dt, num_derivatives=num_derivatives, fused=True,
                          factorization=factorization, tol=tol, max_iters=chunk,
                          row_sums=row_sums, **kwargs)
        C_cur, delta = steady.cov_inf, steady.delta
        chunks += 1
        total += steady.iterations + 1
    steady = steady._replace(iterations=total - 1)
    if promote:
        steady = steady._replace(**{k: v.to(out_dtype) for k, v in steady._asdict().items()
                                    if isinstance(v, torch.Tensor)})
    shapes = {k: (tuple(v.shape) if isinstance(v, torch.Tensor) else None)
              for k, v in steady._asdict().items()}
    D = shapes["cov_inf"][0]
    shapes["cov_inf"] = (D, D)
    layouts = _steady_layouts(shapes, mesh, axis, cov_layout(True))
    placed = steady._replace(**{k: mesh.shard(getattr(steady, k), layouts[k])
                                for k in ("L21", "Sl_inv")})
    return ShardedCache(local=placed, layouts=layouts, shapes=shapes)


def shard_steady_cache(steady, mesh, axis="space"):
    """Place frozen stationary blocks for the mean-only solve: ``cov_inf``,
    the (D, m) gain block ``L21`` and the (m, m) whitener ``Sl_inv``
    row-sharded where their leading dimension tiles the mesh (their matvecs
    are row-independent; the products are gathered), the rest replicated.

    ``steady`` is a single-device
    :class:`~pnmol_tpu_torch.solvers.white.SteadyStateCache` or the
    :class:`ShardedCache` of :func:`converge_space_sharded_steady_state`,
    whose column-sharded ``cov_inf`` moves to row blocks (an all-to-all).
    """
    if isinstance(steady, ShardedCache):
        D = steady.shapes["cov_inf"][0]
        cols = steady.local.cov_inf
        if _tiles(D, mesh, axis):
            cov_inf = mesh.transpose_rows(cols.T.contiguous(), (D, D), axis)
        else:
            cov_inf = _full(steady, "cov_inf", mesh, axis)
        layouts = dict(steady.layouts, cov_inf=(meshes.space_sharding(rank=2)
                                                if _tiles(D, mesh, axis) else meshes.replicated()))
        return steady._replace(local=steady.local._replace(cov_inf=cov_inf), layouts=layouts)
    shapes = {k: (tuple(v.shape) if isinstance(v, torch.Tensor) else None)
              for k, v in steady._asdict().items()}
    cov = meshes.space_sharding(rank=2) if _tiles(shapes["cov_inf"][0], mesh, axis) \
        else meshes.replicated()
    layouts = _steady_layouts(shapes, mesh, axis, cov)
    local = steady._replace(**{k: mesh.shard(getattr(steady, k), layouts[k])
                               for k in ("cov_inf", "L21", "Sl_inv")})
    return ShardedCache(local=local, layouts=layouts, shapes=shapes)


class _RowBlocks:
    """A row-sharded matrix as the mean-only step reads it: ``M @ v`` is
    the rank's rows times ``v``, gathered (the all-gather GSPMD inserts for
    the whitened residual and the gain's correction)."""

    def __init__(self, local, rows, mesh, axis):
        self.local, self.mesh, self.axis = local, mesh, axis
        self.sizes = meshes.block_sizes(rows, mesh.shape[axis])
        self.dtype, self.device = local.dtype, local.device

    def __matmul__(self, v):
        return self.mesh.gather_rows(self.local @ v, self.sizes, self.axis)


def make_space_sharded_steady_solve(*, cache, steady, num_derivatives, mesh, dt, num_steps,
                                    latent=False, axis="space"):
    """Space-sharded mean-only steady-state solve: ``num_steps`` steps of
    the frozen-gain step of ``make_steady_state_white_step`` (or
    ``make_steady_state_latent_step``) with ``L21`` and ``Sl_inv`` as the
    rank's row blocks, the whitened residual and the correction gathered,
    the mean replicated; no factorization, O(D m / P) work a rank a step.

    ``cache`` is the step cache's :class:`ShardedCache`, ``steady`` the
    blocks placed by :func:`shard_steady_cache`. Returns ``solve(mean0, t0)
    -> (mean, diffusion_sq)``, the diffusion the mean of the steps' local
    ones; the covariance is the frozen ``cov_inf``, not carried.
    """
    make = (latent_module.make_steady_state_latent_step if latent
            else white_module.make_steady_state_white_step)
    local = cache.local._replace(L=_full(cache, "L", mesh, axis), B=_full(cache, "B", mesh, axis))
    frozen = steady.local._replace(**{
        name: _RowBlocks(getattr(steady.local, name), steady.shapes[name][0], mesh, axis)
        for name in ("L21", "Sl_inv") if steady.layouts[name].spec[:1] == ("space",)})
    step = make(cache=local, steady=frozen, num_derivatives=num_derivatives)

    def solve(mean0, t0):
        mean, diff_sum = mean0, mean0.new_zeros(())
        for i in range(num_steps):
            mean, _, _, _, diff_sq = step(mean, steady.local.cov_inf, t0 + (i + 1) * dt, dt)
            diff_sum = diff_sum + diff_sq
        return mean, diff_sum / num_steps

    return solve
