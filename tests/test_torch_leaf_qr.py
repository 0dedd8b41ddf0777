"""The port's tall R-form Householder QR: the leaf kernel's plain version
(the CUDA kernel is in test_torch_cuda.py), the blocked sweep and the
step hook, against the JAX package's Pallas leaf kernel run in interpret
mode, and the dx = 0.2 golden through the hook."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.models import examples as jexamples
from pnmol_tpu.odetools import step as jstep
from pnmol_tpu.ops import qr_householder as qh
from pnmol_tpu.solvers import white as jwhite
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop
from pnmol_tpu_torch.ops import cuda_build
from pnmol_tpu_torch.ops import qr_householder as tq
from pnmol_tpu_torch.ops import sqrt as tsqrt

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "heat_trajectories.npz"
# f64 rounding of Householder QRs of O(1) data at these sizes is ~1e-15 (the
# two packages sum in different orders; measured <= 9.3e-15 on R); 1e-12
# leaves two digits of margin.
QR_TOL = 1e-12
JAX_SWEEP = dict(leaf=8, block=16, row_quant=32, interpret=True)


def _gram(C):
    C = np.asarray(C)
    return C @ C.T


def test_leaf_reference_matches_pallas_leaf_kernel_with_zero_columns():
    """A zero column is the identity reflector (tau = 0) in both: the
    outputs agree entry by entry."""
    slab = np.random.default_rng(0).standard_normal((40, 8))
    slab[:, [0, 3]] = 0.0
    vr, t = qh._leaf_qr(jnp.asarray(slab), leaf=8, interpret=True)
    vr_t, t_t = tq.leaf_qr_reference(torch.from_numpy(slab))
    np.testing.assert_allclose(vr_t.numpy(), np.asarray(vr), rtol=0, atol=QR_TOL)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t), rtol=0, atol=QR_TOL)
    assert t_t[3, 3] == 0.0 and t_t[0, 0] == 0.0
    assert torch.all(torch.tril(t_t, -1) == 0)


def test_leaf_reference_matches_pallas_leaf_kernel_with_duplicate_columns():
    """A duplicate column leaves a tail of rounding noise, whose reflector
    differs between implementations; the factors agree by their Gram."""
    slab = np.random.default_rng(1).standard_normal((40, 8))
    slab[:, 5] = slab[:, 2]
    vr, _ = qh._leaf_qr(jnp.asarray(slab), leaf=8, interpret=True)
    vr_t, _ = tq.leaf_qr_reference(torch.from_numpy(slab))
    R, R_t = np.triu(np.asarray(vr)[:8]), np.triu(vr_t.numpy()[:8])
    G = slab.T @ slab
    np.testing.assert_allclose(R_t.T @ R_t, G, rtol=0, atol=QR_TOL * np.abs(G).max())
    np.testing.assert_allclose(R_t.T @ R_t, R.T @ R, rtol=0, atol=QR_TOL * np.abs(G).max())
    # the columns before the duplicate are unaffected
    np.testing.assert_allclose(vr_t.numpy()[:, :5], np.asarray(vr)[:, :5], rtol=0, atol=QR_TOL)


@pytest.mark.parametrize("shape", [(40, 17), (64, 64), (130, 50), (97, 33)], ids=str)
def test_blocked_qr_r_matches_jax(shape):
    A = np.random.default_rng(1).standard_normal(shape)
    R_j = np.asarray(qh.blocked_qr_r(jnp.asarray(A), **JAX_SWEEP))
    R = tq.blocked_qr_r(torch.from_numpy(A), leaf=8, block=16).numpy()
    assert R.shape == (shape[1], shape[1])
    assert np.all(np.tril(R, -1) == 0.0)
    # same reflector convention, so R agrees entry by entry; and R^T R = A^T A
    np.testing.assert_allclose(R, R_j, rtol=0, atol=QR_TOL * np.sqrt(shape[0]))
    G = A.T @ A
    np.testing.assert_allclose(R.T @ R, G, rtol=0, atol=QR_TOL * np.abs(G).max())


def test_blocked_qr_r_degenerate_columns():
    """Zero and duplicate columns (the noise-free Dirichlet rows make exactly
    singular pre-array directions), as in tests/test_ops/test_qr_householder.py."""
    A = np.random.default_rng(2).standard_normal((50, 12))
    A[:, 3] = 0.0
    A[:, 7] = A[:, 2]
    R = tq.blocked_qr_r(torch.from_numpy(A), leaf=4, block=8).numpy()
    R_j = np.asarray(qh.blocked_qr_r(jnp.asarray(A), leaf=4, block=8, row_quant=16,
                                     interpret=True))
    assert np.all(np.isfinite(R))
    G = A.T @ A
    np.testing.assert_allclose(R.T @ R, G, rtol=0, atol=QR_TOL * np.abs(G).max())
    np.testing.assert_allclose(R.T @ R, R_j.T @ R_j, rtol=0, atol=QR_TOL * np.abs(G).max())


def test_factorization_hook_matches_jax_and_the_plain_pipeline():
    """The hook of tests/test_ops/test_qr_householder.py's shapes (D=24,
    m=9; two blocks of two leaves), against JAX's hook and the port's plain
    torch.linalg.qr pipeline: posterior and innovation factors by Gram, the
    gain entry by entry (it does not depend on the QR's signs)."""
    rng = np.random.default_rng(3)
    D, m = 24, 9
    HACl, HQl = rng.standard_normal((m, D)), rng.standard_normal((m, D))
    ACl, Ql = np.tril(rng.standard_normal((D, D))), np.tril(rng.standard_normal((D, D)))
    Rm = np.tril(rng.standard_normal((m, m)))
    args = [HACl, ACl, HQl, Ql, Rm]
    C, K, S = tq.make_householder_factorization(leaf=8, block=16)(
        *(torch.from_numpy(a) for a in args))
    assert not hasattr(tq.make_householder_factorization(), "blocks")
    C_j, K_j, S_j = qh.make_householder_factorization(**JAX_SWEEP)(*(jnp.asarray(a) for a in args))
    for got, want in ((_gram(C), _gram(C_j)), (_gram(S), _gram(S_j))):
        np.testing.assert_allclose(got, want, rtol=0, atol=QR_TOL * np.abs(want).max())
    np.testing.assert_allclose(K.numpy(), np.asarray(K_j), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(K_j)).max())
    C_p, L21_p, S_p = tsqrt.fused_predict_update_blocks(*(torch.from_numpy(a) for a in args))
    torch.testing.assert_close(K @ S_p, L21_p, rtol=0, atol=1e-10)  # K = L21 Sl^{-1}
    torch.testing.assert_close(C @ C.T, C_p @ C_p.T, rtol=0, atol=1e-10)


def test_leaf_wrapper_takes_the_plain_version_on_cpu():
    slab = torch.from_numpy(np.random.default_rng(4).standard_normal((20, 6)))
    before = tq.leaf_qr.launches
    vr, t = tq.leaf_qr(slab)
    vr_r, t_r = tq.leaf_qr_reference(slab)
    assert tq.leaf_qr.launches == before == 0
    assert torch.equal(vr, vr_r) and torch.equal(t, t_r)


def test_leaf_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        tq.leaf_qr(torch.zeros((8, 4), device="meta"))


def test_blocked_qr_r_rejects_wide_input():
    with pytest.raises(ValueError, match="M >= N"):
        tq.blocked_qr_r(torch.zeros((3, 5), dtype=torch.float64))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: without nvcc the build of the source that holds the leaf
    kernel (the panel kernel's, launched on the tall layout) raises."""
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(cuda_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("panel_lq")


# --- the leaf kernel as the panel kernel on the tall layout -----------------


def _leaf_slab(rng, rows, leaf, zero_cols=(), duplicate=None):
    slab = rng.standard_normal((rows, leaf))
    slab[:, list(zero_cols)] = 0.0  # zero columns: the identity reflector
    if duplicate is not None:  # column duplicate[1] repeats column duplicate[0]
        slab[:, duplicate[1]] = slab[:, duplicate[0]]
    return slab


@pytest.mark.parametrize("leaf", [2, 8, 32])
@pytest.mark.parametrize("kind", ["zero-columns", "duplicate-column"])
def test_leaf_qr_is_the_panel_lq_of_the_transpose(leaf, kind):
    """The identity the CUDA leaf launch rests on: a tall slab's QR with the
    TPU numerics is the panel LQ of its transpose at off = 0, transposed
    (vr = LV^T, T = (T^T)^T), and both are JAX's Pallas leaf kernel. A zero
    column is the identity reflector, entry by entry. A duplicate column
    leaves a tail of rounding noise whose reflector differs between
    implementations: the columns before it agree entry by entry, R by its
    Gram. Tolerance: f64 rounding of O(1) data, ~1e-15, with margin."""
    rows = 40 if leaf < 32 else 70
    zero, dup = ((0, leaf - 1), None) if kind == "zero-columns" else ((), (0, leaf - 1))
    slab = _leaf_slab(np.random.default_rng(leaf), rows, leaf, zero, dup)
    vr, t = tq.leaf_qr_reference(torch.from_numpy(slab))
    lv, tT = tq.panel_lq_reference(torch.from_numpy(slab.T.copy()), 0)
    vr_j, t_j = (np.asarray(a) for a in qh._leaf_qr(jnp.asarray(slab), leaf=leaf, interpret=True))
    upto = leaf if dup is None else dup[1]  # the columns whose reflectors are defined
    for other_vr, other_t in ((lv.numpy().T, tT.numpy().T), (vr_j, t_j)):
        np.testing.assert_allclose(vr.numpy()[:, :upto], other_vr[:, :upto], rtol=0, atol=QR_TOL)
        np.testing.assert_allclose(t.numpy()[:upto, :upto], other_t[:upto, :upto], rtol=0,
                                   atol=QR_TOL)
        R, R_o = np.triu(vr.numpy()[:leaf]), np.triu(other_vr[:leaf])
        G = slab.T @ slab
        np.testing.assert_allclose(R.T @ R, G, rtol=0, atol=QR_TOL * np.abs(G).max())
        np.testing.assert_allclose(R_o.T @ R_o, G, rtol=0, atol=QR_TOL * np.abs(G).max())
    for k in zero:
        assert t[k, k].item() == 0.0


def _replay_tall_kernel(slab, launch):
    """``csrc/panel_lq.cu``'s dataflow on the tall layout, with torch on the
    CPU: the slab's rows cut into ``launch.ctas`` chunks of ``launch.width``
    consecutive rows; per chunk the partials q_j = sum_{r > k} x[r, j] x[r, k]
    of its rows for every column j, summed over the chunks that hold a row
    > k in chunk order; a_j = x[k, j] from the chunk that holds row k; every
    column's v_k . x_j as s_j = a_j + inv q_j; the update chunk by chunk; and
    T (the transpose of the T^T the kernel forms) after the loop."""
    rows, leaf = slab.shape
    x = slab.clone()
    chunks = [(p * launch.width, min((p + 1) * launch.width, rows))
              for p in range(launch.ctas)]
    z = x.new_zeros((leaf, leaf))
    taus = x.new_zeros(leaf)
    for k in range(leaf):
        q = torch.zeros(leaf, dtype=x.dtype)
        for c0, c1 in chunks:  # the kernel's order: slot by slot
            if c1 - 1 > k:
                below = slice(max(c0, k + 1), c1)
                q = q + x[below].T @ x[below, k]
        a = x[k].clone()
        alpha = a[k]
        norm = torch.sqrt(alpha * alpha + q[k])  # the kernel's scalars
        beta = -norm if alpha >= 0 else norm
        inv = 1.0 / (alpha - beta) if norm > 0 else torch.zeros((), dtype=x.dtype)
        tau = (beta - alpha) / beta if norm > 0 else torch.zeros((), dtype=x.dtype)
        s = a + inv * q
        z[k, :k] = s[:k]
        taus[k] = tau
        for c0, c1 in chunks:
            if max(c0, k) >= c1:
                continue  # a chunk above the diagonal
            lanes = torch.arange(max(c0, k), c1)
            v = torch.where(lanes == k, torch.ones((), dtype=x.dtype), x[lanes, k] * inv)
            x[lanes, k + 1:] -= v[:, None] * (tau * s[k + 1:])
            x[lanes, k] = torch.where(lanes == k, beta, v)
    tT = x.new_zeros((leaf, leaf))
    for k in range(leaf):
        tT[k, :k] = -taus[k] * (z[k, :k] @ tT[:k, :k])
        tT[k, k] = taus[k]
    return x, tT.T


@pytest.mark.parametrize(
    "rows, leaf, zero_cols, ctas",
    [(70, 8, (), 3), (70, 8, (2, 5), 4), (40, 16, (), 6), (64, 8, range(8), 5),
     (37, 2, (), 4), (37, 2, (1,), 7), (70, 8, (), 1)],
    ids=["ragged", "zero-columns", "chunks-above-diagonal", "zero-slab", "two-columns",
         "two-columns-zero-column", "one-cta"],
)
def test_tall_dataflow_matches_plain_version_and_jax(rows, leaf, zero_cols, ctas):
    slab = _leaf_slab(np.random.default_rng(rows + leaf + ctas), rows, leaf, zero_cols)
    launch = tq.panel_lq_geometry(leaf, rows, ctas, 8)  # LQ sizes: leaf rows, `rows` lanes
    assert launch.ctas == ctas
    vr, t = _replay_tall_kernel(torch.from_numpy(slab), launch)
    vr_r, t_r = tq.leaf_qr_reference(torch.from_numpy(slab))
    vr_j, t_j = qh._leaf_qr(jnp.asarray(slab), leaf=leaf, interpret=True)
    for got, want in ((vr, vr_r), (t, t_r), (vr, np.asarray(vr_j)), (t, np.asarray(t_j))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=QR_TOL)
    for k in zero_cols:
        assert t[k, k].item() == 0.0  # the identity reflector


def _sweep_leaves(rows, cols, leaf, block=128):
    """(rows, cols) of every slab :func:`blocked_qr_r` hands to ``leaf_qr``
    on a ``(rows, cols)`` matrix."""
    block = max(block, leaf)
    leaves = []
    for done in range(0, cols, block):
        width = min(block, cols - done)
        leaves += [(rows - done - jl, min(leaf, width - jl)) for jl in range(0, width, leaf)]
    return leaves


def test_sweep_leaves_are_the_slabs_blocked_qr_r_factorizes(monkeypatch):
    shapes = []

    def recording_leaf_qr(slab):
        shapes.append(tuple(slab.shape))
        return tq.leaf_qr_reference(slab)

    monkeypatch.setattr(tq, "leaf_qr", recording_leaf_qr)
    A = torch.from_numpy(np.random.default_rng(8).standard_normal((60, 37)))
    tq.blocked_qr_r(A, leaf=4, block=16)
    assert shapes == _sweep_leaves(60, 37, 4, block=16)
    assert len(shapes) == 2 * 4 + 2  # two blocks of 4 leaves, then 5 columns in 2


# the R-form pre-arrays of the N = 512 steps: white heat, latent heat
N512_R_FORM = {"white": (3586, 2050), "latent": (6658, 3586)}


@pytest.mark.parametrize("path", sorted(N512_R_FORM))
@pytest.mark.parametrize("leaf", [32, 128])
@pytest.mark.parametrize("itemsize", [8, 4], ids=["f64", "f32"])
def test_launch_rule_covers_every_leaf_of_the_n512_r_form_sweeps(path, leaf, itemsize):
    leaves = _sweep_leaves(*N512_R_FORM[path], leaf)
    assert len(leaves) == {("white", 32): 65, ("latent", 32): 113, ("white", 128): 17,
                           ("latent", 128): 29}[path, leaf]
    for rows, cols in leaves:
        launch = tq.leaf_qr_launch(rows, cols, itemsize, 132)
        assert 1 <= launch.ctas <= 131  # and the T^T CTA: at most 132 SMs
        covered = np.zeros(rows, dtype=int)
        for p in range(launch.ctas):
            span = slice(p * launch.width, min((p + 1) * launch.width, rows))
            assert span.start < span.stop  # no CTA without a row
            covered[span] += 1
        assert np.all(covered == 1)
        assert launch.registers  # every leaf of the N = 512 sweeps fits in registers
        assert launch.shared_bytes <= tq.SHARED_BYTES_PER_CTA
        assert launch == tq.panel_lq_launch(cols, rows, itemsize, 132)
    first = tq.leaf_qr_launch(*leaves[0], itemsize, 132)
    assert (first.ctas, first.width) == {"white": (32, 113), "latent": (56, 119)}[path]


@pytest.mark.parametrize("shape", [(40, 17), (97, 33)], ids=str)
def test_blocked_qr_r_with_one_leaf_per_block_matches_jax(shape):
    """``leaf = block``: one leaf per block and no leaf merge, a call JAX's
    ``blocked_qr_r`` takes too."""
    A = np.random.default_rng(9).standard_normal(shape)
    R_j = np.asarray(qh.blocked_qr_r(jnp.asarray(A), leaf=16, block=16, row_quant=32,
                                     interpret=True))
    R = tq.blocked_qr_r(torch.from_numpy(A), leaf=16, block=16).numpy()
    assert np.all(np.tril(R, -1) == 0.0)
    np.testing.assert_allclose(R, R_j, rtol=0, atol=QR_TOL * np.sqrt(shape[0]))
    G = A.T @ A
    np.testing.assert_allclose(R.T @ R, G, rtol=0, atol=QR_TOL * np.abs(G).max())


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as data:
        return {k: data[k] for k in data.files}


def _r_form_solver(**sweep):
    return pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(0.1),
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
        factorization=tq.make_householder_factorization(**sweep),
    )


@pytest.mark.parametrize("sweep", [{}, dict(leaf=8, block=16)], ids=["default", "leaf8-block16"])
def test_solve_through_the_hook_matches_golden(golden, sweep):
    """The dx = 0.2 heat solve through the R-form hook (the 44 x 26 step
    pre-array: one leaf by default, four leaves in two blocks at leaf 8),
    with the thresholds of tests/test_golden.py."""
    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device="cpu")
    sol = _r_form_solver(**sweep).solve(heat)
    np.testing.assert_allclose(sol.mean.numpy(), golden["white_mean"], rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(float(sol.diffusion_squared_calibrated),
                               golden["white_diffusion"], rtol=1e-10)
    std = torch.sqrt(torch.einsum("ij,ij->i", sol.cov_sqrtm[-1], sol.cov_sqrtm[-1]))
    np.testing.assert_allclose(std.numpy(), golden["white_final_std"], rtol=1e-8, atol=1e-12)
    assert sol.info["num_steps"] == 5


def test_solve_through_the_hook_matches_jax_hook_solve():
    """The same problem through each package's R-form hook. Measured: mean
    4.1e-15, covariance Gram 3.5e-16, diffusion 2.2e-16 relative; the
    bounds of 1e-9 leave five digits of margin."""
    jheat = jexamples.heat_1d_discretized(dx=0.2, tmax=0.5)
    jsol = jwhite.LinearWhiteNoiseEK1(
        steprule=jstep.Constant(0.1),
        factorization=qh.make_householder_factorization(**JAX_SWEEP),
    ).solve(jheat)
    heat = interop.discretized_problem(
        L=np.asarray(jheat.L), E_sqrtm=np.asarray(jheat.E_sqrtm), B=np.asarray(jheat.B),
        R_sqrtm=np.asarray(jheat.R_sqrtm), y0=np.asarray(jheat.y0),
        points=np.asarray(jheat.mesh_spatial.points), t0=jheat.t0, tmax=jheat.tmax,
        device="cpu",
    )
    sol = _r_form_solver(leaf=8, block=16).solve(heat)
    mean, jmean = sol.mean.numpy(), np.asarray(jsol.mean)
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=1e-9 * np.abs(jmean).max())
    G, jG = _gram(sol.cov_sqrtm[-1]), _gram(jsol.cov_sqrtm[-1])
    np.testing.assert_allclose(G, jG, rtol=0, atol=1e-9 * np.abs(jG).max())
    np.testing.assert_allclose(float(sol.diffusion_squared_calibrated),
                               float(jsol.diffusion_squared_calibrated), rtol=1e-9)
