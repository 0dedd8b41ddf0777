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
    """No fallback: without nvcc the leaf kernel's build raises."""
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(cuda_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("leaf_qr")


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
