"""The port's Householder-LQ panel (its plain version; the CUDA kernel is
in test_torch_cuda.py) and its blocked sweep, against the JAX package's
Pallas kernels run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.ops import qr_householder as qh
from pnmol_tpu_torch.ops import cuda_build
from pnmol_tpu_torch.ops import qr_householder as tq
from pnmol_tpu_torch.ops import sqrt as tsqrt

torch.set_num_threads(1)

# f64 rounding of Householder panels of these sizes is ~1e-15 (the plain
# version and the Pallas kernel sum in different orders); 1e-12 leaves
# three digits of margin.
PANEL_TOL = 1e-12


def _slab(rng, rows, cols, zero_rows=()):
    slab = rng.standard_normal((rows, cols))
    slab[list(zero_rows)] = 0.0  # zero rows: the identity reflector (tau = 0)
    return slab


@pytest.mark.parametrize("off", [0, 3, 40])
def test_reference_matches_block_panel_kernel(off):
    slab = _slab(np.random.default_rng(off), 16, 64, zero_rows=(5, 11))
    lv, tT = qh._block_lq(jnp.asarray(slab), off, leaf=8, block=16, interpret=True)
    lv_t, tT_t = tq.panel_lq_reference(torch.from_numpy(slab), off)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv), rtol=0, atol=PANEL_TOL)
    np.testing.assert_allclose(tT_t.numpy(), np.asarray(tT), rtol=0, atol=PANEL_TOL)


def test_reference_matches_leaf_panel_kernel():
    slab = _slab(np.random.default_rng(7), 8, 64)
    lv, tT = qh._leaf_lq(jnp.asarray(slab), 5, leaf=8, interpret=True)
    lv_t, tT_t = tq.panel_lq_reference(torch.from_numpy(slab), 5)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv), rtol=0, atol=PANEL_TOL)
    np.testing.assert_allclose(tT_t.numpy(), np.asarray(tT), rtol=0, atol=PANEL_TOL)


@pytest.mark.parametrize("shape", [(40, 70), (50, 90)])
def test_blocked_lq_l_matches_jax(shape):
    W = np.random.default_rng(sum(shape)).standard_normal(shape)
    L = np.asarray(
        qh.blocked_lq_l(jnp.asarray(W), leaf=8, block=16, lane_quant=64, interpret=True)
    )
    L_t = tq.blocked_lq_l(torch.from_numpy(W), block=16).numpy()
    # same reflector sign convention, so the factors agree entrywise; and
    # both are factors of W W^T. Tolerance: f64 rounding times ||W||^2.
    scale = np.abs(W @ W.T).max()
    np.testing.assert_allclose(L_t, L, rtol=0, atol=1e-12 * np.sqrt(scale))
    np.testing.assert_allclose(L_t @ L_t.T, W @ W.T, rtol=0, atol=1e-12 * scale)
    assert np.all(np.triu(L_t, 1) == 0.0)


def test_wrapper_takes_the_plain_version_on_cpu():
    slab = torch.from_numpy(_slab(np.random.default_rng(3), 12, 40))
    before = tq.panel_lq.launches
    lv, tT = tq.panel_lq(slab, 2)
    lv_r, tT_r = tq.panel_lq_reference(slab, 2)
    assert tq.panel_lq.launches == before == 0
    assert torch.equal(lv, lv_r) and torch.equal(tT, tT_r)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: without nvcc the kernel build raises."""
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(cuda_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("panel_lq")


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        tq.panel_lq(torch.zeros((2, 4), device="meta"), 0)


def test_blocked_lq_l_rejects_tall_input():
    with pytest.raises(ValueError, match="cols >= rows"):
        tq.blocked_lq_l(torch.zeros((5, 3), dtype=torch.float64))


def test_pair_columns_is_not_ported():
    with pytest.raises(NotImplementedError, match="pair_columns"):
        tq.make_householder_lq_factorization(pair_columns=True)


def _gram_blocks(L3, L21, L1):
    return L3 @ L3.T, L21 @ L1.T, L1 @ L1.T


def test_factorization_hooks_match_the_plain_pipeline():
    """The hooks' factor blocks have the Grams of the torch.linalg.qr
    pipeline's (m=6, D=18: several 4-row panels per sweep)."""
    rng = np.random.default_rng(11)
    m, D = 6, 18
    HACl, HQl = (torch.from_numpy(rng.standard_normal((m, D))) for _ in range(2))
    ACl, Ql = (torch.from_numpy(rng.standard_normal((D, D))) for _ in range(2))
    E = torch.from_numpy(np.tril(rng.standard_normal((m, m))))
    fused = tq.make_householder_lq_factorization(block=4)
    got = _gram_blocks(*fused.blocks(HACl, ACl, HQl, Ql, E))
    want = _gram_blocks(*tsqrt.fused_predict_update_blocks(HACl, ACl, HQl, Ql, E))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)

    upd = tq.make_householder_update_from_products(block=4)
    got = _gram_blocks(*upd.blocks(HACl, ACl, E))
    want = _gram_blocks(*tsqrt.update_sqrt_from_products_blocks(HACl, ACl, E))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)
    # the gain form agrees with the blocks form: K = L21 L1^{-1}
    L3, K, L1 = upd(HACl, ACl, E)
    _, L21, _ = upd.blocks(HACl, ACl, E)
    torch.testing.assert_close(K @ L1, L21, rtol=0, atol=1e-12)

