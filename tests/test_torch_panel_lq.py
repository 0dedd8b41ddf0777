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


@pytest.mark.parametrize("defines", [(), ("PANEL_LQ_PHASES",)], ids=["kernel", "phase-stamps"])
def test_missing_nvcc_raises(monkeypatch, tmp_path, defines):
    """No fallback: without nvcc the kernel build raises (also the build
    with the phase stamps of ops/panel_lq_phases.py)."""
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(cuda_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("panel_lq", defines=defines)


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


# --- the CUDA kernel's dataflow, replayed on the CPU -------------------------


def _replay_kernel(slab, off, launch):
    """``csrc/panel_lq.cu``'s dataflow with torch on the CPU: the columns cut
    into ``launch.ctas`` chunks of ``launch.width``; per chunk the partials
    q_j = sum_{l > d} x_j[l] x_k[l] of its lanes, summed over the chunks that
    hold a lane > d in chunk order; a_j = x_j[d] from the chunk that holds
    lane d; every row's v_k . x_j as s_j = a_j + inv q_j; the update chunk by
    chunk; and T^T formed from the stored z rows and taus after the loop."""
    rows, cols = slab.shape
    x = slab.clone()
    chunks = [(p * launch.width, min((p + 1) * launch.width, cols))
              for p in range(launch.ctas)]

    def partials(k):
        d = off + k
        slots = [x[:, max(c0, d + 1):c1] @ x[k, max(c0, d + 1):c1]
                 for c0, c1 in chunks if c1 - 1 > d]
        q = torch.zeros(rows, dtype=x.dtype)
        for slot in slots:  # the kernel's order: slot by slot
            q = q + slot
        return q, x[:, d].clone()

    z = x.new_zeros((rows, rows))
    taus = x.new_zeros(rows)
    for k in range(rows):
        d = off + k
        q, a = partials(k)
        alpha = a[k]
        norm = torch.sqrt(alpha * alpha + q[k])  # the kernel's scalars
        beta = -norm if alpha >= 0 else norm
        inv = 1.0 / (alpha - beta) if norm > 0 else torch.zeros((), dtype=x.dtype)
        tau = (beta - alpha) / beta if norm > 0 else torch.zeros((), dtype=x.dtype)
        s = a + inv * q
        z[k, :k] = s[:k]
        taus[k] = tau
        for c0, c1 in chunks:
            if max(c0, d) >= c1:
                continue  # a chunk left of the diagonal
            lanes = torch.arange(max(c0, d), c1)
            v = torch.where(lanes == d, torch.ones((), dtype=x.dtype), x[k, lanes] * inv)
            x[k + 1:, lanes] -= (tau * s[k + 1:])[:, None] * v
            x[k, lanes] = torch.where(lanes == d, beta, v)
    tT = x.new_zeros((rows, rows))
    for k in range(rows):
        tT[k, :k] = -taus[k] * (z[k, :k] @ tT[:k, :k])
        tT[k, k] = taus[k]
    return x, tT


@pytest.mark.parametrize(
    "rows, cols, off, zero_rows, ctas",
    [(16, 70, 0, (), 3), (16, 70, 3, (5, 11), 4), (16, 70, 40, (), 6), (16, 64, 0, range(16), 5),
     (2, 37, 0, (), 4), (2, 37, 3, (1,), 7), (16, 70, 3, (), 1)],
    ids=["off0-ragged", "off3-zero-rows", "off40-chunks-left-of-diagonal", "zero-panel",
         "two-rows", "two-rows-off3-zero-row", "one-cta"],
)
def test_kernel_dataflow_matches_plain_version_and_jax(rows, cols, off, zero_rows, ctas):
    slab = _slab(np.random.default_rng(rows + cols + off + ctas), rows, cols, zero_rows)
    launch = tq.panel_lq_geometry(rows, cols, ctas, 8)
    assert launch.ctas == ctas
    lv, tT = _replay_kernel(torch.from_numpy(slab), off, launch)
    lv_r, tT_r = tq.panel_lq_reference(torch.from_numpy(slab), off)
    lv_j, tT_j = qh._block_lq(jnp.asarray(slab), off, leaf=min(8, rows), block=rows,
                              interpret=True)
    for got, want in ((lv, lv_r), (tT, tT_r), (lv, np.asarray(lv_j)), (tT, np.asarray(tT_j))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PANEL_TOL)
    for k in zero_rows:
        assert tT[k, k].item() == 0.0  # the identity reflector


def _sweep_panels(rows, cols, block=128):
    """(rows, cols) of every panel :func:`blocked_lq_l` launches on a
    ``(rows, cols)`` matrix."""
    return [(min(block, rows - i), cols - i) for i in range(0, rows, block)]


# the LQ pre-arrays of the N = 512 paths (init, step): white heat, latent
# heat, and Lotka-Volterra on 256 points
N512_PRE_ARRAYS = {"white": [(1538, 1538), (2050, 3586)],
                   "latent": [(2562, 2562), (3586, 6658)],
                   "lotka-volterra": [(1540, 1540), (2052, 3588)]}


@pytest.mark.parametrize("path", sorted(N512_PRE_ARRAYS))
@pytest.mark.parametrize("itemsize", [8, 4], ids=["f64", "f32"])
def test_launch_rule_covers_every_panel_of_the_n512_sweeps(path, itemsize):
    panels = [p for shape in N512_PRE_ARRAYS[path] for p in _sweep_panels(*shape)]
    assert len(panels) == {"white": 13 + 17, "latent": 21 + 29, "lotka-volterra": 13 + 17}[path]
    for rows, cols in panels:
        launch = tq.panel_lq_launch(rows, cols, itemsize, 132)
        assert 1 <= launch.ctas <= 131  # and the T^T CTA: at most 132 SMs
        covered = np.zeros(cols, dtype=int)
        for p in range(launch.ctas):
            lanes = slice(p * launch.width, min((p + 1) * launch.width, cols))
            assert lanes.start < lanes.stop  # no CTA without a column
            covered[lanes] += 1
        assert np.all(covered == 1)
        assert launch.registers  # every N = 512 panel fits in registers
        assert launch.width <= tq.PANEL_REGISTER_WIDTH
        assert launch.shared_bytes <= tq.SHARED_BYTES_PER_CTA
        assert launch.shared_bytes == tq.panel_lq_shared_bytes(rows, launch.width, True,
                                                                itemsize)


@pytest.mark.parametrize(
    "rows, cols, registers",
    [(128, 16000, True), (128, 20000, False), (136, 3586, False), (128, 40000, False)],
)
def test_launch_rule_puts_each_chunk_where_it_fits(rows, cols, registers):
    """In registers up to 128 rows of 128 columns a CTA, else in LV in
    global memory, where the CTA's shared memory holds no part of it."""
    launch = tq.panel_lq_launch(rows, cols, 8, 132)
    assert launch.registers == registers
    assert launch.shared_bytes <= tq.SHARED_BYTES_PER_CTA
    loop = (2 * launch.width if registers else 0) + launch.width + 3 * rows + 1024
    assert launch.shared_bytes == max(loop, rows * (rows + 2)) * 8


def test_launch_rule_sizes_the_tt_cta_of_a_tall_panel():
    """Past about 168 f64 rows the T^T CTA's shared memory is over the limit
    (the wrapper then raises on a CUDA tensor)."""
    launch = tq.panel_lq_launch(200, 600, 8, 132)
    assert launch.shared_bytes == 200 * 202 * 8 > tq.SHARED_BYTES_PER_CTA
