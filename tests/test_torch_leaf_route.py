"""The port's LQ leaf route (one leaf_lq per leaf, the leaves' T^T merged;
its plain version here, the CUDA launch in test_torch_cuda.py) against the
JAX package's leaf route (``panel="leaf"``, Pallas in interpret mode) and
against the port's own block route, and the rule that picks it. The rule
sends only blocks of more than 169 rows (f64) down the leaf route; the
tests send small blocks there by replacing the rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.ops import qr_householder as qh
import pnmol_tpu_torch as pt
from pnmol_tpu_torch.ops import qr_householder as tq

torch.set_num_threads(1)


def leaf_route(monkeypatch):
    monkeypatch.setattr(tq, "panel_takes_rows", lambda rows, itemsize: False)


def _wide(shape, seed, zero_row=5):
    W = np.random.default_rng(seed).standard_normal(shape)
    W[min(zero_row, shape[0] - 1)] = 0.0  # the identity reflector (tau = 0)
    return W


@pytest.mark.parametrize("shape", [(17, 40), (40, 70)], ids=str)
def test_leaf_route_matches_jax_leaf_route(monkeypatch, shape):
    """The same reflectors in the same order: L agrees entry by entry."""
    leaf_route(monkeypatch)
    W = _wide(shape, sum(shape))
    L_jax = np.asarray(qh.blocked_lq_l(jnp.asarray(W), leaf=8, block=16, lane_quant=32,
                                       interpret=True, panel="leaf"))
    L = tq.blocked_lq_l(torch.from_numpy(W), leaf=8, block=16).numpy()
    np.testing.assert_allclose(L, L_jax, rtol=0, atol=1e-12)
    np.testing.assert_allclose(L @ L.T, W @ W.T, rtol=0, atol=1e-10)
    assert np.all(np.triu(L, 1) == 0.0)


@pytest.mark.parametrize("shape, leaf, block",
                         [((17, 40), 8, 16), ((70, 130), 8, 16), ((64, 64), 4, 32),
                          ((50, 90), 16, 48), ((33, 80), 32, 32)], ids=str)
def test_leaf_route_matches_block_route(monkeypatch, shape, leaf, block):
    """Leaves merged into one compact WY per block: the block route's
    factor to rounding (ragged last blocks and leaves included)."""
    W = torch.from_numpy(_wide(shape, 3 * sum(shape)))
    L_block = tq.blocked_lq_l(W, leaf=leaf, block=block)
    leaf_route(monkeypatch)
    L_leaf = tq.blocked_lq_l(W, leaf=leaf, block=block)
    torch.testing.assert_close(L_leaf, L_block, rtol=0, atol=1e-12)


def test_leaf_route_factor_matches_the_panel_contract():
    """One block through the leaf route returns what one panel launch on the
    whole block would: LV, its reflector rows and the block-wide T^T."""
    blk = torch.from_numpy(_wide((24, 60), 9))
    lv, V, tT = tq._leaf_route(blk, 8)
    lv_p, tT_p = tq.panel_lq_reference(blk, 0)
    torch.testing.assert_close(lv, lv_p, rtol=0, atol=1e-12)
    torch.testing.assert_close(tT, tT_p, rtol=0, atol=1e-12)
    torch.testing.assert_close(V, tq._reflectors(lv_p), rtol=0, atol=1e-12)


@pytest.mark.parametrize("block, itemsize, leaves",
                         [(128, 8, False), (169, 8, False), (170, 8, True), (256, 8, True),
                          (240, 4, False), (256, 4, True)])
def test_auto_takes_the_leaf_route_where_the_panel_kernel_cannot_take_the_block(
        block, itemsize, leaves):
    """The T^T CTA's shared memory decides: 128-row blocks in one launch,
    256-row blocks leaf by leaf, in f64 and in f32."""
    assert tq.panel_takes_rows(block, itemsize) is not leaves
    launch_bytes = tq.panel_lq_launch(block, 4 * block, itemsize, 132).shared_bytes
    assert (launch_bytes > tq.SHARED_BYTES_PER_CTA) is leaves


def _count_launches(monkeypatch):
    """Replace both wrappers by their plain versions that note each slab's
    rows, by kind."""
    calls = {"panel": [], "leaf": []}

    def count(kind):
        def run(slab, off):
            calls[kind].append(slab.shape[0])
            return tq.panel_lq_reference(slab, off)
        return run

    monkeypatch.setattr(tq, "panel_lq", count("panel"))
    monkeypatch.setattr(tq, "leaf_lq", count("leaf"))
    return calls


@pytest.mark.parametrize("block, panels, leaves", [(128, [128, 128, 44], []),
                                                   (256, [], [32] * 9 + [12])])
def test_the_block_size_picks_the_route(monkeypatch, block, panels, leaves):
    """300 rows: 128-row blocks in one panel launch each; 256-row blocks
    (and the short last block) leaf by leaf; the same L to rounding."""
    calls = _count_launches(monkeypatch)
    W = torch.from_numpy(_wide((300, 420), 4))
    L = tq.blocked_lq_l(W, leaf=32, block=block)
    assert calls == {"panel": panels, "leaf": leaves}
    torch.testing.assert_close(L @ L.T, W @ W.T, rtol=0, atol=1e-10)
    L_ref = tq.blocked_lq_l(W, leaf=32, block=64)
    torch.testing.assert_close(L, L_ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("d, block, leaf", [(2048, 128, None), (4096, 256, 32), (8192, 256, 64)])
def test_householder_hooks_take_the_leaf_route_from_4096_points(monkeypatch, d, block, leaf):
    """resolve_householder_hooks sizes the sweep as the JAX package does; at
    256-row blocks each block runs ceil(b / leaf) leaves and no panel."""
    calls = _count_launches(monkeypatch)
    factorization, init_update = pt.white.resolve_householder_hooks(d)
    rng = np.random.default_rng(d)
    m, D = 4, 300  # a (304, 608) fused pre-array: blocks of min(block, rows left) rows
    HC = torch.from_numpy(rng.standard_normal((m, D)))
    C = torch.from_numpy(rng.standard_normal((D, D)))
    E = torch.from_numpy(np.tril(rng.standard_normal((m, m))))
    init_update.blocks(HC, C, E)
    blocks = [min(block, m + D - i) for i in range(0, m + D, block)]
    if leaf is None:
        assert calls == {"panel": blocks, "leaf": []}
    else:
        leaves = [min(leaf, b - j) for b in blocks for j in range(0, b, leaf)]
        assert calls == {"panel": [], "leaf": leaves}


def test_leaf_lq_takes_the_plain_version_on_cpu():
    slab = torch.from_numpy(_wide((8, 40), 2))
    before = (tq.leaf_lq.launches, tq.panel_lq.launches)
    lv, tT = tq.leaf_lq(slab, 3)
    lv_r, tT_r = tq.panel_lq_reference(slab, 3)
    assert (tq.leaf_lq.launches, tq.panel_lq.launches) == before == (0, 0)
    assert torch.equal(lv, lv_r) and torch.equal(tT, tT_r)


def test_leaf_lq_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="unsupported device"):
        tq.leaf_lq(torch.zeros((4, 8), dtype=torch.float64, device="meta"), 0)
    with pytest.raises(ValueError, match="cols >= rows"):
        tq.blocked_lq_l(torch.zeros((8, 4), dtype=torch.float64), leaf=2, block=4)
