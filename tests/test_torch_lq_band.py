"""The port's banded LQ sweep (``band=``) and the two-QR primitives of the
Householder hooks (``.propagate`` with ``.banded``/``.interleaved``,
``.update_from_products`` and ``.blocks_banded``, ``.tri``, the plain
``sqrt.propagate_cholesky_factor``) against the dense sweep and against the
JAX package's (Pallas in interpret mode, or XLA's QR)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu.ops import iwp as jiwp
from pnmol_tpu.ops import qr_householder as qh
from pnmol_tpu.ops import sqrt as jsqrt
from pnmol_tpu_torch.ops import iwp
from pnmol_tpu_torch.ops import qr_householder as tq
from pnmol_tpu_torch.ops import sqrt as tsqrt

torch.set_num_threads(1)

# the same reflectors on the same columns, summed in other orders (windowed
# and dense slabs, the port's and the Pallas kernels): f64 rounding
ATOL = 1e-12
JAX_SWEEP = dict(leaf=8, block=16, lane_quant=32, interpret=True)


def leaf_route(monkeypatch):
    """Send the port's 16-row blocks down the leaf route, where the panel
    kernel's size rule sends only larger blocks."""
    monkeypatch.setattr(tq, "panel_takes_rows", lambda rows, itemsize: False)


def _banded_random(rows, cols, b0, slope, rng):
    W = rng.standard_normal((rows, cols))
    W[np.arange(cols)[None, :] >= b0 + slope * np.arange(rows)[:, None]] = 0.0
    return W


@pytest.mark.parametrize(
    "band, shape, superblocks",
    [((9, 1), (48, 80), None), ((6, 2), (48, 112), None), ((6, 2), (48, 112), 3),
     ((17, 1), (40, 64), 99), ((33, 1), (48, 48), None)],
    ids=str,
)
@pytest.mark.parametrize("panel", ["block", "leaf"])
def test_lq_banded_matches_dense_and_jax(monkeypatch, band, shape, superblocks, panel):
    """The five cases of the JAX package's banded test (its superblocks are
    a TPU scan choice the port does not have), on the block and the leaf
    route: banded against dense on the port, and against the JAX banded
    factor, entry by entry."""
    if panel == "leaf":
        leaf_route(monkeypatch)
    W = _banded_random(*shape, *band, np.random.default_rng(7))
    L_banded = tq.blocked_lq_l(torch.from_numpy(W), leaf=8, block=16, band=band)
    L_dense = tq.blocked_lq_l(torch.from_numpy(W), leaf=8, block=16)
    torch.testing.assert_close(L_banded, L_dense, rtol=0, atol=1e-13)
    if panel == "leaf":  # one JAX sweep per case
        L_jax = qh.blocked_lq_l(jnp.asarray(W), band=band, superblocks=superblocks, **JAX_SWEEP)
        np.testing.assert_allclose(L_banded.numpy(), np.asarray(L_jax), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def propagate_blocks():
    """Realistic sqrt-Kalman propagate blocks: Ql lower-triangular, ACl the
    point-block-diagonal transition applied to a triangular factor."""
    rng = np.random.default_rng(11)
    d, n = 11, 3
    Cl = np.tril(rng.standard_normal((d * n, d * n)))
    A1d = rng.standard_normal((n, n))
    ACl = np.array(jiwp.apply_stack_matrix(jnp.asarray(A1d), jnp.asarray(Cl)))  # writable
    Ql = np.tril(rng.standard_normal((d * n, d * n)))
    np.testing.assert_allclose(
        iwp.apply_stack_matrix(torch.from_numpy(A1d), torch.from_numpy(Cl)).numpy(), ACl,
        rtol=0, atol=1e-14)
    return ACl, Ql, n


@pytest.mark.parametrize("variant", ["dense", "banded", "interleaved"])
def test_propagate_variants_match_jax(monkeypatch, propagate_blocks, variant):
    leaf_route(monkeypatch)
    ACl, Ql, n = propagate_blocks
    prop = tq.make_householder_propagate(leaf=8, block=16)
    jprop = qh.make_householder_propagate(**JAX_SWEEP)
    args = (ACl, Ql, n) if variant == "interleaved" else (ACl, Ql)
    fn, jfn = ((prop, jprop) if variant == "dense"
               else (getattr(prop, variant), getattr(jprop, variant)))
    got = fn(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)).numpy()
    want = np.asarray(jfn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got @ got.T, ACl @ ACl.T + Ql @ Ql.T, rtol=0, atol=1e-10)
    assert np.all(np.triu(got, 1) == 0.0)
    if variant == "banded":  # the same pre-array, windowed
        dense = prop(torch.from_numpy(ACl), torch.from_numpy(Ql)).numpy()
        np.testing.assert_allclose(got, dense, rtol=0, atol=1e-13)


def test_interleaving_is_a_column_gather():
    """Point blocks of q columns of S1 and S2 alternate: [S1_0, S2_0, S1_1, ...]."""
    rng = np.random.default_rng(2)
    S1, S2 = (np.tril(rng.standard_normal((6, 6))) for _ in range(2))
    calls = []
    prop = tq.make_householder_propagate(leaf=2, block=4)

    def spy(work, **kw):
        calls.append((work.clone(), kw["band"]))
        return torch.tril(work[:, :work.shape[0]])

    real = tq._lq_in_place
    tq._lq_in_place = spy
    try:
        prop.interleaved(torch.from_numpy(S1), torch.from_numpy(S2), 2)
    finally:
        tq._lq_in_place = real
    (M, band), = calls
    want = np.concatenate([np.concatenate((S1[:, 2 * i:2 * i + 2], S2[:, 2 * i:2 * i + 2]), 1)
                           for i in range(3)], 1)
    np.testing.assert_array_equal(M.numpy(), want)
    assert band == (4, 2)


def test_update_blocks_banded_matches_dense_and_jax(monkeypatch):
    leaf_route(monkeypatch)
    rng = np.random.default_rng(3)
    m, D = 10, 24
    HC, C = rng.standard_normal((m, D)), rng.standard_normal((D, D))  # no condition on C
    R = np.tril(rng.standard_normal((m, m)))
    upd = tq.make_householder_update_from_products(leaf=8, block=16)
    got = upd.blocks_banded(*(torch.from_numpy(a) for a in (HC, C, R)))
    dense = upd.blocks(*(torch.from_numpy(a) for a in (HC, C, R)))
    want = qh.make_householder_update_from_products(**JAX_SWEEP).blocks_banded(
        *(jnp.asarray(a) for a in (HC, C, R)))
    for g, d_, w in zip(got, dense, want):
        torch.testing.assert_close(g, d_, rtol=0, atol=1e-13)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_fused_blocks_banded_and_tri_match_jax(monkeypatch):
    leaf_route(monkeypatch)
    rng = np.random.default_rng(4)
    m, D = 9, 21
    HACl, HQl = rng.standard_normal((m, D)), rng.standard_normal((m, D))
    ACl, Ql = rng.standard_normal((D, D)), rng.standard_normal((D, D))
    E = np.tril(rng.standard_normal((m, m)))
    args = (HACl, ACl, HQl, Ql, E)
    fact = tq.make_householder_lq_factorization(leaf=8, block=16)
    jfact = qh.make_householder_lq_factorization(**JAX_SWEEP)
    got = fact.blocks_banded(*(torch.from_numpy(a) for a in args))
    dense = fact.blocks(*(torch.from_numpy(a) for a in args))
    want = jfact.blocks_banded(*(jnp.asarray(a) for a in args))
    for g, d_, w in zip(got, dense, want):
        torch.testing.assert_close(g, d_, rtol=0, atol=1e-13)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    tri = fact.tri(torch.from_numpy(ACl)).numpy()
    np.testing.assert_allclose(tri, np.asarray(jfact.tri(jnp.asarray(ACl))), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tri @ tri.T, ACl @ ACl.T, rtol=0, atol=1e-10)


def test_plain_propagate_matches_jax():
    rng = np.random.default_rng(5)
    S1, S2 = rng.standard_normal((12, 12)), np.tril(rng.standard_normal((12, 12)))
    got = tsqrt.propagate_cholesky_factor(torch.from_numpy(S1), torch.from_numpy(S2)).numpy()
    want = np.asarray(jsqrt.propagate_cholesky_factor(jnp.asarray(S1), jnp.asarray(S2)))
    np.testing.assert_allclose(got @ got.T, want @ want.T, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got @ got.T, S1 @ S1.T + S2 @ S2.T, rtol=0, atol=1e-12)
    assert np.all(np.triu(got, 1) == 0.0)
