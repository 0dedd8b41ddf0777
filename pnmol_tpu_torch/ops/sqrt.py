"""Square-root Kalman factors through ``torch.linalg.qr``.

Counterpart of :mod:`pnmol_tpu.ops.sqrt`: the plain pipeline that the
Householder-LQ kernel path (:mod:`pnmol_tpu_torch.ops.qr_householder`) is
held against, and the dense updates of the ODE filter and the Kalman steps.
One QR of the stacked pre-array gives an upper factor whose blocks are the
innovation factor, the cross factor and the posterior factor. The
``*_blocks`` functions return them transposed to lower form, ``(posterior
(D, D), L21 (D, m), L1 (m, m))`` with ``S_xz = L21 L1^T``; the gain
functions return ``(posterior (D, D), gain (D, m), innovation factor (m,
m))``, the gain from one triangular solve.
"""

import torch


def triu_qr(mat):
    """Upper triangular factor of a QR decomposition, shape (min(M,N), N).

    ``mode="r"`` skips Q, but torch has no backward for it: where autograd
    records through ``mat`` the reduced QR runs instead (the same R), so
    runs without gradients keep the cheaper mode."""
    mode = "reduced" if torch.is_grad_enabled() and mat.requires_grad else "r"
    return torch.linalg.qr(mat, mode=mode)[1]


def sqrtm_to_cholesky(St):
    """Lower factor L with ``L L^T = St^T St``, from a 'right' square root."""
    return triu_qr(St).T


def propagate_cholesky_factor(S1, S2):
    """Lower factor of ``S1 S1^T + S2 S2^T`` from one QR of the stacked
    roots ``[S1^T; S2^T]`` (the two-QR pipeline's plain propagate)."""
    return triu_qr(torch.cat((S1.T, S2.T), dim=0)).T


def update_sqrt_from_products(HC, C, meascov_sqrtm):
    """Sqrt update from ``HC = H @ C`` (m, D), the factor ``C`` (D, D) and
    the measurement-noise factor ``R`` (m, m): the blocks of
    :func:`update_sqrt_from_products_blocks` with the gain ``(R1^{-1}
    R2)^T`` from one triangular solve (``R1 = L1^T``, ``R2 = L21^T``)."""
    posterior, L21, L1 = update_sqrt_from_products_blocks(HC, C, meascov_sqrtm)
    return posterior, _gain(L1, L21), L1


def _gain(L1, L21):
    """``L21 L1^{-1}`` by one triangular solve."""
    return torch.linalg.solve_triangular(L1.T, L21.T, upper=True).T


def update_sqrt(transition_matrix, cov_cholesky, meascov_sqrtm):
    """:func:`update_sqrt_from_products` with an explicit measurement matrix."""
    return update_sqrt_from_products(
        transition_matrix @ cov_cholesky, cov_cholesky, meascov_sqrtm
    )


def update_sqrt_no_meascov_from_products(HC, C):
    """Noise-free :func:`update_sqrt_from_products`."""
    m = HC.shape[0]
    return update_sqrt_from_products(HC, C, HC.new_zeros((m, m)))


def update_sqrt_no_meascov(transition_matrix, cov_cholesky):
    """Noise-free :func:`update_sqrt` with an explicit measurement matrix."""
    return update_sqrt_no_meascov_from_products(
        transition_matrix @ cov_cholesky, cov_cholesky
    )


def update_sqrt_from_products_blocks(HC, C, meascov_sqrtm):
    """Sqrt update from ``HC = H @ C``: the QR of
    ``[[HC^T, C^T], [R^T, 0]]``, returned as raw lower factor blocks."""
    m, D = HC.shape
    top = torch.cat((HC.T, C.T), dim=1)
    bottom = torch.cat((meascov_sqrtm.T, HC.new_zeros((m, D))), dim=1)
    R = triu_qr(torch.cat((top, bottom), dim=0))
    return R[m:, m:].T, R[:m, m:].T, R[:m, :m].T


def fused_predict_update_blocks(HACl, ACl, HQl, Ql, meascov_sqrtm):
    """Predict and update in ONE QR of the pre-array
    ``[[(H A Cl)^T, (A Cl)^T], [(H Ql)^T, Ql^T], [R^T, 0]]``, returned as
    raw lower factor blocks."""
    m, D = HACl.shape
    top = torch.cat((HACl.T, ACl.T), dim=1)
    mid = torch.cat((HQl.T, Ql.T), dim=1)
    bottom = torch.cat((meascov_sqrtm.T, HACl.new_zeros((m, D))), dim=1)
    R = triu_qr(torch.cat((top, mid, bottom), dim=0))
    return R[m:, m:].T, R[:m, m:].T, R[:m, :m].T


def fused_predict_update(HACl, ACl, HQl, Ql, meascov_sqrtm):
    """:func:`fused_predict_update_blocks` with the gain: ``(posterior
    (D, D), gain (D, m), innovation factor (m, m))``, the gain ``(R1^{-1}
    R2)^T`` from one triangular solve (the JAX package's hook contract)."""
    posterior, L21, L1 = fused_predict_update_blocks(HACl, ACl, HQl, Ql, meascov_sqrtm)
    return posterior, _gain(L1, L21), L1


def batched_update_sqrt(batched_transition_matrix, batched_cov_cholesky):
    """Noise-free :func:`update_sqrt_no_meascov` over a leading batch axis
    (homogeneous shapes): each output stacked along axis 0."""
    return torch.func.vmap(update_sqrt_no_meascov)(batched_transition_matrix,
                                                   batched_cov_cholesky)
