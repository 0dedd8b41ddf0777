"""Square-root Kalman factors through ``torch.linalg.qr``.

Counterpart of the propagate and the block-returning functions of
:mod:`pnmol_tpu.ops.sqrt`: the plain pipeline that the Householder-LQ kernel
path (:mod:`pnmol_tpu_torch.ops.qr_householder`) is held against. One QR of
the stacked pre-array gives an upper factor whose blocks are the innovation
factor, the cross factor and the posterior factor; the update functions
return them transposed to lower form, ``(posterior (D, D), L21 (D, m), L1
(m, m))`` with ``S_xz = L21 L1^T``.
"""

import torch


def triu_qr(mat):
    """Upper triangular factor of a QR decomposition, shape (min(M,N), N)."""
    return torch.linalg.qr(mat, mode="r")[1]


def propagate_cholesky_factor(S1, S2):
    """Lower factor of ``S1 S1^T + S2 S2^T`` from one QR of the stacked
    roots ``[S1^T; S2^T]`` (the two-QR pipeline's plain propagate)."""
    return triu_qr(torch.cat((S1.T, S2.T), dim=0)).T


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
