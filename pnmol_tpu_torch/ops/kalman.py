"""Textbook Kalman filter and smoother steps (counterpart of
:mod:`pnmol_tpu.ops.kalman`).

The single steps of the Runge-Kutta initialization and of the RTS smoother;
the PDE filters take the structured path of :mod:`pnmol_tpu_torch.solvers`.
Covariances travel as lower Cholesky factors and every factorization is
``torch.linalg.qr``, as the JAX package takes XLA's QR here.
"""

import torch

from pnmol_tpu_torch.ops import sqrt


def filter_step(mean, cov_l, transition, proc_noise_l, obs_mat, obs_shift, data):
    """One predict + smoothing-gain + noise-free-update step.

    Returns the updated pair, the smoothing gain for the later backward
    pass, the predicted pair, and the transited factor ``transition @
    cov_l`` (reused by :func:`smoother_step_sqrt`).
    """
    mean_pred = transition @ mean
    transited_l = transition @ cov_l
    cov_l_pred = sqrt.propagate_cholesky_factor(transited_l, proc_noise_l)

    cross_cov = cov_l @ transited_l.T
    smoothing_gain = torch.cholesky_solve(cross_cov.T, cov_l_pred, upper=False).T

    cov_l_new, kalman_gain, _ = sqrt.update_sqrt_no_meascov(obs_mat, cov_l_pred)
    residual = obs_mat @ mean_pred + obs_shift - data
    mean_new = mean_pred - kalman_gain @ residual
    return mean_new, cov_l_new, smoothing_gain, mean_pred, cov_l_pred, transited_l


def smoother_step_traditional(
    mean, cov_l, mean_next, cov_l_next, smoothing_gain, mean_pred, cov_l_pred
):
    """Full-covariance RTS smoother step (the testing oracle): forms the
    dense covariances, then the Cholesky factor of the smoothed one."""
    cov = cov_l @ cov_l.T
    cov_next = cov_l_next @ cov_l_next.T
    cov_pred = cov_l_pred @ cov_l_pred.T

    mean_smoothed = mean + smoothing_gain @ (mean_next - mean_pred)
    cov_smoothed = cov + smoothing_gain @ (cov_next - cov_pred) @ smoothing_gain.T
    return mean_smoothed, torch.linalg.cholesky(cov_smoothed)


def smoother_step_sqrt(
    mean, cov_l, mean_next, cov_l_next, smoothing_gain, proc_noise_l,
    mean_pred, transited_l
):
    """Square-root RTS smoother step: one QR of the 3-block stack
    ``[[X^T, C^T], [Q^T, 0], [0, C_next^T G^T]]`` (X the transited factor,
    G the smoothing gain), whose middle block-row holds the smoothed factor."""
    mean_smoothed = mean - smoothing_gain @ (mean_pred - mean_next)

    n = mean.shape[0]
    zeros = cov_l.new_zeros((n, n))
    stacked = torch.cat(
        (
            torch.cat((transited_l.T, cov_l.T), dim=1),
            torch.cat((proc_noise_l.T, zeros), dim=1),
            torch.cat((zeros, cov_l_next.T @ smoothing_gain.T), dim=1),
        ),
        dim=0,
    )
    triangular = sqrt.triu_qr(stacked)
    return mean_smoothed, triangular[n:2 * n, n:].T
