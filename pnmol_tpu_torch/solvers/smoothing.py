"""Square-root RTS smoothing over PDE-filter trajectories (counterpart of
:mod:`pnmol_tpu.solvers.smoothing`).

Per backward step, in the step's preconditioned coordinates (so dt may
vary)::

    x      = A @ Cl_k                      (structured batched matmul)
    scp    = chol(x x' + Ql Ql')           (QR)
    sgain  = Cl_k Cl_k' A' (scp scp')^{-1} (Cholesky solve)
    smooth = sqrt-RTS step                 (3-block QR, ops.kalman)

Where the JAX package runs a reverse ``lax.scan``, this runs a Python loop
from step K-1 down to 0. Everything is recomputed from the filtered means
and factors, so filtering stores nothing extra.
"""

import dataclasses

import torch

from pnmol_tpu_torch.ops import iwp, kalman, sqrt


def smooth_trajectory(*, A1d, Ql, num_derivatives, means, cov_sqrtms, dts):
    """Square-root RTS smoother over a filtered trajectory.

    ``A1d`` and ``Ql`` are the prior's preconditioned 1-D transition and
    full process-noise factor (``solver._cache.A1d`` and ``.Ql``); ``means``
    (K+1, n, d) and ``cov_sqrtms`` (K+1, D, D) the filtered trajectory with
    its initial state; ``dts`` the K step sizes. Returns the smoothed
    ``(means, cov_sqrtms)`` of the same shapes.
    """
    n = num_derivatives + 1
    m_fut, c_fut = means[-1], cov_sqrtms[-1]  # smoothed at k+1, raw coordinates
    out_means, out_covs = [m_fut], [c_fut]
    for k in range(len(dts) - 1, -1, -1):
        m_k, c_k = means[k], cov_sqrtms[k]
        p, p_inv = iwp.nordsieck_scales_1d(num_derivatives, dts[k], dtype=m_k.dtype,
                                           device=m_k.device)

        # filtered state k and smoothed state k+1 in preconditioned coordinates
        m_prec = iwp.mean_to_flat(m_k * p_inv[:, None])
        cl = iwp.scale_stack(p_inv, c_k)
        m_fut_prec = iwp.mean_to_flat(m_fut * p_inv[:, None])
        c_fut_prec = iwp.scale_stack(p_inv, c_fut)

        # prediction k -> k+1 and smoothing gain
        mp = iwp.apply_stack_matrix(A1d, m_prec)
        x = iwp.apply_stack_matrix(A1d, cl)
        scp = sqrt.propagate_cholesky_factor(x, Ql)
        cross = cl @ x.T
        sgain = torch.cholesky_solve(cross.T, scp, upper=False).T

        m_s, c_s = kalman.smoother_step_sqrt(
            mean=m_prec,
            cov_l=cl,
            mean_next=m_fut_prec,
            cov_l_next=c_fut_prec,
            smoothing_gain=sgain,
            proc_noise_l=Ql,
            mean_pred=mp,
            transited_l=x,
        )

        # back to raw coordinates
        m_fut = iwp.flat_to_mean(m_s, n) * p[:, None]
        c_fut = iwp.scale_stack(p, c_s)
        out_means.append(m_fut)
        out_covs.append(c_fut)
    return torch.stack(out_means[::-1]), torch.stack(out_covs[::-1])


def smooth_solution(solver, solution):
    """Smooth a ``PDESolution`` that ``solver.solve`` produced (white or
    latent); returns a new ``PDESolution`` with the smoothed means and
    factors."""
    means, covs = smooth_trajectory(
        A1d=solver._cache.A1d,
        Ql=solver._cache.Ql,
        num_derivatives=solver.num_derivatives,
        means=solution.mean,
        cov_sqrtms=solution.cov_sqrtm,
        dts=torch.diff(solution.t),
    )
    return dataclasses.replace(solution, mean=means, cov_sqrtm=covs)
