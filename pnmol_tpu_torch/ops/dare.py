"""Doubling solver for the discrete algebraic Riccati equation (DARE).

Counterpart of :mod:`pnmol_tpu.ops.dare`. Steady-state mode freezes the
fixed point of the covariance half of the Kalman recursion; iterating that
recursion converges only at the closed loop's own mixing rate, ``O(1/dt)``
iterations. The structure-preserving doubling algorithm (SDA; Chu, Fan &
Lin, 2005) squares the symplectic matrix of the one-step Riccati map each
iteration, so iteration ``k`` represents ``2^k`` steps and convergence is
quadratic.

Form solved (the filter DARE, predicted covariance)::

    Sigma = A Sigma (I + G Sigma)^{-1} A^T + Q,      G = H^T R^{-1} H.

SDA iterates ``(A_k, G_k, H_k)`` of the ``2^k``-step map with ``A_0 = A^T``,
``G_0 = G``, ``H_0 = Q``; ``H_k -> Sigma`` and ``A_k -> 0``. Every solve
against ``W = I + G_k H_k`` shares one factorization of ``W``: its QR below
``D = 4096``, and from there the Cholesky (Woodbury) form, whose working set
holds fewer ``(D, D)`` buffers. The iteration is one Python loop of cuBLAS
and cuSOLVER calls.
"""

from typing import NamedTuple

import torch

# from this state dimension on the doubling takes the Cholesky body
CHOL_MIN_SIZE = 4096


class SDAResult(NamedTuple):
    """Fixed point and diagnostics of one SDA run."""

    sigma: torch.Tensor  # (D, D) predicted-covariance fixed point
    iterations: int  # doubling iterations taken
    delta: float  # last relative max-abs change of H_k
    anorm: float  # max-abs of the final A_k (-> 0 quadratically)


def _qr_solve(W, *rhs):
    """Solve ``W x = b`` for each right-hand side through one shared QR of
    ``W`` (``W = I + G H`` with G, H PSD has eigenvalues >= 1)."""
    Qm, Rm = torch.linalg.qr(W)
    return tuple(torch.linalg.solve_triangular(Rm, Qm.T @ b, upper=True) for b in rhs)


def _symmetrized(X):
    return (X + X.T).mul_(0.5)


def _rel_change(new, old):
    tiny = torch.finfo(new.dtype).tiny
    return ((new - old).abs().max() / (new.abs().max() + tiny)).item()


def _chol_half_projector(Gk, Hk):
    """``Y = Lm^{-1} C^T`` with ``H = C C^T`` and ``I + C^T G C = Lm Lm^T``,
    so that ``W^{-1} B = B - G Y^T (Y B)`` for every right-hand side. ``H_k``
    is PD along the iteration; a relative eps jitter guards the factor."""
    jit_eps = 16.0 * torch.finfo(Hk.dtype).eps * Hk.abs().max()
    shifted = Hk.clone()
    shifted.diagonal().add_(jit_eps)
    C = torch.linalg.cholesky(shifted)
    del shifted
    M = C.T @ (Gk @ C)
    M.diagonal().add_(1.0)
    Lm = torch.linalg.cholesky(_symmetrized(M))
    del M
    return torch.linalg.solve_triangular(Lm, C.T, upper=False)


def _sda_step(Ak, Gk, Hk, solver):
    """One doubling: ``(A_k, G_k, H_k) -> (A_{k+1}, G_{k+1}, H_{k+1})``."""
    if solver == "chol":
        Y = _chol_half_projector(Gk, Hk)
        WinvA = torch.addmm(Ak, Gk, Y.T @ (Y @ Ak), alpha=-1)
        t2 = Hk @ WinvA
        A_new = Ak @ WinvA
        del WinvA
        H_new = torch.addmm(Hk, Ak.T, t2)
        del t2
        WinvG = torch.addmm(Gk, Gk, Y.T @ (Y @ Gk), alpha=-1)
        del Y
    else:
        W = Gk @ Hk
        W.diagonal().add_(1.0)
        WinvA, WinvG = _qr_solve(W, Ak, Gk)
        del W
        A_new = Ak @ WinvA
        H_new = torch.addmm(Hk, Ak.T, Hk @ WinvA)
        del WinvA
    G_new = torch.addmm(Gk, Ak, WinvG @ Ak.T)
    del WinvG
    # the exact iterates are symmetric; rounding asymmetry compounds through
    # the quadratic composition, so re-symmetrize each step
    return A_new, _symmetrized(G_new), _symmetrized(H_new)


def sda(A, G, Q, *, tol=1e-12, max_iters=64, solver=None):
    """Solve ``Sigma = A Sigma (I + G Sigma)^{-1} A^T + Q`` by doubling.

    ``A`` (D, D) transition, ``G = H^T R^{-1} H`` (D, D) PSD information
    matrix, ``Q`` (D, D) PSD process noise; the inputs are never written.
    Returns :class:`SDAResult`, whose ``sigma`` is the PREDICTED-covariance
    fixed point. Iterates while ``it < 1 or delta >= tol`` (``delta`` the
    relative max-abs change of the iterate), at most ``max_iters`` times.
    ``solver`` is ``"qr"`` or ``"chol"``; by default ``"chol"`` from
    ``D = 4096`` on (:data:`CHOL_MIN_SIZE`), ``"qr"`` below.
    """
    dtype = Q.dtype
    if solver is None:
        solver = "chol" if Q.shape[0] >= CHOL_MIN_SIZE else "qr"
    Ak, Gk, Hk = A.T.to(dtype).contiguous(), G.to(dtype), Q
    del A, G, Q
    it, delta = 0, float("inf")
    while it < max_iters and (it < 1 or delta >= tol):
        A_new, G_new, H_new = _sda_step(Ak, Gk, Hk, solver)
        delta = _rel_change(H_new, Hk)
        Ak, Gk, Hk = A_new, G_new, H_new
        del A_new, G_new, H_new
        it += 1
    return SDAResult(sigma=Hk, iterations=it, delta=delta, anorm=Ak.abs().max().item())


def dare_residual(sigma, A, G, Q):
    """Relative max-abs residual of the DARE at ``sigma``:
    ``||Sigma - (A Sigma (I + G Sigma)^{-1} A^T + Q)||_max / ||Sigma||_max``,
    a certificate independent of the iteration's own delta."""
    eye = torch.eye(Q.shape[0], dtype=Q.dtype, device=Q.device)
    # Sigma (I + G Sigma)^{-1} = (I + Sigma G)^{-1} Sigma (push-through; the
    # two factors do not commute, so the solve is on the left)
    (X,) = _qr_solve(eye + sigma @ G, sigma)
    F = A @ (X @ A.T) + Q
    tiny = torch.finfo(Q.dtype).tiny
    return (sigma - F).abs().max() / (sigma.abs().max() + tiny)


def closed_loop_growth(apply_T, v0, num_iters=256, operands=None):
    """Spectral-radius estimate of the frozen closed loop by power iteration
    on the matvec ``apply_T(v)`` (or ``apply_T(operands, v)``), renormalized
    each step: the geometric mean of the step norms. ``rho < 1`` certifies
    that the mean-only recursion ``T = (I - K H) A`` is stable, whatever the
    convergence delta that produced the gain."""
    tiny = torch.finfo(v0.dtype).tiny
    v = v0 / torch.linalg.vector_norm(v0)
    log_acc = v0.new_zeros(())
    for _ in range(num_iters):
        w = apply_T(v) if operands is None else apply_T(operands, v)
        nrm = torch.linalg.vector_norm(w)
        v = w / (nrm + tiny)
        log_acc = log_acc + torch.log(nrm)
    return torch.exp(log_acc / num_iters)
