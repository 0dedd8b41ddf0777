"""The spatial prior Gram and the integrated Wiener process in time.

The state of ``d`` points and ``nu`` time derivatives is derivative-major,
``[u; u'; ...; u^(nu)]``. Over a step ``h`` the nu-times integrated Wiener
process has the transition ``A(h)[i, j] = h^(j-i) / (j-i)!`` (``j >= i``) and
the noise ``Q(h)[i, j] = h^(2nu+1-i-j) / ((2nu+1-i-j) (nu-i)! (nu-j)!)``, each
Kronecker with the spatial Gram on the noise. The Nordsieck scaling
``p_i = h^(nu+1/2-i) / (nu-i)!`` takes both to ``h``-free matrices, in which
the filter computes.
"""

import math

import torch


def matern52_plus_white(points):
    """Gram of ``Matern52() + WhiteNoise()`` at unit scales on distinct points:
    ``(1 + a + a^2 / 3) exp(-a)`` with ``a = sqrt(5) |x - y|``, plus I."""
    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    a = torch.sqrt(5.0 * d2)
    gram = (1.0 + a + a**2 / 3.0) * torch.exp(-a)
    return gram + torch.eye(points.shape[0], dtype=points.dtype, device=points.device)


def iwp(nu, h):
    """``(A(h), Q(h))`` of the nu-times integrated Wiener process, (n, n)."""
    n = nu + 1
    A = torch.zeros((n, n), dtype=torch.float64)
    Q = torch.zeros((n, n), dtype=torch.float64)
    for i in range(n):
        for j in range(n):
            if j >= i:
                A[i, j] = h ** (j - i) / math.factorial(j - i)
            e = 2 * nu + 1 - i - j
            Q[i, j] = h**e / (e * math.factorial(nu - i) * math.factorial(nu - j))
    return A, Q


def nordsieck(nu, h):
    """The scales ``p`` (n,) of the Nordsieck preconditioner at step ``h``."""
    return torch.tensor([abs(h) ** (nu + 0.5 - i) / math.factorial(nu - i)
                         for i in range(nu + 1)], dtype=torch.float64)


def preconditioned(nu, h):
    """``(A_pre, chol(Q_pre))`` with ``A_pre = P^-1 A(h) P`` and
    ``Q_pre = P^-1 Q(h) P^-1``."""
    A, Q = iwp(nu, h)
    p = nordsieck(nu, h)
    A_pre = A * p[None, :] / p[:, None]
    Q_pre = Q / p[:, None] / p[None, :]
    return A_pre, torch.linalg.cholesky(0.5 * (Q_pre + Q_pre.T))
