"""Probabilistic finite differences of ``rate * Laplace(u)`` on a tensor grid
with Dirichlet boundaries, from the squared-exponential kernel in closed form.

For each point ``x`` with stencil points ``X`` (its ``k`` nearest grid
points) the weights solve ``(K(X, X) + nugget I) w = (Lap_x k)(x, X)`` and the
stencil's error is ``(Lap_x Lap_y k)(x, x) - w . (Lap_x k)(x, X)``. ``L`` holds
``rate * w`` in the point's row, ``E_sqrtm`` holds ``rate * error`` on its
diagonal (the factor of the discretization-error covariance, with the
convention of the PNMOL papers' code), ``B`` selects the boundary points and
``R_sqrtm`` is zero: Dirichlet values are exact measurements.
"""

import numpy as np
import torch


def grid(bbox, num_points):
    """Tensor-grid points (N, dim), float64, in ``meshgrid(..., "ij")`` order."""
    axes = [np.linspace(lo, hi, num=n) for (lo, hi), n in zip(bbox, num_points)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in mesh], axis=-1)


def boundary_mask(points, bbox):
    """Points on a face of the box."""
    lo = np.array([b[0] for b in bbox], dtype=np.float64)
    hi = np.array([b[1] for b in bbox], dtype=np.float64)
    return ((points == lo) | (points == hi)).any(axis=1)


def nearest(points, queries, k, chunk=512):
    """The ``k`` nearest points of each query by squared distance.

    Returns ``(candidates, closer)``: for each query the indices whose
    squared distance is at most the ``k``-th smallest (more than ``k`` where
    the ``k``-th distance ties), and how many of them lie strictly closer
    than the ``k``-th distance. A stencil is any ``k`` of the candidates that
    holds all the strictly closer ones."""
    candidates, closer = [], []
    for start in range(0, queries.shape[0], chunk):
        q = queries[start:start + chunk]
        d2 = ((q[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        kth = np.partition(d2, k - 1, axis=1)[:, k - 1]
        for row, limit in zip(d2, kth):
            idx = np.nonzero(row <= limit)[0]
            candidates.append(idx[np.lexsort((idx, row[idx]))])
            closer.append(int((row[idx] < limit).sum()))
    return candidates, closer


def stencils(points, mask, size_interior, size_boundary):
    """Stencil of every point: ``(stencil, tied)`` where ``stencil[i]`` is an
    index array of the point's nearest neighbours, or None where the
    ``k``-th nearest distance ties and the stencil is not determined by its
    definition; ``tied[i]`` holds the candidates and the number strictly
    closer for those points."""
    n = points.shape[0]
    stencil, tied = [None] * n, {}
    for where, k in ((~mask, size_interior), (mask, size_boundary)):
        rows = np.nonzero(where)[0]
        candidates, closer = nearest(points, points[rows], k)
        for i, cand, c in zip(rows, candidates, closer):
            if cand.shape[0] == k:
                stencil[i] = cand
            else:
                tied[int(i)] = (cand, c, k)
    return stencil, tied


def resolve_ties(stencil, tied, choices):
    """Fill the tied stencils with ``choices[i]`` (index arrays) where each
    is a valid choice: ``k`` distinct candidates holding every strictly
    closer one. Returns the rows whose choice is not valid."""
    invalid = []
    for i, (cand, closer, k) in tied.items():
        choice = np.unique(np.asarray(choices.get(i, []), dtype=np.int64))
        if (choice.shape[0] != k or not np.isin(choice, cand).all()
                or not np.isin(cand[:closer], choice).all()):
            invalid.append(i)
            stencil[i] = cand[:k]
        else:
            stencil[i] = choice
    return invalid


def _se_laplace(r2, s, dim):
    """``Lap_x k`` of ``k = exp(-s^2 |x - y|^2 / 2)`` at squared distance ``r2``."""
    return torch.exp(-0.5 * s**2 * r2) * (s**4 * r2 - dim * s**2)


def fd_operators(points, mask, stencil, *, input_scale, rate, nugget, device):
    """``(L, E_sqrtm, B, R_sqrtm)`` as float64 tensors on ``device``."""
    n, dim = points.shape
    s = float(input_scale)
    P = torch.tensor(points, dtype=torch.float64, device=device)
    L = torch.zeros((n, n), dtype=torch.float64, device=device)
    err = torch.zeros(n, dtype=torch.float64, device=device)
    sizes = sorted({len(st) for st in stencil})
    for k in sizes:
        rows = np.array([i for i, st in enumerate(stencil) if len(st) == k], dtype=np.int64)
        cols = torch.tensor(np.stack([stencil[i] for i in rows]), device=device)
        rows_t = torch.tensor(rows, device=device)
        X = P[cols]  # (q, k, dim)
        x = P[rows_t][:, None, :]
        d_xx = ((X[:, :, None, :] - X[:, None, :, :]) ** 2).sum(-1)
        gram = torch.exp(-0.5 * s**2 * d_xx)
        gram = gram + nugget * torch.eye(k, dtype=torch.float64, device=device)
        lk = _se_laplace(((x - X) ** 2).sum(-1), s, dim)  # (q, k)
        w = torch.cholesky_solve(lk[:, :, None], torch.linalg.cholesky(gram))[:, :, 0]
        llk = s**4 * (dim**2 + 2 * dim)
        L[rows_t[:, None], cols] = rate * w
        err[rows_t] = rate * (llk - (w * lk).sum(-1))
    b_idx = torch.tensor(np.nonzero(mask)[0], device=device)
    B = torch.eye(n, dtype=torch.float64, device=device)[b_idx]
    R = torch.zeros((b_idx.shape[0],) * 2, dtype=torch.float64, device=device)
    return L, torch.diag(err), B, R
