"""Integrated-Wiener-process prior in the point-major Nordsieck layout.

Counterpart of :mod:`pnmol_tpu.ops.iwp`. Means are ``(n, d)`` matrices
(row i = i-th time derivative at every point) and the flat state basis is
point-major, ``x[j * n + i] = M[i, j]``. In that basis the transition is
``kron(I_d, A_1d)``, the preconditioner ``kron(I_d, diag(p))`` and the
derivative projections ``kron(I_d, e_i)``: all three apply as batched small
matmuls, broadcast scales and slices, never as dense ``(D, D)`` products.
"""

import functools
import math

import numpy as np
import torch


def pascal_lower(n: int):
    """Lower-triangular Pascal matrix P[i, j] = C(i, j), exact."""
    return [[math.comb(i, j) if j <= i else 0 for j in range(n)] for i in range(n)]


def hilbert(n: int):
    """Hilbert matrix H[i, j] = 1 / (i + j + 1)."""
    return [[1.0 / (i + j + 1) for j in range(n)] for i in range(n)]


@functools.lru_cache(maxsize=None)
def _system_matrices_1d_host(num_derivatives: int):
    n = num_derivatives + 1
    A = np.ascontiguousarray(np.flip(np.asarray(pascal_lower(n), dtype=np.float64)))
    LQ = np.linalg.cholesky(np.flip(np.asarray(hilbert(n), dtype=np.float64)))
    A.setflags(write=False)
    LQ.setflags(write=False)
    return A, LQ


def system_matrices_1d(num_derivatives: int, *, dtype, device):
    """Preconditioned 1-D transition ``A_1d`` (flipped lower Pascal matrix)
    and noise Cholesky factor ``L_Q1d`` (of the flipped Hilbert matrix)."""
    A, LQ = _system_matrices_1d_host(num_derivatives)
    return (
        torch.tensor(A, dtype=dtype, device=device),
        torch.tensor(LQ, dtype=dtype, device=device),
    )


@functools.lru_cache(maxsize=None)
def _scale_constants(num_derivatives: int, dtype, device):
    """The exponents ``nu + 1/2 - i`` and the factorials ``(nu - i)!`` of
    :func:`nordsieck_scales_1d`, made on ``device`` once."""
    powers = torch.arange(num_derivatives, -1, -1, dtype=dtype, device=device)
    scales = torch.tensor(
        [math.factorial(k) for k in range(num_derivatives, -1, -1)],
        dtype=dtype, device=device,
    )
    return powers + 0.5, scales


def nordsieck_scales_1d(num_derivatives: int, dt, *, dtype, device):
    """Nordsieck preconditioner scales and inverse scales, shape (n,):
    ``p[i] = |dt|^(nu + 1/2 - i) / (nu - i)!``.

    A float ``dt`` copies the factorials and ``dt`` to ``device`` on every
    call. A 0-dim tensor ``dt`` on ``device`` copies nothing: the exponents
    and factorials are made there once, and the same operations give the
    same scales, bit for bit."""
    if torch.is_tensor(dt):
        powers, scales = _scale_constants(num_derivatives, dtype, torch.device(device))
        abs_dt = torch.abs(dt.to(dtype=dtype))
        return abs_dt**powers / scales, abs_dt ** (-powers) * scales
    powers = torch.arange(num_derivatives, -1, -1, dtype=dtype, device=device)
    scales = torch.tensor(
        [math.factorial(k) for k in range(num_derivatives, -1, -1)],
        dtype=dtype, device=device,
    )
    powers = powers + 0.5
    abs_dt = torch.abs(torch.as_tensor(dt, dtype=dtype, device=device))
    return abs_dt**powers / scales, abs_dt ** (-powers) * scales


def apply_stack_matrix(A_1d, X):
    """``kron(I_d, A_1d) @ X`` for X of shape (D,) or (D, K), point-major."""
    n = A_1d.shape[0]
    if X.ndim == 1:
        return (X.reshape(-1, n) @ A_1d.T).reshape(-1)
    K = X.shape[1]
    return torch.einsum("ab,dbk->dak", A_1d, X.reshape(-1, n, K)).reshape(-1, K)


def scale_stack(p, X, out=None):
    """``kron(I_d, diag(p)) @ X`` (p has shape (n,)); for a matrix ``X``,
    written into ``out`` (contiguous, ``X``'s shape; ``X`` itself too) where
    given."""
    n = p.shape[0]
    if X.ndim == 1:
        return (X.reshape(-1, n) * p[None, :]).reshape(-1)
    K = X.shape[1]
    if out is not None:
        torch.mul(X.reshape(-1, n, K), p[None, :, None], out=out.view(-1, n, K))
        return out
    return (X.reshape(-1, n, K) * p[None, :, None]).reshape(-1, K)


def project_derivative(X, i, n):
    """``E_i @ X`` with ``E_i = kron(I_d, e_i)``: shape (d,) or (d, K)."""
    if X.ndim == 1:
        return X.reshape(-1, n)[:, i]
    return X.reshape(-1, n, X.shape[1])[:, i, :]


def point_major_perm(n, d, *, device):
    """Permutation from the derivative-major flat index (k*d + i) to the
    point-major one (i*n + k): ``perm[p] = (p % n) * d + p // n``."""
    idx = torch.arange(n * d, device=device)
    return (idx % n) * d + idx // n


def kron_point_major(A_spatial, B_deriv):
    """``kron(A_spatial, B_deriv)``, assembled as ``kron(B_deriv, A_spatial)``
    and permuted into the point-major basis."""
    d = A_spatial.shape[0]
    n = B_deriv.shape[0]
    big = (B_deriv[:, None, :, None] * A_spatial[None, :, None, :]).reshape(
        n * d, n * d
    )
    perm = point_major_perm(n, d, device=A_spatial.device)
    return big[perm][:, perm]


def mean_to_flat(M):
    """(n, d) mean matrix -> point-major flat vector."""
    return M.T.reshape(-1)


def flat_to_mean(x, n):
    """Point-major flat vector -> (n, d) mean matrix."""
    return x.reshape(-1, n).T


class IntegratedWienerTransition:
    """nu-times integrated Wiener process over ``d`` spatial points, with the
    spatial correlation factor ``wp_diffusion_sqrtm`` (d, d) as the left
    Kronecker factor of the process noise."""

    def __init__(self, *, num_derivatives, wiener_process_dimension,
                 wp_diffusion_sqrtm):
        self.num_derivatives = int(num_derivatives)
        self.wiener_process_dimension = int(wiener_process_dimension)
        self.wp_diffusion_sqrtm = wp_diffusion_sqrtm

    @property
    def n(self):
        return self.num_derivatives + 1

    @property
    def state_dimension(self):
        return self.wiener_process_dimension * self.n

    def _eye(self, size):
        return torch.eye(size, dtype=self.wp_diffusion_sqrtm.dtype,
                         device=self.wp_diffusion_sqrtm.device)

    @functools.cached_property
    def preconditioned_discretize_1d(self):
        return system_matrices_1d(
            self.num_derivatives,
            dtype=self.wp_diffusion_sqrtm.dtype,
            device=self.wp_diffusion_sqrtm.device,
        )

    # -- dense materializations (experiments and parity tests) ---------------

    @functools.cached_property
    def preconditioned_discretize(self):
        """Dense ``(kron(I_d, A_1d), kron(wp_diffusion_sqrtm, L_Q1d))``."""
        A_1d, L_Q1d = self.preconditioned_discretize_1d
        A = kron_point_major(self._eye(self.wiener_process_dimension), A_1d)
        return A, kron_point_major(self.wp_diffusion_sqrtm, L_Q1d)

    def nordsieck_preconditioner_1d_raw(self, dt):
        """The scales ``(p, 1/p)`` of one dimension, shape (n,)."""
        return nordsieck_scales_1d(
            self.num_derivatives, dt, dtype=self.wp_diffusion_sqrtm.dtype,
            device=self.wp_diffusion_sqrtm.device,
        )

    def nordsieck_preconditioner_1d(self, dt):
        """Dense ``(diag(p), diag(1/p))`` of one dimension."""
        p, p_inv = self.nordsieck_preconditioner_1d_raw(dt)
        return torch.diag(p), torch.diag(p_inv)

    def nordsieck_preconditioner(self, dt):
        """Dense ``(kron(I_d, diag(p)), kron(I_d, diag(1/p)))``."""
        p, p_inv = self.nordsieck_preconditioner_1d_raw(dt)
        eye = self._eye(self.wiener_process_dimension)
        return torch.kron(eye, torch.diag(p)), torch.kron(eye, torch.diag(p_inv))

    def non_preconditioned_discretize(self, dt):
        """Dense ``(A(dt), L_Q(dt))`` in the raw (unpreconditioned) coordinates."""
        P, P_inv = self.nordsieck_preconditioner(dt)
        A_pre, LQ_pre = self.preconditioned_discretize
        return P @ A_pre @ P_inv, P @ LQ_pre

    def projection_matrix_1d(self, derivative):
        return self._eye(self.n)[derivative:derivative + 1]

    def projection_matrix(self, derivative):
        """Dense ``E_i = kron(I_d, e_i)``, shape (d, D)."""
        return torch.kron(self._eye(self.wiener_process_dimension),
                          self.projection_matrix_1d(derivative))

    @functools.cached_property
    def process_noise_factor(self):
        """``kron(wp_diffusion_sqrtm, L_Q1d)`` in the point-major basis."""
        _, L_Q1d = self.preconditioned_discretize_1d
        return kron_point_major(self.wp_diffusion_sqrtm, L_Q1d)
