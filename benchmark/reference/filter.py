"""The square-root white-noise EK1 for ``u' = L u`` with boundary rows ``B u = 0``.

The filter observes ``u' - L u = 0`` with noise factor ``E_sqrtm`` and
``B u = 0`` with noise factor ``R_sqrtm``, in the dtype of ``L`` (float64 in
the check) and the derivative-major layout of :mod:`.prior`. States are ``(mean (n, d), factor (D, D))`` with
``D = n d`` in raw (unscaled) coordinates; the covariance is ``factor
factor^T``.

* Initialization: the prior ``N(0, s^2 I_n kron G)`` observes ``u = y0`` with
  noise ``nugget^2 I``, then ``u' - L u = 0`` and ``B u = 0`` with noise factor
  ``blockdiag(E_sqrtm, R_sqrtm) + nugget I``, by one square-root update.
* A step of size ``h``: predict with the integrated Wiener process and update
  on the PDE rows, in one QR of the stacked square roots (Nordsieck-scaled);
  the local diffusion is the whitened residual's mean square, the error
  estimate ``h sqrt(diag(S)) sigma`` with ``S = H Q H^T + R R^T`` (in
  square-root form) and ``sigma^2`` the residual's mean square under ``S``.
* The step-size controller accepts a step when the RMS of ``h * error /
  (abstol + reltol |u_new|)`` is below 1 and scales the step by
  ``clamp(safety * (1 / scaled)^(1 / (nu + 1)), low, high)``; the first step
  is ``0.01 |y0| / |L y0|``.
"""

import math

import torch

from . import prior


class Problem:
    """The discretized linear PDE and its prior, on one device, in the dtype of ``L``."""

    def __init__(self, L, E_sqrtm, B, R_sqrtm, gram, *, nu, diffuse_scale, nugget):
        self.L, self.E_sqrtm, self.B, self.R_sqrtm = L, E_sqrtm, B, R_sqrtm
        self.d, self.b = L.shape[0], B.shape[0]
        self.m = self.d + self.b
        self.nu, self.n = nu, nu + 1
        self.D = self.n * self.d
        self.gram = gram
        self.chol_gram = torch.linalg.cholesky(gram)
        self.scale = float(diffuse_scale)
        self.nugget = float(nugget)
        self.noise = torch.block_diag(E_sqrtm, R_sqrtm)
        self._blocks = {}

    def _like(self, values):
        return values.to(device=self.L.device, dtype=self.L.dtype)

    def step_blocks(self, h):
        """``(p, A_pre, Q_pre factor (D, D))`` of the step ``h``."""
        if h not in self._blocks:
            self._blocks.clear()
            A_pre, LQ = prior.preconditioned(self.nu, h)
            self._blocks[h] = (self._like(prior.nordsieck(self.nu, h)), self._like(A_pre),
                               torch.kron(self._like(LQ), self.chol_gram))
        return self._blocks[h]

    def derivative(self, X, i):
        return X[i * self.d:(i + 1) * self.d]

    def measure(self, X, p):
        """``H X`` for the scaled state: rows ``p1 X_1 - L p0 X_0`` and
        ``p0 B X_0``."""
        X0 = p[0] * self.derivative(X, 0)
        return torch.cat((p[1] * self.derivative(X, 1) - self.L @ X0, self.B @ X0))


def _sqrt_update(HC, C, noise):
    """Blocks ``(L1 (m, m), L21 (D, m), L3 (D, D))`` of the lower factor of
    ``[[HC, noise], [C, 0]] [[HC, noise], [C, 0]]^T``, from one QR."""
    m, D = HC.shape
    top = torch.cat((HC.T, C.T), dim=1)
    bottom = torch.cat((noise.T, HC.new_zeros((m, D))), dim=1)
    R = torch.linalg.qr(torch.cat((top, bottom)), mode="r")[1]
    return R[:m, :m].T, R[:m, m:].T, R[m:, m:].T


def initialize(problem, y0):
    """The initial ``(mean (n, d), factor (D, D))``."""
    P = problem
    s2 = P.scale**2
    prior_u = s2 * P.gram
    S = prior_u + P.nugget**2 * torch.eye(P.d, dtype=y0.dtype, device=y0.device)
    S_chol = torch.linalg.cholesky(S)
    u0 = prior_u @ torch.cholesky_solve(y0[:, None], S_chol)[:, 0]
    # the posterior of u: prior - prior S^-1 prior = nugget^2 prior S^-1
    post_u = P.nugget**2 * torch.cholesky_solve(prior_u, S_chol).T
    C = torch.block_diag(torch.linalg.cholesky(0.5 * (post_u + post_u.T)),
                         *([P.scale * P.chol_gram] * P.nu))
    mean = torch.zeros((P.n, P.d), dtype=y0.dtype, device=y0.device)
    mean[0] = u0
    ones = torch.ones(P.n, dtype=y0.dtype, device=y0.device)
    HC = P.measure(C, ones)
    z = P.measure(mean.reshape(-1), ones)
    noise = P.noise + P.nugget * torch.eye(P.m, dtype=y0.dtype, device=y0.device)
    L1, L21, L3 = _sqrt_update(HC, C, noise)
    w = torch.linalg.solve_triangular(L1, z[:, None], upper=False)[:, 0]
    return (mean.reshape(-1) - L21 @ w).reshape(P.n, P.d), L3


def step(problem, mean, factor, h):
    """One step: ``(mean, factor, error (d,), |u| (d,), local diffusion)``."""
    P = problem
    p, A_pre, Qs = P.step_blocks(h)
    rows = p.repeat_interleave(P.d)
    M = A_pre @ (mean / p[:, None])
    AC = (A_pre @ (factor / rows[:, None]).reshape(P.n, P.d * P.D)).reshape(P.D, P.D)
    z = P.measure(M.reshape(-1), p)
    HQ = P.measure(Qs, p)
    # S = H Q H^T + R R^T in square-root form: its lower factor from one QR
    S_factor = torch.linalg.qr(torch.cat((HQ, P.noise), dim=1).T, mode="r")[1].T
    white = torch.linalg.solve_triangular(S_factor, z[:, None], upper=False)[:, 0]
    del S_factor
    S_diag = (HQ**2).sum(1) + (P.noise**2).sum(1)
    error = h * torch.sqrt(S_diag)[:P.d] * torch.sqrt(white @ white / P.m)
    HAC = P.measure(AC, p)
    top = torch.cat((HAC.T, AC.T), dim=1)
    del HAC, AC
    mid = torch.cat((HQ.T, Qs.T), dim=1)
    del HQ
    bottom = torch.cat((P.noise.T, P.noise.new_zeros((P.m, P.D))), dim=1)
    R = torch.linalg.qr(torch.cat((top, mid, bottom)), mode="r")[1]
    del top, mid, bottom
    L1, L21 = R[:P.m, :P.m].T, R[:P.m, P.m:].T
    w = torch.linalg.solve_triangular(L1, z[:, None], upper=False)[:, 0]
    new_mean = (M.reshape(-1) - L21 @ w).reshape(P.n, P.d) * p[:, None]
    new_factor = R[P.m:, P.m:].T * rows[:, None]
    return new_mean, new_factor, error, new_mean[0].abs(), w @ w / P.m


def constant_steps(problem, mean, factor, h, num_steps):
    """``num_steps`` steps of ``h``: the list of ``(mean, factor, local
    diffusion)`` after each."""
    out = []
    for _ in range(num_steps):
        mean, factor, _, _, diffusion = step(problem, mean, factor, h)
        out.append((mean, factor, diffusion))
    return out


def adaptive_solve(problem, mean, factor, y0, *, t0, tmax, abstol, reltol,
                   safety=0.95, changes=(0.2, 10.0)):
    """An adaptive solve from ``t0`` to ``tmax``. Returns the final mean and
    factor, the accepted times, the attempts of each accepted step and the
    local diffusions of the accepted steps."""
    P = problem
    h = float(0.01 * torch.linalg.norm(y0) / torch.linalg.norm(P.L @ y0))
    t, times, attempts, diffusions = float(t0), [], [], []
    eps = 1e-12 * max(1.0, abs(tmax))
    while tmax - t > eps:
        tries = 0
        while True:
            new_mean, new_factor, error, ref, diffusion = step(P, mean, factor, h)
            ratio = h * error / (abstol + reltol * ref)
            scaled = float(torch.linalg.norm(ratio)) / math.sqrt(ratio.numel())
            tries += 1
            accepted = scaled < 1.0
            change = min(max(safety * (1.0 / scaled) ** (1.0 / P.n), changes[0]), changes[1])
            if accepted:
                t, mean, factor = t + h, new_mean, new_factor
            h = min(change * h, tmax - t)
            if accepted:
                break
            if not math.isfinite(h):
                raise FloatingPointError(f"reference adaptive solve diverged at t={t}")
        times.append(t)
        attempts.append(tries)
        diffusions.append(diffusion)
    return mean, factor, times, attempts, diffusions
