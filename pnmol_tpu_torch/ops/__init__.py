"""Numerical layer: random variables, IWP prior, square-root Kalman blocks
and the textbook Kalman steps, the Householder factorizations with their
CUDA kernels, and the radial Gram with its CUDA kernel (all kernels built
by :mod:`.cuda_build`), the stacked state space of the latent-force
solvers, and the doubling (SDA) solver of the steady-state DARE."""

from pnmol_tpu_torch.ops import (
    cuda_build, dare, gram, iwp, kalman, qr_householder, rv, sqrt, stacked_ssm,
)

__all__ = ["cuda_build", "dare", "gram", "iwp", "kalman", "qr_householder", "rv", "sqrt",
           "stacked_ssm"]
