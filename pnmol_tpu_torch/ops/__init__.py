"""Numerical layer: random variables, IWP prior, square-root Kalman blocks
and the Householder-LQ factorization with its CUDA panel kernel."""

from pnmol_tpu_torch.ops import iwp, qr_householder, rv, sqrt

__all__ = ["iwp", "qr_householder", "rv", "sqrt"]
