"""Gaussian random-variable container (counterpart of :mod:`pnmol_tpu.ops.rv`).

A mean and a covariance square root; the full covariance is only formed on
demand.
"""

from typing import NamedTuple

import torch


class MultivariateNormal(NamedTuple):
    """Multivariate normal with square-root (Cholesky) covariance storage."""

    mean: torch.Tensor
    cov_sqrtm: torch.Tensor

    @property
    def cov(self) -> torch.Tensor:
        return self.cov_sqrtm @ self.cov_sqrtm.T
