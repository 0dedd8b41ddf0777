"""What the seed draws: the initial condition, and the probe of the check.

The initial condition is a sum of sine modes that vanish on the box,
``y0(x) = sum_k s_k a (1 + j u_k) / |k|^2 prod_i sin(k_i pi (x_i - lo_i) /
(hi_i - lo_i))`` over ``k`` in ``{1..K}^dim``, with signs ``s_k`` and ``u_k``
in [-1, 1] drawn from the seed; ``a``, ``j`` (the jitter) and ``K`` come from
the traffic mix. With ``j = 0`` the seed flips signs only, so every seed has
modes of the same sizes.
"""

import itertools
import math

import numpy as np
import torch


def initial_values(points, bbox, spec, seed):
    """``y0`` (N,) float64 at ``points`` (N, dim)."""
    rng = np.random.default_rng(seed)
    dim = points.shape[1]
    lo = np.array([b[0] for b in bbox], dtype=np.float64)
    width = np.array([b[1] - b[0] for b in bbox], dtype=np.float64)
    unit = (points - lo) / width
    y0 = np.zeros(points.shape[0])
    for k in itertools.product(range(1, spec["modes_per_axis"] + 1), repeat=dim):
        sign = 1.0 if rng.random() < 0.5 else -1.0
        jitter = 1.0 + spec["jitter"] * rng.uniform(-1.0, 1.0)
        size = spec["amplitude"] * jitter / sum(ki**2 for ki in k)
        y0 += sign * size * np.prod(np.sin(math.pi * np.asarray(k) * unit), axis=1)
    return y0


def probe(rows, cols, seed, device):
    """The Gaussian probe ``(rows, cols)`` float64 with which the check
    compares covariances through ``G @ probe``."""
    generator = torch.Generator(device=device).manual_seed(int(seed) % (2**63 - 1))
    return torch.randn((rows, cols), generator=generator, dtype=torch.float64, device=device)
