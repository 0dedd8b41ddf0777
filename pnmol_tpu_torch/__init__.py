"""pnmol_tpu_torch: the PyTorch and CUDA port of pnmol_tpu.

Mirrors the JAX package's module names; the JAX package stays the
reference. This slice carries the main path: ``heat_1d_discretized`` ->
``LinearWhiteNoiseEK1`` with constant steps -> ``initialize`` -> a loop of
``white_attempt_step``, with ``factorization="householder"`` running the
hand-written CUDA panel kernel (``csrc/panel_lq.cu``) on the GPU::

    import torch, pnmol_tpu_torch as pt
    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device="cuda")
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(0.1), factorization="householder")
    sol = solver.solve(heat)

Two further paths carry the other two kernels: global collocation
(``discretize.collocation_global`` and ``scheme="collocation"``), whose
radial Gram runs ``csrc/gram_radial.cu`` on the GPU at N >= 512, and the
R-form step hook ``ops.qr_householder.make_householder_factorization()``,
whose tall blocked QR runs ``csrc/leaf_qr.cu``.

Every constructor that makes tensors takes ``device=``; nothing picks a
device on its own. This package imports ``torch`` and never ``jax``.
"""

from pnmol_tpu_torch import config, diffops, discretize, kernels, mesh, ops
from pnmol_tpu_torch import models
from pnmol_tpu_torch import models as pde  # alias, as in pnmol_tpu
from pnmol_tpu_torch import interop, odetools
from pnmol_tpu_torch.solvers import latent, pdefilter, white

__all__ = [
    "config",
    "diffops",
    "discretize",
    "interop",
    "kernels",
    "latent",
    "mesh",
    "models",
    "odetools",
    "ops",
    "pde",
    "pdefilter",
    "white",
]
