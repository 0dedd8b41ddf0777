"""pnmol_tpu_torch: the PyTorch and CUDA port of pnmol_tpu.

Mirrors the JAX package's module names; the JAX package stays the
reference. The main path: ``heat_1d_discretized`` -> ``LinearWhiteNoiseEK1``
-> ``initialize`` -> a loop of ``white_attempt_step``, with
``factorization="householder"`` running the hand-written CUDA panel kernel
(``csrc/panel_lq.cu``) on the GPU::

    import torch, pnmol_tpu_torch as pt
    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device="cuda")
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(0.1), factorization="householder")
    sol = solver.solve(heat)

The same entry points drive adaptive steps (``steprule=None`` is
``Adaptive()``), the semilinear solvers ``white.SemiLinearWhiteNoiseEK0/EK1``
on Dirichlet and Neumann problems and on the SIR and Lotka-Volterra systems
(prior ``kernels.duplicate(...)``), and the latent-force solvers
``latent.LinearLatentForceEK1`` and ``latent.SemiLinearLatentForceEK0/EK1``.
Two further paths carry the other two kernels: global collocation
(``discretize.collocation_global`` and ``scheme="collocation"``), whose
radial Gram runs ``csrc/gram_radial.cu`` on the GPU at N >= 512, and the
R-form step hook ``ops.qr_householder.make_householder_factorization()``,
whose tall blocked QR runs the panel kernel of ``csrc/panel_lq.cu`` on the
tall layout.

Large meshes (above 2048 points) take their stencils from a native k-NN
(``native/knn.cpp``, built with g++ at first use), and the solvers take
the memory-light two-QR pipeline with ``fused=False`` (and
``propagate_band="banded"`` or ``"interleaved"``). From 4096 points on,
``"householder"`` sweeps 256-row blocks, more than one panel launch takes,
so each block runs the leaf route: one launch of the panel kernel per leaf
of 32 or 64 rows (``ops.qr_householder.leaf_lq``). The N = 1e4 point of
``bench.py`` runs so on one GPU::

    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(1e-3), num_derivatives=1,
        factorization="householder", fused=False, propagate_band="banded")

The method-of-lines baseline of the paper's comparisons converts a
discretized problem to an ODE (``pde.to_ivp()``) and solves it with the
classical EK1 ODE filter ``odetools.ek1.ReferenceEK1ConstantDiffusion``
(initialized by ``odetools.init.TaylorMode``, ``Stack`` or ``RungeKutta``),
against the DP5 and LSODA references of ``odetools.reference_solver``;
``solvers.smoothing.smooth_solution`` smooths a PDE filter's trajectory,
and ``kernels.mle_input_scale`` calibrates a kernel's input scale::

    ivp = heat.to_ivp()
    mol = pt.odetools.ek1.ReferenceEK1ConstantDiffusion(
        num_derivatives=2, steprule=pt.odetools.step.Constant(1e-3),
        initialization=pt.odetools.init.Stack(use_df=False))
    sol, sigma_sq = mol.solve(ivp)

Linear problems at constant steps also run in steady-state mode
(``steady_state=True`` on ``LinearWhiteNoiseEK1`` or
``LinearLatentForceEK1``): ``initialize`` freezes the stationary covariance,
seeded by the doubling solver of ``ops.dare`` and polished through the
step's own factorizations, and each step then updates the mean only.

The n-D problems run through the same solvers: tensor grids in any
dimension (``mesh.RectangularMesh.from_bbox_nd``, with outward boundary
normals), operators from the diffop algebra, the n-D Neumann operator
``discretize.fd_probabilistic_neumann``, and the recipes
``heat_2d_discretized``, ``advection_diffusion_discretized`` and
``fisher_kpp_2d_discretized`` of ``pde.examples``. The 2-D heat on 100 x 100
points runs so on one GPU, with the N = 1e4 solver above.

The space-sharded tier, ``parallel`` (explicit SPMD over
``torch.distributed``: rank meshes with named, counted collectives, the
sharded linear algebra, the distributed initialization, the sharded white
and latent steps and solves, the batched dt sweep), and the comm model of
``utils.comm_model`` run the same solvers across ranks; the backend
(``"nccl"`` or ``"gloo"``) is the caller's.

Every constructor that makes tensors takes ``device=``; nothing picks a
device on its own. This package imports ``torch`` and never ``jax``.
The dtype is float64 unless ``PNMOL_TPU_X32=1`` is set before the import
(or ``config.enable_x64(False)`` is called): then every constructor builds
float32 tensors and the kernels launch their f32 instantiations, the
configuration the JAX package's bench times (:mod:`pnmol_tpu_torch.config`).
"""

from pnmol_tpu_torch import config

config.setup()

from pnmol_tpu_torch import diffops, discretize, kernels, mesh, ops
from pnmol_tpu_torch import models
from pnmol_tpu_torch import models as pde  # alias, as in pnmol_tpu
from pnmol_tpu_torch import interop, odetools, parallel, utils
from pnmol_tpu_torch.kernels import duplicate
from pnmol_tpu_torch.models import examples
from pnmol_tpu_torch.solvers import latent, pdefilter, smoothing, white
from pnmol_tpu_torch.solvers.latent import (
    LinearLatentForceEK1,
    SemiLinearLatentForceEK0,
    SemiLinearLatentForceEK1,
)
from pnmol_tpu_torch.solvers.white import (
    LinearWhiteNoiseEK1,
    SemiLinearWhiteNoiseEK0,
    SemiLinearWhiteNoiseEK1,
)

__all__ = [
    "LinearLatentForceEK1",
    "LinearWhiteNoiseEK1",
    "SemiLinearLatentForceEK0",
    "SemiLinearLatentForceEK1",
    "SemiLinearWhiteNoiseEK0",
    "SemiLinearWhiteNoiseEK1",
    "config",
    "diffops",
    "discretize",
    "duplicate",
    "examples",
    "interop",
    "kernels",
    "latent",
    "mesh",
    "models",
    "odetools",
    "ops",
    "pde",
    "parallel",
    "pdefilter",
    "smoothing",
    "utils",
    "white",
]
