"""Build the port's objects from NumPy arrays.

Hands a problem, a white- or latent-solver cache, a steady-state cache, a
PDE- or ODE-filter state, or a rank's block of a sharded array that another
implementation (for example the JAX package, converted with ``np.asarray``)
produced to the port, so that both run from the same numbers. Takes NumPy
arrays only; float32 and float64 arrays land at their own dtype on
``device`` (the mesh points at the problem's), anything else at the
policy's (:func:`pnmol_tpu_torch.config.default_dtype`).
"""

import numpy as np
import torch

from pnmol_tpu_torch import config, mesh
from pnmol_tpu_torch.models import problems
from pnmol_tpu_torch.odetools import ek1
from pnmol_tpu_torch.ops import rv
from pnmol_tpu_torch.solvers import latent, pdefilter, white


def _tensor(array, device):
    """A tensor on ``device`` at the array's own dtype where that is float32
    or float64 (so that f32 arrays of the f32 policy stay f32), else at the
    policy's."""
    array = np.asarray(array)
    dtype = _FLOAT_DTYPES.get(array.dtype, config.default_dtype())
    return torch.tensor(array, dtype=dtype, device=device)


_FLOAT_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def discretized_problem(*, L, E_sqrtm, B, R_sqrtm, y0, points, t0, tmax, device,
                        boundary="dirichlet", f=None, df=None):
    """A discretized problem from its arrays: ``L`` and ``E_sqrtm`` (d, d),
    ``B`` (b, d), ``R_sqrtm`` (b, b), ``y0`` (d,) and the mesh points
    (N, dim). ``boundary`` is ``"dirichlet"`` or ``"neumann"``; with torch
    callables ``f(t, x)`` and ``df(t, x)`` the problem is semilinear (a
    system when d is a multiple of N). The problem's bounding box is the
    points': (dim, 2) for n-D points, so ``dimension`` is 2 as for the n-D
    recipes, and ``[min, max]`` for 1-D points."""
    classes = {
        (False, "dirichlet"): problems.LinearEvolutionDirichlet,
        (False, "neumann"): problems.LinearEvolutionNeumann,
        (True, "dirichlet"): problems.SemiLinearEvolutionDirichlet,
        (True, "neumann"): problems.SemiLinearEvolutionNeumann,
    }
    semilinear = f is not None
    if (semilinear, boundary) not in classes:
        raise ValueError(f"Unknown boundary condition: {boundary!r}")
    extra = dict(f=f, df=df, df_diagonal=None) if semilinear else {}
    bbox = mesh.read_bbox(points)
    pde = classes[semilinear, boundary](
        diffop=None, diffop_scale=1.0, bbox=bbox[0] if bbox.shape[0] == 1 else bbox,
        t0=t0, tmax=tmax, y0_fun=None, **extra,
    )
    pde.L = _tensor(L, device)
    pde.mesh_spatial = mesh.RectangularMesh(np.asarray(points), device=device,
                                            dtype=pde.L.dtype)
    pde.E_sqrtm = _tensor(E_sqrtm, device)
    pde.B = _tensor(B, device)
    pde.R_sqrtm = _tensor(R_sqrtm, device)
    pde.y0 = _tensor(y0, device)
    return pde


def white_cache(*, A1d, Ql, L, B, E_bc_sqrtm, device):
    """A :class:`pnmol_tpu_torch.solvers.white.WhiteSolverCache`."""
    return white.WhiteSolverCache(
        A1d=_tensor(A1d, device),
        Ql=_tensor(Ql, device),
        L=_tensor(L, device),
        B=_tensor(B, device),
        E_bc_sqrtm=_tensor(E_bc_sqrtm, device),
    )


def latent_cache(*, A1d, Ql, L, B, device):
    """A :class:`pnmol_tpu_torch.solvers.latent.LatentSolverCache`."""
    return latent.LatentSolverCache(
        A1d=_tensor(A1d, device), Ql=_tensor(Ql, device), L=_tensor(L, device),
        B=_tensor(B, device),
    )


def steady_cache(*, cov_inf, L21, Sl, Sl_inv, err_vec, iterations, delta, device):
    """A :class:`pnmol_tpu_torch.solvers.white.SteadyStateCache` (the frozen
    blocks of either solver family's mean-only step)."""
    return white.SteadyStateCache(
        cov_inf=_tensor(cov_inf, device), L21=_tensor(L21, device), Sl=_tensor(Sl, device),
        Sl_inv=_tensor(Sl_inv, device), err_vec=_tensor(err_vec, device),
        iterations=int(iterations), delta=float(delta),
    )


def filter_state(*, t, mean, cov_sqrtm, device):
    """A :class:`pnmol_tpu_torch.solvers.pdefilter.PDEFilterState` with mean
    (n, d) and covariance factor (D, D)."""
    mean = _tensor(mean, device)
    return pdefilter.PDEFilterState(
        t=float(t),
        y=rv.MultivariateNormal(mean=mean, cov_sqrtm=_tensor(cov_sqrtm, device)),
        error_estimate=None,
        reference_state=None,
        diffusion_squared_local=mean.new_zeros(()),
    )


def ode_filter_state(*, t, mean, cov_sqrtm, device):
    """A :class:`pnmol_tpu_torch.odetools.ek1.ODEFilterState` with mean (n, d)
    and covariance factor (D, D)."""
    mean = _tensor(mean, device)
    return ek1.ODEFilterState(
        t=float(t),
        y=rv.MultivariateNormal(mean=mean, cov_sqrtm=_tensor(cov_sqrtm, device)),
        error_estimate=None,
        reference_state=None,
        diffusion_squared_local=mean.new_zeros(()),
    )


def local_shard(array, mesh, spec, *, device):
    """This rank's block of a global array under ``spec`` (a
    :class:`pnmol_tpu_torch.parallel.meshes.Layout` or its tuple of axis
    names, as a ``PartitionSpec``), as the port's sharded functions take it:
    e.g. the column block of a JAX-computed covariance factor for
    ``(None, "space")``."""
    from pnmol_tpu_torch.parallel import meshes

    layout = spec if isinstance(spec, meshes.Layout) else meshes.Layout(tuple(spec))
    return mesh.shard(_tensor(array, device), layout).contiguous()
