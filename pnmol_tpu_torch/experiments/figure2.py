"""Figure 2: the spatial-discretization study.

Counterpart of ``experiments/figure2.py``: the input-scale MLE by grid
search, the FD error as a function of stencil size x input scale, sparse
FD against dense collocation (L and E), and GP prior samples::

    python -m pnmol_tpu_torch.experiments.figure2 [--fast] [--no-plot]
        [--device cuda|cpu] [--out DIR]

The figure has no reduced size: ``--fast`` only writes to ``figure2_fast/``.
Its 25-point Grams stay below the Gram kernel's dispatch size, on the card
as in the JAX package.
"""

import numpy as np
import torch

import pnmol_tpu_torch as pt
from pnmol_tpu_torch.experiments import common

NUM_MESH_POINTS = 25
NUM_GRID_POINTS = 150
INPUT_SCALES = (0.2, 0.8, 3.2)
NOISE_SEED = 123
# the RMSE of a grid entry whose stencil Gram has no Cholesky factor
FAILED_RMSE = 100.0


def obj_point(x):
    return torch.sin(x @ x)


def obj_fun(points):
    return torch.func.vmap(obj_point)(points)


def truth_fun(points):
    return torch.func.vmap(pt.diffops.laplace()(obj_point))(points)


def make_mesh(device):
    return pt.mesh.RectangularMesh(
        np.linspace(0, 1, NUM_MESH_POINTS, endpoint=True)[:, None],
        bbox=[[0.0, 1.0]],
        device=device,
    )


def input_scale_mle(mesh, num_trial_points=20):
    """MLE of the SE input scale over a log-spaced grid."""
    y = obj_fun(mesh.points).squeeze()
    trials = np.logspace(-3, 3, num_trial_points)
    return float(pt.kernels.mle_input_scale(
        mesh_points=mesh.points,
        data=y,
        kernel_type=pt.kernels.SquareExponential,
        input_scale_trials=trials,
    ))


def scale_to_rmse(mesh, scale, stencil_size):
    """The relative RMSE of the FD Laplacian of the target, and (L, E).

    Where a stencil's Gram has no Cholesky factor the JAX package returns
    NaN and its figure maps that RMSE to 100; ``torch.linalg.cholesky``
    raises instead, so that error gives NaN here, and :func:`run` maps it to
    the same 100.
    """
    kernel = pt.kernels.SquareExponential(input_scale=scale)
    try:
        L, E = pt.discretize.fd_probabilistic(
            diffop=pt.diffops.laplace(),
            mesh_spatial=mesh,
            kernel=kernel,
            stencil_size_interior=stencil_size,
            stencil_size_boundary=stencil_size,
        )
    except torch.linalg.LinAlgError:
        return float("nan"), (None, None)
    fx = obj_fun(mesh.points).squeeze()
    dfx = truth_fun(mesh.points).squeeze()
    error_rel = torch.abs(L @ fx - dfx) / torch.abs(dfx)
    return float(torch.linalg.norm(error_rel) / error_rel.numel() ** 0.5), (L, E)


def gp_sample(kernel, points, noise, nugget=1e-12):
    """A prior sample ``chol(K + nugget I) @ noise``."""
    eye = torch.eye(points.shape[0], dtype=points.dtype, device=points.device)
    gram = kernel(points, points.T) + nugget * eye
    return torch.linalg.cholesky(gram) @ noise


def default_noises(device, dtype):
    """One (150, 2) standard-normal draw per input scale, in turn from one
    generator seeded with 123 (the JAX driver splits ``PRNGKey(123)``, whose
    stream this cannot reproduce)."""
    generator = torch.Generator(device=device).manual_seed(NOISE_SEED)
    return [torch.randn((NUM_GRID_POINTS, 2), generator=generator, dtype=dtype, device=device)
            for _ in INPUT_SCALES]


def run(device="cuda", *, fast=False, noises=None):
    """The JAX driver's ``fig2_*`` arrays. ``noises`` (three (150, 2)
    arrays) replaces the default draws of the GP samples."""
    del fast  # one size only
    device = common.device_of(device)
    mesh = make_mesh(device)
    dtype = mesh.points.dtype

    scale_mle = input_scale_mle(mesh)
    print("MLE input scale:", scale_mle)

    input_scales = np.asarray(INPUT_SCALES)
    stencil_sizes = np.arange(3, NUM_MESH_POINTS, step=2)
    rmse_all = np.asarray(
        [[scale_to_rmse(mesh, float(s), int(n))[0] for s in input_scales] for n in stencil_sizes]
    )
    rmse_all = np.nan_to_num(rmse_all, nan=FAILED_RMSE)

    _, (L_sparse, E_sparse) = scale_to_rmse(mesh, scale_mle, 3)
    L_dense, E_dense = pt.discretize.collocation_global(
        diffop=pt.diffops.laplace(),
        mesh_spatial=mesh,
        kernel=pt.kernels.SquareExponential(input_scale=scale_mle),
        nugget_cholesky_E=1e-10,
        nugget_gram_matrix=1e-12,
        symmetrize_cholesky_E=True,
    )

    xgrid = torch.linspace(0, 1, NUM_GRID_POINTS, dtype=dtype, device=device)[:, None]
    fx = obj_fun(xgrid).squeeze()
    dfx = truth_fun(xgrid).squeeze()

    if noises is None:
        noises = default_noises(device, dtype)
    samples = [
        gp_sample(pt.kernels.SquareExponential(input_scale=float(scale)), xgrid,
                  torch.as_tensor(noise, dtype=dtype, device=device))
        for scale, noise in zip(input_scales, noises)
    ]
    print("figure2 rmse grid:\n", rmse_all)

    arrays = dict(
        rmse_all=rmse_all,
        input_scales=input_scales,
        stencil_sizes=stencil_sizes,
        L_sparse=L_sparse,
        L_dense=L_dense,
        E_sparse=E_sparse,
        E_dense=E_dense,
        xgrid=xgrid,
        fx=fx,
        dfx=dfx,
        s1=samples[0],
        s2=samples[1],
        s3=samples[2],
        scale_mle=np.asarray(scale_mle),
    )
    return {f"fig2_{name}": common.to_numpy(value) for name, value in arrays.items()}


def main(argv=None):
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    common.finish(args, "figure2", run(args.device, fast=args.fast))


if __name__ == "__main__":
    main()
