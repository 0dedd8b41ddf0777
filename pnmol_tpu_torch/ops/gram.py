"""Dense radial-kernel Gram matrices with a hand-written CUDA kernel.

Counterpart of :mod:`pnmol_tpu.ops.pallas_gram`. Both versions compute
``K[i, j] = phi(max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0))`` on point clouds
centred on the mean of ``points_x`` (distances are translation invariant,
and centring removes the cancellation of the distance trick for clouds far
from the origin), for the squared-exponential and Matern(5/2) profiles.

:func:`gram_radial` takes the plain version :func:`gram_radial_reference`
for a CPU tensor, launches the kernel of ``csrc/gram_radial.cu`` (the
counterpart of the TPU kernel ``_gram_tile_kernel``) for a CUDA tensor, and
raises for anything else.
"""

import ctypes

import torch

from pnmol_tpu_torch.ops import cuda_build


def _phi_squared_exponential(d2, input_scale, output_scale):
    return output_scale**2 * torch.exp(-d2 * input_scale**2 / 2.0)


def _phi_matern52(d2, input_scale, output_scale):
    scaled = torch.sqrt(5.0 * d2 * input_scale**2)
    poly = 1.0 + scaled + scaled**2 / 3.0
    return output_scale**2 * poly * torch.exp(-scaled)


_PHI = {
    "squared_exponential": _phi_squared_exponential,
    "matern52": _phi_matern52,
}
# the kernel's runtime switch for the profile
_PHI_CODE = {"squared_exponential": 0, "matern52": 1}

# ctypes types of the kernel's own arguments: x, y, out (device pointers),
# n, m, dim, profile, then input_scale and output_scale as doubles
_GRAM_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_double,) * 2


def _centred(points_x, points_y):
    center = points_x.mean(dim=0, keepdim=True)
    return points_x - center, points_y - center


def gram_radial_reference(points_x, points_y, input_scale, output_scale, *, phi_name):
    """Plain PyTorch version: the arithmetic of
    :func:`pnmol_tpu.ops.pallas_gram.gram_fast_jnp`. ``points_x`` (N, dim),
    ``points_y`` (M, dim) -> (N, M)."""
    phi = _PHI[phi_name]
    x, y = _centred(points_x, points_y)
    d2 = (x * x).sum(dim=1)[:, None] + (y * y).sum(dim=1)[None, :] - 2.0 * x @ y.T
    return phi(torch.clamp(d2, min=0.0), input_scale, output_scale)


def gram_radial(points_x, points_y, input_scale, output_scale, *, phi_name):
    """Dense radial Gram ``(N, M)`` (see :func:`gram_radial_reference`).

    CPU tensors take the plain version. CUDA tensors are centred here, then
    the kernel of ``csrc/gram_radial.cu`` runs on the current stream (no
    synchronization) and ``gram_radial.launches`` grows by one; anything the
    kernel does not take raises. The scales are Python floats.
    """
    if points_x.device.type == "cpu":
        return gram_radial_reference(
            points_x, points_y, input_scale, output_scale, phi_name=phi_name
        )
    if phi_name not in _PHI_CODE:
        raise ValueError(f"gram_radial: unknown profile {phi_name!r}")
    cuda_build.check_input("gram_radial", points_x)
    cuda_build.check_input("gram_radial", points_y)
    if points_y.dtype != points_x.dtype or points_y.device != points_x.device:
        raise ValueError("gram_radial: points_x and points_y differ in dtype or device")
    (n, dim), (m, dim_y) = points_x.shape, points_y.shape
    if n < 1 or m < 1 or dim < 1 or dim_y != dim:
        raise ValueError(
            f"gram_radial: need non-empty (N, dim) and (M, dim) clouds, got "
            f"{tuple(points_x.shape)} and {tuple(points_y.shape)}"
        )
    x, y = _centred(points_x, points_y)
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    cuda_build.launch(
        "gram_radial", "gram_radial", _GRAM_ARGS, x,
        x.data_ptr(), y.data_ptr(), out.data_ptr(), n, m, dim, _PHI_CODE[phi_name],
        float(input_scale), float(output_scale),
    )
    gram_radial.launches += 1
    return out


gram_radial.launches = 0
