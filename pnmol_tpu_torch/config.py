"""Dtype policy of the PyTorch port.

Counterpart of :mod:`pnmol_tpu.config`. By default the port computes in
float64, as the JAX package does with x64 enabled (the reproduction gates
need it). Setting the environment variable ``PNMOL_TPU_X32=1`` *before
importing* ``pnmol_tpu_torch`` selects the float32 policy: every
constructor (mesh, FD assembly, prior, initialization and step) then builds
float32 tensors, and the kernels launch their f32 instantiations. The
variable is read once, here, at import; :func:`enable_x64` switches the
policy at run time, as ``jax.config.update("jax_enable_x64", ...)`` does,
for constructors called after it (tensors already built keep their dtype).

Use :func:`default_dtype` in library code instead of hard-coding a dtype.
Constructors take their device from an explicit ``device=`` argument;
nothing in the package picks a device on its own.
"""

import os

import torch

_X64_DISABLED = os.environ.get("PNMOL_TPU_X32", "0") == "1"

# the process-wide policy, like jax.config's flag: set from the environment
# by setup() and at run time by enable_x64(), read by default_dtype()
_policy = {}


def setup() -> None:
    """Apply the precision policy of the environment. Called once from
    ``pnmol_tpu_torch.__init__``."""
    _policy["x64"] = not _X64_DISABLED


def enable_x64(enabled: bool = True) -> bool:
    """Switch the policy at run time (float64 if ``enabled``, else float32)
    and return the previous setting, so that a caller can restore it."""
    previous = _policy["x64"]
    _policy["x64"] = bool(enabled)
    return previous


def x64_enabled() -> bool:
    return _policy["x64"]


def default_dtype() -> torch.dtype:
    """The dtype library constructors use."""
    return torch.float64 if x64_enabled() else torch.float32


def by_dtype(dtype, f64, f32):
    """A dtype-aware constant of the solvers: ``f64`` for float64 tensors,
    ``f32`` for float32 ones (a float64 nugget or tolerance falls below
    float32's resolution)."""
    return f64 if dtype == torch.float64 else f32
