"""Dtype policy of the PyTorch port.

Like :mod:`pnmol_tpu.config` with x64 enabled, the port computes in float64
everywhere: the H100 has native FP64, so there is no float32 fast path to
opt into (``PNMOL_TPU_X32`` has no counterpart here). Constructors take the
dtype from :func:`default_dtype` and their device from an explicit
``device=`` argument; nothing in the package picks a device on its own.
"""

import torch

DEFAULT_DTYPE = torch.float64


def default_dtype() -> torch.dtype:
    """The dtype library constructors use."""
    return DEFAULT_DTYPE
