"""Checkpoint and resume of filter states.

Counterpart of :mod:`pnmol_tpu.utils.checkpoint`'s ``.npz`` branch: a
:class:`pnmol_tpu_torch.solvers.pdefilter.PDEFilterState` (t, mean,
covariance factor, local diffusion) and auxiliary arrays under ``extra_*``
keys, in one ``.npz`` file whose keys are the JAX package's, so either
package reads what the other wrote. The JAX package's orbax directories are
not read: the port has no orbax.
"""

import pathlib

import numpy as np
import torch

from pnmol_tpu_torch.ops import rv
from pnmol_tpu_torch.solvers import pdefilter


def _numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_state(path, state, extra=None):
    """Write a filter state, and optional auxiliary arrays, to ``path`` with
    the suffix ``.npz``."""
    path = pathlib.Path(path)
    tree = {
        "t": state.t,
        "mean": state.y.mean,
        "cov_sqrtm": state.y.cov_sqrtm,
        "diffusion_squared_local": state.diffusion_squared_local,
    }
    tree.update({f"extra_{k}": v for k, v in (extra or {}).items()})
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path.with_suffix(".npz"), **{k: _numpy(v) for k, v in tree.items()})


def load_state(path, *, device):
    """Read back ``(state, extra)`` written by :func:`save_state` (or by the
    JAX package without orbax), every array a tensor on ``device`` with its
    stored dtype."""
    path = pathlib.Path(path)
    with np.load(path.with_suffix(".npz")) as data:
        tree = {k: torch.from_numpy(data[k]).to(device) for k in data.files}
    extra = {k[len("extra_"):]: v for k, v in tree.items() if k.startswith("extra_")}
    state = pdefilter.PDEFilterState(
        t=float(tree["t"]),
        y=rv.MultivariateNormal(mean=tree["mean"], cov_sqrtm=tree["cov_sqrtm"]),
        error_estimate=None,
        reference_state=None,
        diffusion_squared_local=tree["diffusion_squared_local"],
    )
    return state, extra
