"""What the drivers share: devices, results IO, extraction, the accuracy
and calibration statistics, and the measurement drivers' JSON records and
leg statuses.

Counterpart of ``experiments/common.py``. The drivers write under an output
root of the caller's (``--out``; by default ``chiprun_out/figures/`` of the
checkout, which git ignores), never into ``experiments/results/``, and
``--fast`` runs write to ``<figure>_fast/`` beside the full ones. File
names are the JAX drivers': ``<prefix>_<name>.npy``. The measurement
drivers write one JSON file each under ``chiprun_out/<driver>/``
(:func:`write_artifact`), and never into the JAX package's committed
records (``bench_artifacts/``, ``experiments/``, ``docs/``).
"""

import argparse
import contextlib
import json
import pathlib
import time
import traceback

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "chiprun_out" / "figures"
ARTIFACT_ROOT = REPO / "chiprun_out"
# the JAX package's committed records, which no driver of the port writes
PROTECTED = tuple(REPO / name for name in ("bench_artifacts", "experiments", "docs"))


def device_of(name):
    """``torch.device(name)``; a CUDA device without a card raises here, so
    that a driver asked for the card never runs on the CPU instead."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} was asked for, but no CUDA device is available")
    return device


def default_factorization(device):
    """The kernel route on the card (``"householder"``: the panel kernel of
    ``csrc/panel_lq.cu``), the plain QRs on the CPU."""
    return "householder" if torch.device(device).type == "cuda" else None


def results_dir(out, figure, fast=False):
    path = pathlib.Path(out) / (figure + "_fast" if fast else figure)
    path.mkdir(parents=True, exist_ok=True)
    return path


def save_arrays(path, arrays):
    """``<name>.npy`` under ``path`` for each entry; refuses NaN."""
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if np.any(np.isnan(arr)):
            raise ValueError(f"NaN in {name}")
        np.save(pathlib.Path(path) / f"{name}.npy", arr)


def to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Solution extraction
# ---------------------------------------------------------------------------


def trajectory_mean_std(sol, E0):
    """Per-step solution means and marginal stds from a PDESolution."""
    means = sol.mean[:, 0]
    variances = torch.einsum("tij,tij->ti", sol.cov_sqrtm, sol.cov_sqrtm)
    stds = torch.sqrt(variances @ E0.T)
    return means, stds


def trajectory_mean_std_latent(sol, E0):
    """Same, for the latent solver's glued (state | latent) layout."""
    means = torch.chunk(sol.mean, 2, dim=-1)[0][:, 0, :]
    variances = torch.einsum("tij,tij->ti", sol.cov_sqrtm, sol.cov_sqrtm)
    state_vars = torch.chunk(variances, 2, dim=-1)[0]
    stds = torch.sqrt(state_vars @ E0.T)
    return means, stds


def final_mean_std_cov(final_state, E0):
    """Mean, marginal std, and solution-block covariance of a final state."""
    mean = final_state.y.mean[0, :]
    cov_full = final_state.y.cov_sqrtm @ final_state.y.cov_sqrtm.T
    cov = E0 @ cov_full @ E0.T
    std = torch.sqrt(torch.diagonal(cov))
    return mean, std, cov


def leading_block(cov, parts):
    """The first of ``parts`` x ``parts`` equal blocks of ``cov``."""
    n = cov.shape[0] // parts
    return cov[:n, :n]


def chi2_statistic(error_abs, cov):
    """Calibration statistic e^T C^{-1} e / n (SPD solve via Cholesky)."""
    eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    chol = torch.linalg.cholesky(cov + 1e-12 * eye)
    white = torch.cholesky_solve(error_abs[:, None], chol)[:, 0]
    return error_abs @ white / error_abs.shape[0]


def rmse(error_abs, reference=None):
    """RMSE; relative if a reference is given."""
    err = error_abs if reference is None else error_abs / torch.abs(reference)
    return torch.linalg.norm(err) / err.numel() ** 0.5


def _synchronize():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, **kwargs):
    """(result, elapsed_seconds), the card's queue drained on both ends
    (the JAX drivers block on all outputs)."""
    _synchronize()
    start = time.perf_counter()
    result = fn(*args, **kwargs)
    _synchronize()
    return result, time.perf_counter() - start


class HostJacobian:
    """An IVP's Jacobian for LSODA, moved to the host inside the call, with
    the calls and their seconds (evaluation and copy) counted."""

    def __init__(self, df):
        self.df = df
        self.calls = 0
        self.seconds = 0.0

    def __call__(self, t, y):
        start = time.perf_counter()
        jac = self.df(t, y).cpu()
        self.seconds += time.perf_counter() - start
        self.calls += 1
        return jac


# ---------------------------------------------------------------------------
# Measurement drivers: JSON records and leg statuses
# ---------------------------------------------------------------------------


def device_name(device):
    """The card's name for a CUDA device, ``"cpu"`` otherwise: the
    ``device`` entry of every record."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def write_artifact(driver, payload, out=ARTIFACT_ROOT):
    """Write ``payload`` as ``<out>/<driver>/<driver>.json`` and return the
    path. Refuses a path inside the JAX package's committed records
    (:data:`PROTECTED`)."""
    path = (pathlib.Path(out) / driver / f"{driver}.json").resolve()
    for root in PROTECTED:
        if path.is_relative_to(root.resolve()):
            raise ValueError(f"{path} lies in {root}, a committed record of the JAX package")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1) + "\n")
    return path


@contextlib.contextmanager
def precision_policy(dtype):
    """Build and run under the package's float32 or float64 policy
    (:func:`pnmol_tpu_torch.config.enable_x64`), the policy before it
    restored after it: the JAX drivers' ``PNMOL_TPU_X32`` legs."""
    from pnmol_tpu_torch import config

    previous = config.enable_x64(dtype == torch.float64)
    try:
        yield
    finally:
        config.enable_x64(previous)


def run_leg(name, fn, *args, **kwargs):
    """``(result, status)`` of one leg ``fn(*args, **kwargs)``. The status is
    ``{"leg", "status": "completed" | "failed", "error"}``; a failed leg's
    traceback goes to stderr and its result is None. The caller reports
    every status and exits non-zero if any failed."""
    try:
        result = fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 - a leg's failure is recorded, never hidden
        traceback.print_exc()
        return None, {"leg": name, "status": "failed", "error": f"{type(exc).__name__}: {exc}"}
    return result, {"leg": name, "status": "completed", "error": None}


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def parser(description):
    """The options every driver takes."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--fast", action="store_true", help="smoke-size run into <figure>_fast/")
    p.add_argument("--no-plot", action="store_true", help="save the arrays, render nothing")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", type=pathlib.Path, default=DEFAULT_OUT,
                   help=f"output root (default {DEFAULT_OUT})")
    return p


def finish(args, figure, arrays, **plot_kwargs):
    """Save ``arrays`` under the output root, then, unless ``--no-plot``,
    render the figure from them (matplotlib is imported only then, and its
    absence raises)."""
    path = results_dir(args.out, figure, args.fast)
    save_arrays(path, arrays)
    print(f"{figure}: {len(arrays)} arrays saved in {path}")
    if not args.no_plot:
        from pnmol_tpu_torch.experiments import plotting

        getattr(plotting, figure.replace("figure", "figure_"))(
            args.out, fast=args.fast, **plot_kwargs)
