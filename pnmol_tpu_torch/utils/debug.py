"""Finite checks, NaN detection and live-memory dumps.

Counterpart of :mod:`pnmol_tpu.utils.debug`. JAX's tools map to eager
PyTorch ones: :func:`assert_finite` walks nested dicts, tuples, lists and
NamedTuples of tensors (JAX's pytrees); :func:`checkify_finite` checks one
tensor and warns (the port runs eagerly, so there is nothing to stage);
:func:`debug_nans` scopes ``torch.autograd.set_detect_anomaly(enable,
check_nan=True)``, the counterpart of ``jax_debug_nans`` (a backward that
produces NaN raises at the op that made it); :func:`dump_live_arrays` lists
the largest live CUDA tensors and the caching allocator's counters.
"""

import contextlib
import gc
import math
import os
import time
import warnings

import torch


def _leaves(tree, path=""):
    """``(path, leaf)`` pairs of a nested container, paths in JAX's
    ``keystr`` form (``['key']``, ``[0]``, ``.field``)."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{path}[{key!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for key, value in zip(tree._fields, tree):
            yield from _leaves(value, f"{path}.{key}")
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _finite(leaf):
    if isinstance(leaf, torch.Tensor):
        return bool(torch.isfinite(leaf).all())
    return math.isfinite(leaf)


def assert_finite(tree, name="pytree"):
    """Raise ``FloatingPointError`` naming the first leaf with NaN or inf."""
    for path, leaf in _leaves(tree):
        if not _finite(leaf):
            raise FloatingPointError(f"Non-finite values in {name}{path}")


def checkify_finite(x, name="array"):
    """Return ``x``; warn if it holds NaN or inf."""
    if not _finite(x):
        warnings.warn(f"non-finite values detected in {name}", RuntimeWarning, stacklevel=2)
    return x


@contextlib.contextmanager
def debug_nans(enable=True):
    """Within the scope, autograd's anomaly mode with NaN checks is
    ``enable``; the previous setting comes back on exit."""
    previous = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*previous)


def validate_solution(sol):
    """Finite-check a solution's means and covariance factors."""
    assert_finite({"mean": sol.mean, "cov_sqrtm": sol.cov_sqrtm}, "solution")
    return sol


def dump_live_arrays(tag="", top=25, min_mb=1.0):
    """Print the largest live CUDA tensors, by storage, and the caching
    allocator's allocated, reserved and peak bytes; only with
    ``PNMOL_DEBUG_LIVE=1``.

    The tensors come from a walk of the garbage collector's objects; views
    of one storage count once, under the largest view's shape. The counters
    read the current CUDA device, once CUDA is initialized.
    """
    if os.environ.get("PNMOL_DEBUG_LIVE") != "1":
        return
    start = time.perf_counter()
    storages = {}
    with warnings.catch_warnings():  # isinstance probes deprecated module attributes
        warnings.simplefilter("ignore")
        tensors = [obj for obj in gc.get_objects() if isinstance(obj, torch.Tensor)]
    for obj in tensors:
        try:
            if not obj.is_cuda:
                continue
            storage = obj.untyped_storage()
        except RuntimeError:  # tensors without a storage
            continue
        key = (storage.device, storage.data_ptr())
        nbytes = storage.nbytes()
        if key not in storages or obj.numel() > storages[key][2]:
            storages[key] = (nbytes, tuple(obj.shape), obj.numel(), str(obj.dtype))
    total = sum(row[0] for row in storages.values())
    rows = sorted((row for row in storages.values() if row[0] >= min_mb * 1e6), reverse=True)
    print(f"[live_arrays:{tag}] total={total / 1e9:.2f} GB in {len(storages)} CUDA storages, "
          f"{len(rows)} >= {min_mb} MB (the walk took {time.perf_counter() - start:.2f} s)",
          flush=True)
    for nbytes, shape, _, dtype in rows[:top]:
        print(f"  {nbytes / 1e9:7.3f} GB  {dtype:14s} {shape}", flush=True)
    if torch.cuda.is_initialized():
        print(f"[live_arrays:{tag}] allocator: allocated {torch.cuda.memory_allocated() / 2**30:.2f}"
              f" GiB, reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
