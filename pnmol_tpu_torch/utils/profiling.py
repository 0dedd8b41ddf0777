"""Profiling, timing and work accounting.

Counterpart of :mod:`pnmol_tpu.utils.profiling`: a ``torch.profiler`` trace
(Chrome trace JSON, viewable in Perfetto) and the program's spans
(:func:`annotate`, free while nothing records);
timers that synchronize the device of the tensors they time; the analytic
FLOP model of the white step per pipeline; and the step's roofline on one
card, from the FP64 and HBM rates of
:class:`pnmol_tpu_torch.utils.comm_model.ChipSpec` (the H100's 67 TFLOP/s
and 3.35 TB/s). FP64 runs at full precision in one pass, so one rate
serves every FLOP of the step.
"""

import contextlib
import pathlib
import time

import numpy as np
import torch

from pnmol_tpu_torch.utils import comm_model


@contextlib.contextmanager
def trace(log_dir):
    """Profile the scope with ``torch.profiler`` (the host, and the CUDA
    devices where this torch build supports them) and write
    ``log_dir/trace.json``, a Chrome trace."""
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=list(torch.profiler.supported_activities())) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


_profiler_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def annotate(name):
    """The program's one span helper: ``with annotate("pnmol.step"):``.

    While a profiler records, it returns ``record_function(name)``: a range
    in the same trace as the device's activity, on the profiler's clock.
    Otherwise it returns one shared null context and makes no call into the
    profiler, so an untraced run pays one check a span."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (tuple, list)):
        for value in tree:
            yield from _tensors(value)


def synchronize(tree):
    """Wait for the work of every CUDA device that holds a tensor of ``tree``."""
    for device in {x.device for x in _tensors(tree) if x.is_cuda}:
        torch.cuda.synchronize(device)


class Timer:
    """Wall-clock timer of a ``with`` block; synchronize inside the block
    (or time through :func:`time_blocked`) for device work."""

    def __init__(self):
        self.elapsed = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._start
        return False


def time_blocked(fn, *args, repeats=3, **kwargs):
    """Best-of-``repeats`` wall clock of ``fn``, each call synchronized on
    the devices of its tensor outputs, after one warm-up call."""
    out = fn(*args, **kwargs)
    synchronize(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(out)
        best = min(best, time.perf_counter() - t0)
    return out, best


def force_complete(tree):
    """Synchronize the devices of ``tree``'s tensors and return a sum that
    depends on each floating tensor (a strided sample of it, one scalar read
    a tensor), as the JAX package's does."""
    synchronize(tree)
    total = 0.0
    for leaf in _tensors(tree):
        if leaf.is_floating_point() and leaf.numel():
            flat = leaf.detach().reshape(-1)
            total += float(flat[::max(1, flat.numel() // 4096)].sum())
    return total


def qr_flops(rows, cols):
    """Householder QR flop count: 2 r c^2 - (2/3) c^3 (r >= c)."""
    return 2.0 * rows * cols**2 - (2.0 / 3.0) * cols**3


def lq_sweep_flops(rows, cols, *, b0=None, slope=1.0):
    """Householder LQ sweep FLOPs of a (rows, cols) pre-array whose row
    ``r`` has column support ``min(b0 + slope * r, cols)``.

    ``b0=None`` means dense and reproduces :func:`qr_flops` of the
    transposed problem. Counts 4 (rows below) (reflector length) of
    trailing-update work per reflector, the term the banded and interleaved
    sweeps window. An LQ of a wide (rows, cols) matrix is the QR of its
    transpose: a (D, 2D) propagate pre-array passes ``rows=D, cols=2D``.
    """
    k = np.arange(min(rows, cols), dtype=np.float64)
    support = np.full_like(k, float(cols)) if b0 is None else np.minimum(b0 + slope * k,
                                                                        float(cols))
    reflector = np.maximum(support - k, 0.0)
    return float(np.sum(4.0 * (rows - k) * reflector))


#: Pipelines of the white step, as the solver dispatches them: "fused" one
#: pre-array factorization; "two_qr" a propagate and an update; "banded" and
#: "interleaved" the two-QR split on the structured sweeps; "steady" the
#: mean-only stationary step.
WHITE_PIPELINES = ("fused", "two_qr", "banded", "interleaved", "steady")


def white_step_flops(d, nu, b, pipeline="fused"):
    """Approximate FLOPs of one white EK1 step of ``pipeline``: ``d`` grid
    points, ``nu`` derivatives (n = nu + 1, D = n d), ``b`` boundary rows.
    The factorization volume differs about 5x between pipelines, so a rate
    is only meaningful against the model of the pipeline that ran."""
    n = nu + 1
    D = n * d
    m = d + b
    if pipeline == "steady":
        # transition, residual products, whitening and gain matvecs
        return 2.0 * n * n * d + 2.0 * d * d + 2.0 * m * m + 2.0 * D * m
    h_products = 3 * (2.0 * d * d * D)  # H {A Cl, Ql} and the error estimate's S
    gain = 2.0 * D * m
    transition = 2.0 * n * n * d * D
    other = h_products + gain + transition
    if pipeline == "fused":
        return qr_flops(2 * D + m, m + D) + other
    if pipeline == "two_qr":
        fact = lq_sweep_flops(D, 2 * D) + lq_sweep_flops(m + D, m + D)
    elif pipeline == "banded":
        fact = (lq_sweep_flops(D, 2 * D, b0=D + 1, slope=1.0)
                + lq_sweep_flops(m + D, m + D, b0=D + 1, slope=1.0))
    elif pipeline == "interleaved":
        fact = (lq_sweep_flops(D, 2 * D, b0=n, slope=2.0)
                + lq_sweep_flops(m + D, m + D, b0=D + 1, slope=1.0))
    else:
        raise ValueError(f"unknown pipeline {pipeline!r}; one of {WHITE_PIPELINES}")
    return fact + other


def white_step_bytes(d, nu, b, pipeline="fused", itemsize=8):
    """Least bytes one white step moves: the factor, ``Ql``, ``L`` and the
    noise factor read once, the pre-arrays written and read once each, the
    new factor written once."""
    n = nu + 1
    D = n * d
    m = d + b
    if pipeline == "fused":
        pre = (2 * D + m) * (m + D)
    else:
        pre = 2 * D * D + (m + D) ** 2
    return float(itemsize * (3 * D * D + d * d + m * m + 2 * pre))


def steps_per_sec_to_gflops(steps_per_sec, d, nu, b, pipeline="fused"):
    return steps_per_sec * white_step_flops(d, nu, b, pipeline) / 1e9


def roofline(d, nu, b, *, fused=True, pipeline=None, chip=None):
    """Roofline of one white EK1 step on one card (default: the H100 of
    :class:`comm_model.ChipSpec`): its time is at least the FLOPs over the
    FP64 peak and the bytes of :func:`white_step_bytes` over the HBM rate.

    Returns the FLOPs (the factorization's and the rest), the bytes, which
    bound binds, the steps/s ceiling, the rate at the ceiling and its share
    of the FP64 peak (``fp64_peak_share_at_ceiling``: 1 where the FLOPs
    bind). ``pipeline`` (preferred over the ``fused`` flag) selects the FLOP
    model of :func:`white_step_flops`; the ``"steady"`` step has no
    factorization and raises ``ValueError``.
    """
    chip = chip or comm_model.ChipSpec()
    n = nu + 1
    D = n * d
    m = d + b
    if pipeline is None:
        pipeline = "fused" if fused else "two_qr"
    if pipeline == "steady":
        raise ValueError(
            "the steady step has no factorization; its ceiling is the HBM and "
            "launch floor: use white_step_flops(..., 'steady') directly"
        )
    other = white_step_flops(d, nu, b, "fused") - qr_flops(2 * D + m, m + D)
    qr = white_step_flops(d, nu, b, pipeline) - other
    total = qr + other
    nbytes = white_step_bytes(d, nu, b, pipeline)
    t_flops = total / chip.peak_flops
    t_bytes = nbytes / chip.hbm_bytes_per_s
    steps_ceiling = 1.0 / max(t_flops, t_bytes)
    return {
        "qr_flops": qr,
        "other_flops": other,
        "qr_share": qr / total,
        "bytes": nbytes,
        "bound_by": "operations" if t_flops >= t_bytes else "bytes",
        "steps_per_sec_ceiling": steps_ceiling,
        "tflops_at_ceiling": total * steps_ceiling / 1e12,
        "fp64_peak_share_at_ceiling": total * steps_ceiling / chip.peak_flops,
    }
