"""Blocked Householder LQ with a hand-written CUDA panel kernel.

Counterpart of the LQ half of :mod:`pnmol_tpu.ops.qr_householder`. The
sweep is the same compact-WY blocked Householder LQ: each ``(block, cols)``
row panel is factorized by ONE panel-kernel launch (:func:`panel_lq`, which
replaces the TPU kernels ``_block_lq_kernel`` and ``_leaf_lq_kernel``), and
the rows below take the panel's reflectors as one rank-``block`` trailing
update ``W - (W V^T) T V``, two plain matrix products.

The sweep is the plain shrinking block loop (the JAX ``superblocks = nb``
form): after each panel the work matrix drops the panel's rows and columns,
so every panel starts at diagonal offset 0. The TPU-only machinery of the
JAX sweep (Mosaic lane quantization, scan superblocks, liveness barriers,
leaf panels and their merge) has no counterpart here.

On a CPU tensor :func:`panel_lq` runs the plain PyTorch version
:func:`panel_lq_reference`; on a CUDA tensor it launches the kernel (built
with ``nvcc`` from ``csrc/panel_lq.cu`` at first use) or raises.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile

import torch

_PACKAGE = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PACKAGE / "csrc" / "panel_lq.cu"
_BUILD_DIR = _PACKAGE / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


# ---------------------------------------------------------------------------
# Panel kernel: build, bind, dispatch
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = pathlib.Path(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError(
            "panel_lq: nvcc not found (set CUDA_HOME); the CUDA panel kernel "
            "cannot be built"
        )
    return str(nvcc)


def build_panel_lq() -> pathlib.Path:
    """Compile ``csrc/panel_lq.cu`` into a shared library (once per source).

    The library lands in ``_build/panel_lq-<source hash>/``, so an edited
    source builds anew and an unchanged one is reused. Raises if ``nvcc`` is
    missing or the compile fails.
    """
    source = _SOURCE.read_bytes()
    digest = hashlib.sha256(source + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    out_dir = _BUILD_DIR / f"panel_lq-{digest[:16]}"
    lib = out_dir / "libpanel_lq.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"panel_lq: nvcc failed ({proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_panel_lq()))
    for name in ("panel_lq_f64", "panel_lq_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib


def panel_lq_reference(slab, off):
    """Plain PyTorch version of the panel kernel: the unblocked recurrence.

    ``slab`` (rows, cols), diagonal of row k at lane ``off + k`` (rows <=
    cols - off). Returns ``(LV (rows, cols), T^T (rows, rows))`` with the
    TPU kernels' contract: L at lanes <= off + row, reflector tails beyond
    (unit diagonal implicit), and T^T lower triangular with tau on the
    diagonal for ``Q = I - V^T T V``.
    """
    rows, cols = slab.shape
    lv = slab.clone()
    tT = slab.new_zeros((rows, rows))
    for k in range(rows):
        d = off + k
        x = lv[k].clone()
        alpha = x[d]
        norm = torch.sqrt(alpha * alpha + torch.sum(x[d + 1:] ** 2))
        beta = -torch.where(alpha >= 0, 1.0, -1.0).to(x.dtype) * norm
        safe = norm > 0
        inv_denom = torch.where(
            safe, 1.0 / torch.where(safe, alpha - beta, 1.0), 0.0
        )
        tau = torch.where(safe, (beta - alpha) / torch.where(safe, beta, 1.0), 0.0)
        v = torch.zeros_like(x)
        v[d] = 1.0
        v[d + 1:] = x[d + 1:] * inv_denom
        s = lv @ v  # rows < k: z = V_{<k} v_k; rows > k: update weights
        lv[k + 1:] -= (tau * s[k + 1:])[:, None] * v
        lv[k, d] = beta
        lv[k, d + 1:] = v[d + 1:]
        tT[k, :k] = -tau * (s[:k] @ tT[:k, :k])
        tT[k, k] = tau
    return lv, tT


def panel_lq(slab, off):
    """Householder LQ of one wide panel (see :func:`panel_lq_reference`).

    CPU tensors take the plain version. CUDA tensors launch the kernel of
    ``csrc/panel_lq.cu`` on the current stream (no synchronization) and add
    one to ``panel_lq.launches``; anything the kernel does not take raises.
    """
    if slab.device.type == "cpu":
        return panel_lq_reference(slab, off)
    if slab.device.type != "cuda":
        raise ValueError(f"panel_lq: unsupported device {slab.device}")
    if slab.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"panel_lq: dtype must be float64 or float32, got {slab.dtype}")
    if slab.ndim != 2 or not slab.is_contiguous():
        raise ValueError("panel_lq: slab must be a contiguous 2-D tensor")
    rows, cols = slab.shape
    off = int(off)
    if rows < 1 or off < 0 or rows > cols - off:
        raise ValueError(
            f"panel_lq: need 1 <= rows <= cols - off, got rows={rows}, "
            f"cols={cols}, off={off}"
        )
    fn = (
        _library().panel_lq_f64
        if slab.dtype == torch.float64
        else _library().panel_lq_f32
    )
    lv = torch.empty_like(slab)
    tT = torch.empty((rows, rows), dtype=slab.dtype, device=slab.device)
    scratch = torch.empty((rows,), dtype=slab.dtype, device=slab.device)
    err = fn(
        slab.data_ptr(), lv.data_ptr(), tT.data_ptr(), scratch.data_ptr(),
        rows, cols, off, slab.device.index,
        torch.cuda.current_stream(slab.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"panel_lq: kernel launch failed (cudaError {err})")
    panel_lq.launches += 1
    return lv, tT


panel_lq.launches = 0


# ---------------------------------------------------------------------------
# Blocked sweep and factorization hooks
# ---------------------------------------------------------------------------


def _reflectors(lv):
    """Reflector rows (unit diagonal explicit) of a panel output at off 0."""
    V = torch.triu(lv, diagonal=1)
    V.diagonal().fill_(1.0)
    return V


def blocked_lq_l(W, *, block: int = 128):
    """Lower-triangular L with ``L L^T = W W^T`` from one Householder LQ of
    wide ``W`` (rows <= cols), shape (rows, rows).

    One :func:`panel_lq` call per ``block`` rows (``ceil(rows / block)`` in
    all), each followed by the trailing update of the rows below. The signs
    of L's diagonal follow the reflectors' convention (``beta = -sign(alpha)
    ||x||``), as in :func:`pnmol_tpu.ops.qr_householder.blocked_lq_l`.
    """
    Nr, M = W.shape
    if M < Nr:
        raise ValueError(f"blocked_lq_l requires cols >= rows, got {tuple(W.shape)}")
    L = W.new_zeros((Nr, Nr))
    work = W
    done = 0
    while done < Nr:
        b = min(block, Nr - done)
        lv, tT = panel_lq(work[:b].contiguous(), 0)
        L[done:done + b, done:done + b] = torch.tril(lv[:, :b])
        rest = work[b:]
        if rest.shape[0]:
            V = _reflectors(lv)
            rest = rest - ((rest @ V.T) @ tT.T) @ V
            L[done + b:, done:done + b] = rest[:, :b]
            work = rest[:, b:]
        done += b
    return L


def _gain_solve_lower(L1, L21):
    """gain = L21 L1^{-1}, via L1^T X = L21^T."""
    return torch.linalg.solve_triangular(L1.T, L21.T, upper=True).T


def _check_pair_columns(pair_columns):
    if pair_columns:
        raise NotImplementedError(
            "pair_columns is not ported: it was measured slower on the TPU "
            "and is off by default (ROADMAP, 'Not to port')"
        )


def make_householder_update_from_products(*, block: int = 128,
                                          pair_columns: bool = False):
    """Householder-LQ drop-in for the sqrt update from products:
    ``(HC, C, R) -> (posterior_factor, gain, innovation_factor)`` through the
    LQ of ``[[HC, R], [C, 0]]``; ``.blocks`` returns the raw factor blocks
    ``(L3, L21, L1)`` without the gain solve."""
    _check_pair_columns(pair_columns)

    def blocks(HC, C, meascov_sqrtm):
        m, D = HC.shape
        W = torch.cat(
            (
                torch.cat((HC, meascov_sqrtm), dim=1),
                torch.cat((C, C.new_zeros((D, m))), dim=1),
            ),
            dim=0,
        )
        L = blocked_lq_l(W, block=block)
        return L[m:, m:], L[m:, :m], L[:m, :m]

    def update(HC, C, meascov_sqrtm):
        L3, L21, L1 = blocks(HC, C, meascov_sqrtm)
        return L3, _gain_solve_lower(L1, L21), L1

    update.blocks = blocks
    return update


def make_householder_lq_factorization(*, block: int = 128,
                                      pair_columns: bool = False):
    """A ``factorization=`` hook for the white-noise step: the fused
    pre-array ``W = [[HACl, HQl, E], [ACl, Ql, 0]]`` factorized by
    :func:`blocked_lq_l`. Same contract as the fused predict-update
    ``(HACl, ACl, HQl, Ql, R) -> (posterior_factor, gain,
    innovation_factor)``; ``.blocks`` returns ``(L3, L21, L1)`` without the
    gain solve (the step only needs ``K z = L21 (L1^{-1} z)``)."""
    _check_pair_columns(pair_columns)

    def blocks(HACl, ACl, HQl, Ql, meascov_sqrtm):
        m, D = HACl.shape
        W = torch.cat(
            (
                torch.cat((HACl, HQl, meascov_sqrtm), dim=1),
                torch.cat((ACl, Ql, ACl.new_zeros((D, m))), dim=1),
            ),
            dim=0,
        )
        L = blocked_lq_l(W, block=block)
        return L[m:, m:], L[m:, :m], L[:m, :m]

    def factorization(HACl, ACl, HQl, Ql, meascov_sqrtm):
        L3, L21, L1 = blocks(HACl, ACl, HQl, Ql, meascov_sqrtm)
        return L3, _gain_solve_lower(L1, L21), L1

    factorization.blocks = blocks
    return factorization
