"""Blocked Householder LQ and QR with hand-written CUDA panel kernels.

Counterpart of :mod:`pnmol_tpu.ops.qr_householder`, in two halves.

The LQ half (the ``factorization="householder"`` path) is the same
compact-WY blocked Householder LQ: each ``(block, cols)``
row panel is factorized by ONE panel-kernel launch (:func:`panel_lq`, which
replaces the TPU kernels ``_block_lq_kernel`` and ``_leaf_lq_kernel``), and
the rows below take the panel's reflectors as one rank-``block`` trailing
update ``W - (W V^T) T V``, two plain matrix products.

The sweep is the plain shrinking block loop (the JAX ``superblocks = nb``
form): after each panel the work matrix drops the panel's rows and columns,
so every panel starts at diagonal offset 0. The TPU-only machinery of the
JAX sweep (Mosaic lane quantization, scan superblocks, liveness barriers,
leaf panels and their merge) has no counterpart here.

The R-form half (:func:`blocked_qr_r` and the step hook
:func:`make_householder_factorization`) is the tall blocked Householder QR:
each ``(rows, leaf)`` column slab is factorized by ONE leaf launch
(:func:`leaf_qr`, which replaces the TPU kernel ``_leaf_kernel``), leaves
are merged into one block-wide compact WY, and the columns right of the
block take one rank-``block`` trailing update ``A - V T^T (V^T A)``. The
TPU-only row quantization, zero-row padding and liveness barriers of the
JAX sweep have no counterpart here. A tall slab's QR is the panel LQ of its
transpose, transposed, so the leaf launch runs the panel kernel on the tall
layout, spread over the SMs by the same rule.

On a CPU tensor :func:`panel_lq` and :func:`leaf_qr` run their plain PyTorch
versions :func:`panel_lq_reference` and :func:`leaf_qr_reference`; on a CUDA
tensor they launch the panel kernel (built with ``nvcc`` from
``csrc/panel_lq.cu`` at first use) or raise.
"""

import ctypes
from typing import NamedTuple

import torch

from pnmol_tpu_torch.ops import cuda_build

# ctypes types of the panel kernel's own arguments: slab, lv, tT, scratch,
# barrier count (device pointers), rows, cols, off, ctas, width, registers
_PANEL_LQ_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6
# dynamic shared memory one block may use on Hopper (227 KB)
SHARED_BYTES_PER_CTA = 232448
# the tall layout's: slab, vr, T, scratch, barrier count (device pointers),
# rows, cols, ctas, width, registers
_LEAF_QR_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5
# most columns one leaf launch takes: the panel kernel's rows with the chunk
# in registers (PANEL_REGISTER_ROWS)
LEAF_QR_MAX_COLS = 128


# ---------------------------------------------------------------------------
# Panel kernel: plain version and dispatch
# ---------------------------------------------------------------------------


def _reflector_scalars(alpha, tail):
    """``(beta, 1 / (alpha - beta), tau)`` of the reflector that maps
    ``[alpha, tail]`` to ``beta e_0``, with the TPU kernels' numerics:
    ``beta = -sign(alpha) ||x||`` (sign(0) = +1), ``tau = (beta - alpha) /
    beta``, a zero vector gives the identity (tau = 0), no rescaling."""
    norm = torch.sqrt(alpha * alpha + torch.sum(tail**2))
    beta = -torch.where(alpha >= 0, 1.0, -1.0).to(alpha.dtype) * norm
    safe = norm > 0
    inv_denom = torch.where(safe, 1.0 / torch.where(safe, alpha - beta, 1.0), 0.0)
    tau = torch.where(safe, (beta - alpha) / torch.where(safe, beta, 1.0), 0.0)
    return beta, inv_denom, tau


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
        beta, inv_denom, tau = _reflector_scalars(x[d], x[d + 1:])
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


# the panel kernel's launch rule: about this many columns per column CTA,
# and at least this many CTAs (measured on an H100, see PERF.md)
PANEL_COLS_PER_CTA = 120
PANEL_MIN_CTAS = 32
# a column CTA keeps its chunk in registers if it has at most 128 rows of
# 128 columns (4 x 4 values a thread), else in LV in global memory
PANEL_REGISTER_ROWS = PANEL_REGISTER_WIDTH = 128


class PanelLaunch(NamedTuple):
    """How one panel-kernel launch splits a ``(rows, cols)`` panel: ``ctas``
    cooperative column CTAs of ``width`` consecutive columns (the last may
    be narrower; one more CTA forms T^T), whether each CTA keeps its chunk
    in ``registers`` (else in LV), and the dynamic ``shared_bytes`` of each
    CTA."""

    ctas: int
    width: int
    registers: bool
    shared_bytes: int


def panel_lq_shared_bytes(rows, width, registers, itemsize):
    """Dynamic shared memory of one CTA, as ``csrc/panel_lq.cu`` sizes it:
    a column CTA's rows k and k + 1 (chunk in ``registers``), v, tau s, q, a
    and 1024 partial sums of q; the T^T CTA's T^T (row stride ``rows + 1``)
    and one z row."""
    loop = (2 * width if registers else 0) + width + 3 * rows + 1024
    return max(loop, rows * (rows + 2)) * itemsize


def panel_lq_geometry(rows, cols, ctas, itemsize):
    """The launch shape of one panel on about ``ctas`` column CTAs (see
    :class:`PanelLaunch`): the count is rounded so that every CTA holds at
    least one column, and the chunk goes to registers where it fits."""
    ctas = max(1, min(ctas, cols))
    width = -(-cols // ctas)
    registers = rows <= PANEL_REGISTER_ROWS and width <= PANEL_REGISTER_WIDTH
    return PanelLaunch(-(-cols // width), width, registers,
                       panel_lq_shared_bytes(rows, width, registers, itemsize))


def panel_lq_launch(rows, cols, itemsize, num_sms):
    """The launch shape the wrapper uses for one panel.

    The rule: about ``PANEL_COLS_PER_CTA`` columns per CTA in steps of 8
    CTAs, at least ``PANEL_MIN_CTAS`` CTAs and at most ``num_sms - 1`` (the
    T^T CTA takes the last SM). Every CTA sums all CTAs' partials each
    reflector, so more CTAs cost more L2 reads; fewer cost longer passes
    over each chunk.
    """
    ctas = max(PANEL_MIN_CTAS, 8 * -(-cols // (8 * PANEL_COLS_PER_CTA)))
    return panel_lq_geometry(rows, cols, min(ctas, num_sms - 1), itemsize)


def panel_lq(slab, off):
    """Householder LQ of one wide panel (see :func:`panel_lq_reference`).

    CPU tensors take the plain version. CUDA tensors launch the kernel of
    ``csrc/panel_lq.cu`` on the current stream (no synchronization), with
    the shape of :func:`panel_lq_launch`, and add one to
    ``panel_lq.launches``; anything the kernel does not take raises.
    """
    if slab.device.type == "cpu":
        return panel_lq_reference(slab, off)
    _check_panel(slab, off)
    num_sms = torch.cuda.get_device_properties(slab.device).multi_processor_count
    rows, cols = slab.shape
    return _launch_panel_lq(slab, off, panel_lq_launch(rows, cols, slab.element_size(), num_sms))


def _check_panel(slab, off):
    cuda_build.check_input("panel_lq", slab)
    rows, cols = slab.shape
    if rows < 1 or off < 0 or rows > cols - off:
        raise ValueError(
            f"panel_lq: need 1 <= rows <= cols - off, got rows={rows}, "
            f"cols={cols}, off={off}"
        )


def _run_panel_kernel(symbol, argtypes, slab, reflectors, launch, *sizes):
    """Launch the panel kernel's entry point ``symbol`` on a CUDA ``slab``
    whose LQ has ``reflectors`` rows, with the shape ``launch``: the output
    (like ``slab``), the ``(reflectors, reflectors)`` factor, the scratch and
    the barrier count are allocated here, ``sizes`` go between the pointers
    and the launch shape. Raises what the kernel does not take."""
    if launch.shared_bytes > SHARED_BYTES_PER_CTA:
        raise ValueError(f"{symbol}: a {tuple(slab.shape)} slab needs {launch.shared_bytes} "
                         f"bytes of shared memory per CTA, more than {SHARED_BYTES_PER_CTA}")
    out = torch.empty_like(slab)
    factor = torch.empty((reflectors, reflectors), dtype=slab.dtype, device=slab.device)
    scratch = torch.empty(((2 * launch.ctas + 3 + reflectors) * reflectors,),
                          dtype=slab.dtype, device=slab.device)
    count = torch.empty((1,), dtype=torch.int32, device=slab.device)
    cuda_build.launch(
        "panel_lq", symbol, argtypes, slab,
        slab.data_ptr(), out.data_ptr(), factor.data_ptr(), scratch.data_ptr(), count.data_ptr(),
        *sizes, launch.ctas, launch.width, int(launch.registers),
    )
    return out, factor


def _launch_panel_lq(slab, off, launch):
    """Launch the panel kernel on a CUDA ``slab`` with the shape ``launch``
    (:func:`panel_lq`'s, or another CTA count's for timing) and add one to
    ``panel_lq.launches``; raise what the kernel does not take."""
    off = int(off)
    _check_panel(slab, off)
    rows, cols = slab.shape
    lv, tT = _run_panel_kernel("panel_lq", _PANEL_LQ_ARGS, slab, rows, launch, rows, cols, off)
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


# ---------------------------------------------------------------------------
# R form: leaf kernel, tall blocked QR and its step hook
# ---------------------------------------------------------------------------


def leaf_qr_reference(slab):
    """Plain PyTorch version of the leaf kernel: unblocked Householder QR.

    ``slab`` (rows, leaf), rows >= leaf, the diagonal of column k at row k.
    Returns ``(VR (rows, leaf), T (leaf, leaf))`` with the TPU kernel's
    contract: R in the upper triangle of the top square, reflector tails
    below it (unit diagonal implicit), and T upper triangular with tau on
    the diagonal for ``Q = H_0 H_1 ... = I - V T V^T``.
    """
    rows, leaf = slab.shape
    vr = slab.clone()
    t = slab.new_zeros((leaf, leaf))
    for k in range(leaf):
        x = vr[:, k].clone()
        beta, inv_denom, tau = _reflector_scalars(x[k], x[k + 1:])
        v = torch.zeros_like(x)
        v[k] = 1.0
        v[k + 1:] = x[k + 1:] * inv_denom
        s = v @ vr  # columns < k: z = V_{<k}^T v_k; columns > k: update weights
        vr[:, k + 1:] -= v[:, None] * (tau * s[k + 1:])
        vr[k, k] = beta
        vr[k + 1:, k] = v[k + 1:]
        t[:k, k] = -tau * (t[:k, :k] @ s[:k])
        t[k, k] = tau
    return vr, t


def leaf_qr_launch(rows, cols, itemsize, num_sms):
    """The launch shape of one ``(rows, cols)`` tall slab: the panel rule
    (:func:`panel_lq_launch`) on the transposed sizes, so each CTA holds
    ``width`` consecutive rows of the slab (32 CTAs of 113 rows at 3586
    rows, 56 of 119 at 6658)."""
    return panel_lq_launch(cols, rows, itemsize, num_sms)


def leaf_qr(slab):
    """Householder QR of one tall leaf slab (see :func:`leaf_qr_reference`).

    CPU tensors take the plain version. CUDA tensors launch the panel kernel
    of ``csrc/panel_lq.cu`` on the tall layout on the current stream (no
    synchronization), with the shape of :func:`leaf_qr_launch`, and add one
    to ``leaf_qr.launches`` (never to ``panel_lq.launches``); the kernel
    takes 1 <= leaf <= 128 columns and rows >= leaf, and anything else
    raises.
    """
    if slab.device.type == "cpu":
        return leaf_qr_reference(slab)
    _check_leaf(slab)
    num_sms = torch.cuda.get_device_properties(slab.device).multi_processor_count
    rows, cols = slab.shape
    return _launch_leaf_qr(slab, leaf_qr_launch(rows, cols, slab.element_size(), num_sms))


def _check_leaf(slab):
    cuda_build.check_input("leaf_qr", slab)
    rows, cols = slab.shape
    if not 1 <= cols <= min(rows, LEAF_QR_MAX_COLS):
        raise ValueError(
            f"leaf_qr: need 1 <= cols <= min(rows, {LEAF_QR_MAX_COLS}), got "
            f"rows={rows}, cols={cols}"
        )


def _launch_leaf_qr(slab, launch):
    """Launch the tall layout on a CUDA ``slab`` with the shape ``launch``
    (:func:`leaf_qr`'s, or another CTA count's for timing) and add one to
    ``leaf_qr.launches``; raise what the kernel does not take."""
    _check_leaf(slab)
    rows, cols = slab.shape
    vr, t = _run_panel_kernel("leaf_qr", _LEAF_QR_ARGS, slab, cols, launch, rows, cols)
    leaf_qr.launches += 1
    return vr, t


leaf_qr.launches = 0


def _apply_wy_transpose(V, T, A):
    """``Q^T A = A - V T^T (V^T A)`` for ``Q = I - V T V^T``."""
    return A - V @ (T.T @ (V.T @ A))


def blocked_qr_r(A, *, leaf: int = 32, block: int = 128):
    """Upper-triangular R of a Householder QR of tall ``A`` (M >= N), shape
    (N, N), with ``R^T R = A^T A``.

    One :func:`leaf_qr` call per ``leaf`` columns (``ceil(N / block)`` blocks
    of ``ceil(block / leaf)`` leaves; the last leaf of the last block may be
    narrower). Within a block each leaf's reflectors update the block's
    later columns; the leaves are then merged into one compact WY
    ``[[T1, -T1 V1^T V2 T2], [0, T2]]`` and the columns right of the block
    take one trailing update. The reflector convention (``beta =
    -sign(alpha) ||x||``) is the JAX package's, so R agrees with
    :func:`pnmol_tpu.ops.qr_householder.blocked_qr_r` entry by entry where
    the columns are independent.
    """
    M, N = A.shape
    if M < N:
        raise ValueError(f"blocked_qr_r requires M >= N, got {tuple(A.shape)}")
    block = max(block, leaf)
    R = A.new_zeros((N, N))
    work = A
    done = 0
    while done < N:
        width = min(block, N - done)
        rows_w = work.shape[0]
        blk = work[:, :width].clone()
        V = A.new_zeros((rows_w, width))
        T = A.new_zeros((width, width))
        # each leaf: few, large ops, since the host issues them one by one
        for jl in range(0, width, leaf):
            cols = slice(jl, min(jl + leaf, width))
            vr, t = leaf_qr(blk[jl:, cols].contiguous())
            blk[jl:cols.stop, cols] = vr[:cols.stop - jl]  # R's rows; the tails go to V
            v = V[jl:, cols]  # reflector columns, unit diagonal
            v.copy_(torch.tril(vr, -1))
            v.diagonal().fill_(1.0)
            if cols.stop < width:  # Q^T A = A - V T^T (V^T A) on the block's later columns
                rest = blk[jl:, cols.stop:]
                rest -= v @ (t.T @ (v.T @ rest))
            T[cols, cols] = t
            if jl:  # merge: T12 = -T1 (V1^T V2) T2, V2 zero above row jl
                T[:jl, cols].addmm_(T[:jl, :jl] @ (V[jl:, :jl].T @ v), t, beta=0, alpha=-1)
        R[done:done + width, done:done + width] = torch.triu(blk[:width])
        trail = work[:, width:]
        if trail.shape[1]:
            trail = _apply_wy_transpose(V, T, trail)
            R[done:done + width, done + width:] = trail[:width]
            work = trail[width:]
        done += width
    return R


def make_householder_factorization(*, leaf: int = 32, block: int = 128):
    """A ``factorization=`` hook for the white-noise step: the tall
    pre-array ``[[HACl^T, ACl^T], [HQl^T, Ql^T], [E^T, 0]]`` of shape
    ``(2D + m, m + D)`` factorized by :func:`blocked_qr_r`.

    The legacy gain contract of the JAX hook
    (:func:`pnmol_tpu.ops.qr_householder.make_householder_factorization`):
    ``(HACl, ACl, HQl, Ql, R) -> (posterior_factor, gain,
    innovation_factor)`` = ``(R3^T, (R1^{-1} R2)^T, R1^T)``. It has no
    ``.blocks``, so the step updates the mean with the explicit gain.
    """

    def factorization(HACl, ACl, HQl, Ql, meascov_sqrtm):
        m, D = HACl.shape
        top = torch.cat((HACl.T, ACl.T), dim=1)
        mid = torch.cat((HQl.T, Ql.T), dim=1)
        bottom = torch.cat((meascov_sqrtm.T, HACl.new_zeros((m, D))), dim=1)
        R = blocked_qr_r(torch.cat((top, mid, bottom), dim=0), leaf=leaf, block=block)
        R1, R2, R3 = R[:m, :m], R[:m, m:], R[m:, m:]
        gain = torch.linalg.solve_triangular(R1, R2, upper=True).T
        return R3.T, gain, R1.T

    return factorization
