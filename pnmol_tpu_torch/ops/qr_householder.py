"""Blocked Householder LQ and QR with hand-written CUDA panel kernels.

Counterpart of :mod:`pnmol_tpu.ops.qr_householder`, in two halves.

The LQ half (the ``factorization="householder"`` path) is the same
compact-WY blocked Householder LQ, swept one ``block`` of rows at a time.
A block is factorized by one of two routes:

* the block route: ONE panel-kernel launch on the ``(block, cols)`` panel
  (:func:`panel_lq`, which replaces the TPU kernel ``_block_lq_kernel``);
* the leaf route: one launch of the same kernel per ``leaf`` rows
  (:func:`leaf_lq`, which replaces the TPU kernel ``_leaf_lq_kernel``), the
  block's later rows taking each leaf's reflectors, then the leaves' T^T
  merged into the block's.

Either way the rows below take the block's reflectors as one rank-``block``
trailing update ``W - (W V^T) T V``, two plain matrix products, at the
hooks' ``precision`` (:func:`matmul_precision`: full FP32, or TF32 for an
f32 sweep on the card). The sweep is
the plain shrinking block loop (the JAX ``superblocks = nb`` form), in place
on one work buffer: after each block the work view drops the block's rows
and columns, so every block starts at diagonal offset 0, and a banded input
(``band=``) windows each block's work to the declared row support. The
TPU-only machinery of the JAX sweep (Mosaic lane quantization, scan
superblocks, liveness barriers) has no counterpart here.

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

On a CPU tensor :func:`panel_lq`, :func:`leaf_lq` and :func:`leaf_qr` run
their plain PyTorch versions :func:`panel_lq_reference` and
:func:`leaf_qr_reference`; on a CUDA tensor they launch the panel kernel
(built with ``nvcc`` from ``csrc/panel_lq.cu`` at first use) or raise. The
kernel has no backward (nor have the TPU kernels a VJP): where autograd
records through a slab, all three raise on either device, naming the plain
factorization that differentiates.
"""

import contextlib
import ctypes
from typing import NamedTuple

import torch

from pnmol_tpu_torch.ops import cuda_build
from pnmol_tpu_torch.utils.profiling import annotate

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


def _no_backward(name, slab):
    """Raise where autograd records through ``slab``: the kernel routes have
    no backward."""
    if torch.is_grad_enabled() and slab.requires_grad:
        raise RuntimeError(
            f"{name}: the CUDA panel kernel has no backward; for gradients take the "
            "plain factorization (factorization=None: torch.linalg.qr)"
        )


def panel_lq(slab, off):
    """Householder LQ of one wide panel (see :func:`panel_lq_reference`).

    CPU tensors take the plain version. CUDA tensors launch the kernel of
    ``csrc/panel_lq.cu`` on the current stream (no synchronization), with
    the shape of :func:`panel_lq_launch`, and add one to
    ``panel_lq.launches``; anything the kernel does not take raises, and so
    does a slab that autograd records through.
    """
    with annotate("pnmol.kernel.panel_lq"):
        _no_backward("panel_lq", slab)
        if slab.device.type == "cpu":
            return panel_lq_reference(slab, off)
        _check_panel(slab, off)
        num_sms = torch.cuda.get_device_properties(slab.device).multi_processor_count
        rows, cols = slab.shape
        return _launch_panel_lq(slab, off,
                                panel_lq_launch(rows, cols, slab.element_size(), num_sms))


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


def _launch_wide(slab, off, launch):
    """One launch of the panel kernel on a CUDA ``slab`` with the shape
    ``launch``, counted by the caller; raise what the kernel does not take."""
    off = int(off)
    _check_panel(slab, off)
    rows, cols = slab.shape
    return _run_panel_kernel("panel_lq", _PANEL_LQ_ARGS, slab, rows, launch, rows, cols, off)


def _launch_panel_lq(slab, off, launch):
    """Launch the panel kernel on a CUDA ``slab`` with the shape ``launch``
    (:func:`panel_lq`'s, or another CTA count's for timing) and add one to
    ``panel_lq.launches``; raise what the kernel does not take."""
    lv, tT = _launch_wide(slab, off, launch)
    panel_lq.launches += 1
    return lv, tT


panel_lq.launches = 0


def leaf_lq(slab, off):
    """Householder LQ of one leaf of the leaf route: a ``(leaf, cols)`` slab
    whose diagonal starts at lane ``off`` (see :func:`panel_lq_reference`).

    The same kernel as :func:`panel_lq` (the port of the TPU kernel
    ``_leaf_lq_kernel``), launched with the shape of
    :func:`panel_lq_launch`, but counted apart: a CUDA launch adds one to
    ``leaf_lq.launches`` and never to ``panel_lq.launches``. CPU tensors take
    the plain version; anything the kernel does not take raises, and so does
    a slab that autograd records through.
    """
    with annotate("pnmol.kernel.leaf_lq"):
        _no_backward("leaf_lq", slab)
        if slab.device.type == "cpu":
            return panel_lq_reference(slab, off)
        _check_panel(slab, off)
        num_sms = torch.cuda.get_device_properties(slab.device).multi_processor_count
        rows, cols = slab.shape
        lv, tT = _launch_wide(slab, off,
                              panel_lq_launch(rows, cols, slab.element_size(), num_sms))
        leaf_lq.launches += 1
        return lv, tT


leaf_lq.launches = 0


# ---------------------------------------------------------------------------
# Blocked sweep and factorization hooks
# ---------------------------------------------------------------------------


# the trailing updates' matrix-product precision, the JAX hooks' argument:
# "highest" (the default) runs full-FP32 cuBLAS products; "high" and
# "default" let an f32 sweep on the card take TF32 tensor-core products, the
# card's counterpart of the TPU's fewer bf16 passes. f64, and the CPU, have
# one precision, as in the JAX package.
PRECISIONS = ("default", "high", "highest")


def _check_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


@contextlib.contextmanager
def matmul_precision(precision, tensor):
    """Scope the trailing updates of one sweep on ``tensor`` to
    ``precision``: for a CUDA float32 ``tensor`` cuBLAS may take TF32
    exactly where ``precision`` is not ``"highest"``, and the setting before
    the sweep comes back after it; otherwise nothing changes."""
    _check_precision(precision)
    if not (tensor.is_cuda and tensor.dtype == torch.float32):
        yield
        return
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision != "highest"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def _reflectors(lv, off=0):
    """Reflector rows (unit diagonal explicit) of a panel output whose
    diagonal starts at lane ``off``."""
    V = torch.triu(lv, diagonal=off + 1)
    V.diagonal(off).fill_(1.0)
    return V


def panel_takes_rows(rows, itemsize):
    """Whether one panel-kernel launch takes a panel of ``rows`` rows: its
    T^T CTA holds ``rows x (rows + 2)`` values in shared memory
    (:func:`panel_lq_shared_bytes`), so at most 169 rows in f64 and 240 in
    f32."""
    return rows * (rows + 2) * itemsize <= SHARED_BYTES_PER_CTA


def _leaf_route(blk, leaf):
    """One block ``blk`` (b, cols), diagonal at lane 0, factorized leaf by
    leaf (the leaf branch of the JAX ``_blocked_lq_l_impl``): one
    :func:`leaf_lq` per ``leaf`` rows, its slab's diagonal at lane ``jl``;
    the block's later rows take each leaf's reflectors; the leaves' T^T merge
    as ``T^T12 = -T2^T (V1 V2^T)^T T1^T``. Returns ``(LV, V, T^T)``: LV and
    T^T with the contract of :func:`panel_lq` on the whole block, V its
    reflector rows."""
    b = blk.shape[0]
    lv = blk.clone()
    V = torch.zeros_like(blk)
    tT = blk.new_zeros((b, b))
    for jl in range(0, b, leaf):
        je = min(jl + leaf, b)
        leaf_lv, t = leaf_lq(lv[jl:je], jl)
        lv[jl:je] = leaf_lv
        v = V[jl:je]
        v.copy_(_reflectors(leaf_lv, jl))
        if je < b:  # U T V with U = rest V^T, and t = T^T
            rest = lv[je:]
            rest.addmm_((rest @ v.T) @ t.T, v, alpha=-1)
        tT[jl:je, jl:je] = t
        if jl:
            tT[jl:je, :jl] = -(t @ (V[:jl] @ v.T).T) @ tT[:jl, :jl]
    return lv, V, tT


def _lq_in_place(work, *, leaf, block, band, precision="highest"):
    """:func:`blocked_lq_l`'s sweep on ``work``, which it overwrites: one
    ``pnmol.lq.sweep`` span, each block's trailing update a
    ``pnmol.lq.trailing`` span inside it."""
    Nr, M = work.shape
    if M < Nr:
        raise ValueError(f"blocked_lq_l requires cols >= rows, got {tuple(work.shape)}")
    leaves = not panel_takes_rows(block, work.element_size())
    done = 0
    with annotate("pnmol.lq.sweep"):
        with matmul_precision(precision, work):
            while done < Nr:
                b = min(block, Nr - done)
                # the block's window: every column past it is an exact zero of
                # the block's rows (band=), so the reflectors never touch it
                win = M - done
                if band is not None:
                    win = min(win, band[0] + (band[1] - 1) * done + band[1] * b)
                blk = work[done:done + b, done:done + win].contiguous()
                if leaves:
                    lv, V, tT = _leaf_route(blk, leaf)
                else:
                    lv, tT = panel_lq(blk, 0)
                    V = _reflectors(lv)
                work[done:done + b, done:done + b] = lv[:, :b]
                rest = work[done + b:, done:done + win]
                if rest.shape[0]:  # in place; its first b columns become L's
                    with annotate("pnmol.lq.trailing"):
                        rest.addmm_((rest @ V.T) @ tT.T, V, alpha=-1)
                done += b
        return torch.tril(work[:, :Nr])


def blocked_lq_l(W, *, leaf: int = 32, block: int = 128, band=None,
                 precision: str = "highest"):
    """Lower-triangular L with ``L L^T = W W^T`` from one Householder LQ of
    wide ``W`` (rows <= cols), shape (rows, rows).

    ``ceil(rows / block)`` blocks, each factorized by the block route (one
    :func:`panel_lq`) or the leaf route (one :func:`leaf_lq` per ``leaf``
    rows, ``ceil(b / leaf)`` for a block of b rows), then the trailing
    update of the rows below. The sweep takes the block route wherever the
    panel kernel takes ``block`` rows (:func:`panel_takes_rows`: 128 does,
    256 does not) and the leaf route otherwise, for every block of the
    sweep. (The JAX sweep picks by the slab's bytes, a limit of the TPU's
    VMEM that means nothing on the GPU; here the limit is the shared memory
    of the kernel's T^T CTA.)

    ``band=(b0, slope)`` declares that row ``r`` of ``W`` has exact zeros in
    every column ``>= b0 + slope * r`` (the caller guarantees it): each
    block's work is then windowed to its rows' support and the columns past
    it stay untouched, which changes the result only by rounding.

    ``precision`` is the trailing updates' (:func:`matmul_precision`).

    The signs of L's diagonal follow the reflectors' convention (``beta =
    -sign(alpha) ||x||``), as in :func:`pnmol_tpu.ops.qr_householder.blocked_lq_l`.
    """
    return _lq_in_place(W.clone(), leaf=leaf, block=block, band=band, precision=precision)


def _gain_solve_lower(L1, L21):
    """gain = L21 L1^{-1}, via L1^T X = L21^T."""
    return torch.linalg.solve_triangular(L1.T, L21.T, upper=True).T


def _check_pair_columns(pair_columns):
    if pair_columns:
        raise NotImplementedError(
            "pair_columns is not ported: it was measured slower on the TPU "
            "and is off by default (ROADMAP, 'Not to port')"
        )


def _lq_blocks(top, bottom, m, band, sweep):
    """``(L3, L21, L1)`` of the LQ of the fresh pre-array ``[top; bottom]``
    (m top rows), swept in place."""
    L = _lq_in_place(torch.cat((top, bottom), dim=0), band=band, **sweep)
    return L[m:, m:], L[m:, :m], L[:m, :m]


def make_householder_update_from_products(*, leaf: int = 32, block: int = 128,
                                          pair_columns: bool = False,
                                          precision: str = "highest"):
    """Householder-LQ drop-in for the sqrt update from products:
    ``(HC, C, R) -> (posterior_factor, gain, innovation_factor)`` through the
    LQ of ``[[HC, R], [C, 0]]`` (sweep options and ``precision`` as in
    :func:`blocked_lq_l`).
    ``.blocks`` returns the raw factor blocks ``(L3, L21, L1)`` without the
    gain solve; ``.blocks_banded`` the same for a LOWER-TRIANGULAR ``R``
    (true for every measurement-noise factor of the solvers), whose
    pre-array rows end at column ``D + i``: ``band=(D + 1, 1)``."""
    _check_pair_columns(pair_columns)
    _check_precision(precision)
    sweep = dict(leaf=leaf, block=block, precision=precision)

    def _blocks(HC, C, meascov_sqrtm, band):
        m, D = HC.shape
        top = torch.cat((HC, meascov_sqrtm), dim=1)
        bottom = torch.cat((C, C.new_zeros((D, m))), dim=1)
        return _lq_blocks(top, bottom, m, band, sweep)

    def blocks(HC, C, meascov_sqrtm):
        return _blocks(HC, C, meascov_sqrtm, None)

    def blocks_banded(HC, C, meascov_sqrtm):
        return _blocks(HC, C, meascov_sqrtm, (HC.shape[1] + 1, 1))

    def update(HC, C, meascov_sqrtm):
        L3, L21, L1 = blocks(HC, C, meascov_sqrtm)
        return L3, _gain_solve_lower(L1, L21), L1

    update.blocks = blocks
    update.blocks_banded = blocks_banded
    return update


def make_householder_propagate(*, leaf: int = 32, block: int = 128,
                               pair_columns: bool = False,
                               precision: str = "highest"):
    """Householder-LQ drop-in for the sqrt propagate: the lower factor of
    ``S1 S1^T + S2 S2^T`` from one LQ of ``[S1 S2]`` (sweep options and
    ``precision`` as in :func:`blocked_lq_l`), with two structured variants:

    * ``.banded(S1, S2)`` for a LOWER-TRIANGULAR ``S2`` (the point-major
      process-noise factor): row ``r`` ends at column ``D1 + r``,
      ``band=(D1 + 1, 1)``;
    * ``.interleaved(S1, S2, q)`` for ``S1`` also block-banded in ``q x q``
      point blocks (``A Cl`` with ``Cl`` lower-triangular): the two
      factors' point blocks interleaved by a column gather give row support
      ``<= 2 r + q``, ``band=(2 q, 2)``.
    """
    _check_pair_columns(pair_columns)
    _check_precision(precision)
    sweep = dict(leaf=leaf, block=block, precision=precision)

    def propagate(S1, S2):
        return _lq_in_place(torch.cat((S1, S2), dim=1), band=None, **sweep)

    def banded(S1, S2):
        return _lq_in_place(torch.cat((S1, S2), dim=1), band=(S1.shape[1] + 1, 1), **sweep)

    def interleaved(S1, S2, q):
        D1 = S1.shape[1]
        idx = (torch.arange(D1 // q, device=S1.device)[:, None] * q
               + torch.arange(q, device=S1.device)[None, :])
        perm = torch.cat((idx, D1 + idx), dim=1).reshape(-1)
        return _lq_in_place(torch.cat((S1, S2), dim=1)[:, perm], band=(2 * q, 2), **sweep)

    propagate.banded = banded
    propagate.interleaved = interleaved
    return propagate


def make_householder_lq_factorization(*, leaf: int = 32, block: int = 128,
                                      pair_columns: bool = False,
                                      precision: str = "highest"):
    """A ``factorization=`` hook for the white-noise step: the fused
    pre-array ``W = [[HACl, HQl, E], [ACl, Ql, 0]]`` factorized by
    :func:`blocked_lq_l` (sweep options and ``precision`` as there). Same
    contract as the fused predict-update ``(HACl, ACl, HQl, Ql, R) ->
    (posterior_factor, gain, innovation_factor)``; ``.blocks`` returns ``(L3, L21, L1)``
    without the gain solve (the step only needs ``K z = L21 (L1^{-1} z)``),
    ``.blocks_banded`` the same for a LOWER-TRIANGULAR ``R``
    (``band=(2D + 1, 1)``).

    The two-QR pipeline's primitives ride along: ``.propagate``
    (:func:`make_householder_propagate`), ``.update_from_products``
    (:func:`make_householder_update_from_products`), and ``.tri(C)``, the
    lower factor with ``C``'s Gram, with which the solvers re-triangularize
    the initial factor for the interleaved propagate.
    """
    _check_pair_columns(pair_columns)
    _check_precision(precision)
    sweep = dict(leaf=leaf, block=block, precision=precision)

    def _blocks(HACl, ACl, HQl, Ql, meascov_sqrtm, band):
        # the pre-array written into one buffer, without concatenated halves
        # beside it at the step's high-water mark
        m, D = HACl.shape
        work = HACl.new_empty((m + D, 2 * D + m))
        top, bottom = work[:m], work[m:]
        top[:, :D], top[:, D:2 * D], top[:, 2 * D:] = HACl, HQl, meascov_sqrtm
        bottom[:, :D], bottom[:, D:2 * D], bottom[:, 2 * D:] = ACl, Ql, 0.0
        L = _lq_in_place(work, band=band, **sweep)
        return L[m:, m:], L[m:, :m], L[:m, :m]

    def blocks(HACl, ACl, HQl, Ql, meascov_sqrtm):
        return _blocks(HACl, ACl, HQl, Ql, meascov_sqrtm, None)

    def blocks_banded(HACl, ACl, HQl, Ql, meascov_sqrtm):
        return _blocks(HACl, ACl, HQl, Ql, meascov_sqrtm, (2 * HACl.shape[1] + 1, 1))

    def factorization(HACl, ACl, HQl, Ql, meascov_sqrtm):
        L3, L21, L1 = blocks(HACl, ACl, HQl, Ql, meascov_sqrtm)
        return L3, _gain_solve_lower(L1, L21), L1

    def tri(C):
        return blocked_lq_l(C, **sweep)

    factorization.blocks = blocks
    factorization.blocks_banded = blocks_banded
    factorization.tri = tri
    factorization.propagate = make_householder_propagate(**sweep)
    factorization.update_from_products = make_householder_update_from_products(**sweep)
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
    raises, as does a slab that autograd records through.
    """
    with annotate("pnmol.kernel.leaf_qr"):
        _no_backward("leaf_qr", slab)
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


def blocked_qr_r(A, *, leaf: int = 32, block: int = 128, precision: str = "highest"):
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
    the columns are independent. ``precision`` is the updates' matrix
    products' (:func:`matmul_precision`).
    """
    M, N = A.shape
    if M < N:
        raise ValueError(f"blocked_qr_r requires M >= N, got {tuple(A.shape)}")
    with matmul_precision(precision, A):
        return _qr_r_sweep(A, M, N, leaf=leaf, block=block)


def _qr_r_sweep(A, M, N, *, leaf, block):
    """:func:`blocked_qr_r`'s sweep."""
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


def make_householder_factorization(*, leaf: int = 32, block: int = 128,
                                   precision: str = "highest"):
    """A ``factorization=`` hook for the white-noise step: the tall
    pre-array ``[[HACl^T, ACl^T], [HQl^T, Ql^T], [E^T, 0]]`` of shape
    ``(2D + m, m + D)`` factorized by :func:`blocked_qr_r` (its options
    and ``precision``).

    The legacy gain contract of the JAX hook
    (:func:`pnmol_tpu.ops.qr_householder.make_householder_factorization`):
    ``(HACl, ACl, HQl, Ql, R) -> (posterior_factor, gain,
    innovation_factor)`` = ``(R3^T, (R1^{-1} R2)^T, R1^T)``. It has no
    ``.blocks``, so the step updates the mean with the explicit gain.
    """
    _check_precision(precision)

    def factorization(HACl, ACl, HQl, Ql, meascov_sqrtm):
        m, D = HACl.shape
        top = torch.cat((HACl.T, ACl.T), dim=1)
        mid = torch.cat((HQl.T, Ql.T), dim=1)
        bottom = torch.cat((meascov_sqrtm.T, HACl.new_zeros((m, D))), dim=1)
        R = blocked_qr_r(torch.cat((top, mid, bottom), dim=0), leaf=leaf, block=block,
                         precision=precision)
        R1, R2, R3 = R[:m, :m], R[:m, m:], R[m:, m:]
        gain = torch.linalg.solve_triangular(R1, R2, upper=True).T
        return R3.T, gain, R1.T

    return factorization
