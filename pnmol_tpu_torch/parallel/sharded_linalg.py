"""Sharded Gram assembly and large-N linear algebra over a rank mesh.

Counterpart of :mod:`pnmol_tpu.parallel.sharded_linalg`, as explicit SPMD:
every function runs on each rank with that rank's block of each sharded
operand, and every collective is one of the mesh's (``psum``,
``all_gather``, ``ppermute`` in the ``"schedule"`` region, the counts of
:mod:`pnmol_tpu_torch.utils.comm_model`; layout changes in the ``"layout"``
region). Blocks are the :func:`~pnmol_tpu_torch.parallel.meshes.block_bounds`
blocks unless a function says otherwise.

The factorizations are shifted CholeskyQR3 panels with block Gram-Schmidt
trailing updates (the QR) and right-looking panel Cholesky and substitution
(the SPD solves): matmuls, ``torch.linalg.cholesky`` and triangular solves
on the rank's block, as the JAX tier is MXU matmuls plus XLA's Cholesky.
The panel sweep is one Python loop with a shrinking trailing width (JAX's
``loop="unrolled"``).
"""

import torch

from pnmol_tpu_torch import discretize as discretize_module
from pnmol_tpu_torch import kernels as kernels_module
from pnmol_tpu_torch.ops import sqrt
from pnmol_tpu_torch.parallel import meshes


def _global_rows(x, mesh, axis):
    """Global row count of a row-sharded operand (a layout all-reduce)."""
    n = torch.tensor([float(x.shape[0])], dtype=torch.float64, device=x.device)
    return int(mesh.psum(n, axis, region="layout").item())


def tsqr_r(stacked, mesh, axis="space"):
    """Distributed tall-skinny QR (R factor only) of a row-sharded matrix.

    Each rank QR-factorizes its rows, the (C, C) local R factors ride one
    all-gather, and a second small QR of the stacked R's gives the global R
    (replicated). Raises ``ValueError`` unless ``rows // P >= cols``, as
    the JAX tier does.
    """
    cols = stacked.shape[1]
    P = mesh.shape[axis]
    rows = _global_rows(stacked, mesh, axis)
    if rows // P < cols:
        raise ValueError(
            f"TSQR needs local rows ({rows}//{P}) >= cols ({cols}); "
            "use fewer shards or the dense path."
        )
    r_local = sqrt.triu_qr(stacked)
    gathered = mesh.all_gather(r_local, axis)  # (P, C, C)
    return sqrt.triu_qr(gathered.reshape(-1, cols))


def _cholqr(panel, jitter, mesh, axis):
    """One shifted CholeskyQR round: ``(Q, R)`` with ``R^T R = A^T A +
    jitter * scale * I``, the Gram summed over the ranks. The jitter of an
    exactly rank-deficient panel is floored at ``tiny/eps`` of the scale."""
    b = panel.shape[1]
    dtype = panel.dtype
    gram = mesh.psum(panel.T @ panel, axis)
    finfo = torch.finfo(dtype)
    scale = torch.clamp(torch.trace(gram) / b, min=finfo.tiny / finfo.eps)
    gram.diagonal().add_(jitter * scale)
    r = torch.linalg.cholesky(gram).T  # upper
    q = torch.linalg.solve_triangular(r, panel, upper=True, left=False)
    return q, r


def _panel_qr(block, j0, j1, trailing_stop, mesh, axis, reorthogonalize):
    """Shifted CholeskyQR3 of columns ``j0:j1`` of the rank's rows, and the
    BGS(2) update of the trailing columns ``j1:trailing_stop`` in place.
    Returns the panel's R rows ``(b, trailing_stop - j0)``."""
    eps = torch.finfo(block.dtype).eps
    q, r1 = _cholqr(block[:, j0:j1], eps**0.5, mesh, axis)
    q, r2 = _cholqr(q, 16.0 * eps, mesh, axis)
    q, r3 = _cholqr(q, 16.0 * eps, mesh, axis)
    r_panel = r3 @ (r2 @ r1)
    if j1 >= trailing_stop:
        return r_panel
    trailing = block[:, j1:trailing_stop]
    proj = mesh.psum(q.T @ trailing, axis)
    trailing.addmm_(q, proj, alpha=-1.0)
    if reorthogonalize:  # BGS2: second projection pass
        proj2 = mesh.psum(q.T @ trailing, axis)
        trailing.addmm_(q, proj2, alpha=-1.0)
        proj = proj + proj2
    return torch.cat((r_panel, proj), dim=1)


def blocked_qr_r(stacked, mesh, axis="space", panel_size=None, reorthogonalize=True):
    """Distributed R factor of a row-sharded matrix, replicated.

    A right-looking panel factorization: each column panel is orthogonalized
    by shifted CholeskyQR3 (three Gram + Cholesky rounds, one ``psum`` of a
    (b, b) Gram each) and the trailing columns are updated by block
    Gram-Schmidt (one ``psum`` of a (b, trailing) projection per pass, two
    passes with ``reorthogonalize``). ``R^T R = A^T A`` to roundoff; the
    factor may differ from LAPACK's by row signs. The rows may be split
    over the ranks in any way (zero rows on a rank are fine): only the
    summed Grams and projections enter R.
    """
    cols = stacked.shape[1]
    if panel_size is None:
        panel_size = min(cols, 256)
    block = stacked.clone()
    R = stacked.new_zeros((cols, cols))
    for j0 in range(0, cols, panel_size):
        j1 = min(j0 + panel_size, cols)
        R[j0:j1, j0:] = _panel_qr(block, j0, j1, cols, mesh, axis, reorthogonalize)
    return R


def qr_row_blocks(cols, mesh, axis="space", panel_size=None):
    """``(b, L, blocks)`` of :func:`blocked_qr_r_sharded`: the panel width,
    the rows each rank owns (a multiple of b) and every rank's
    ``(start, stop)`` rows of R."""
    P = mesh.shape[axis]
    L = -(-cols // P)
    if panel_size is None:
        panel_size = min(L, 256)
    b = max(1, min(panel_size, L))
    L = -(-L // b) * b
    return b, L, [(min(q * L, cols), min((q + 1) * L, cols)) for q in range(P)]


def blocked_qr_r_sharded(stacked, mesh, axis="space", panel_size=None, reorthogonalize=True):
    """Distributed R factor with a ROW-SHARDED output.

    The panel factorization of :func:`blocked_qr_r`, with R accumulated
    sharded: rank ``q`` owns rows ``[q L, (q+1) L)`` of the (cols, cols) R
    (:func:`qr_row_blocks`; cols padded to ``P L``, ``L`` a multiple of the
    panel) and only ever holds its own rows, so each panel's R rows have
    exactly one owner. Returns this rank's rows of R (upper-triangular,
    ``R^T R = A^T A``), the input's rows split in any way.
    """
    cols = stacked.shape[1]
    b, L, blocks = qr_row_blocks(cols, mesh, axis, panel_size)
    cols_pad = mesh.shape[axis] * L
    block = stacked.new_zeros((stacked.shape[0], cols_pad))
    block[:, :cols] = stacked
    me = mesh.index[axis]
    R_loc = stacked.new_zeros((L, cols_pad))
    for j0 in range(0, cols_pad, b):
        band = _panel_qr(block, j0, j0 + b, cols_pad, mesh, axis, reorthogonalize)
        if j0 // L == me:
            row0 = j0 - me * L
            R_loc[row0:row0 + b, j0:] = band
    start, stop = blocks[me]
    return R_loc[:stop - start, :cols]


def _chol_pad_geometry(d, mesh, axis, panel_size):
    """(panel b, local rows r_loc, padded dim d_pad) for the panel loops.

    Local rows are rounded to a whole number of panels so every panel's rows
    live on one rank (the panel owner); the panel is clamped to the raw
    local row count first, so ``d_pad`` stays within a panel per rank of
    ``d`` for any P.
    """
    P = mesh.shape[axis]
    r_loc = -(-d // P)
    b = panel_size if panel_size is not None else min(128, max(8, -(-d // (4 * P))))
    b = max(1, min(b, r_loc))
    r_loc = -(-r_loc // b) * b
    return b, r_loc, r_loc * P


def _to_panel_rows(x, n, r_loc, mesh, axis, unit_pad=False):
    """A row-sharded (n, k) operand in the panel layout: rank q holds padded
    rows ``[q r_loc, (q+1) r_loc)`` (a reshard when the blocks differ), pad
    rows zero, or the identity's rows when ``unit_pad`` (and k = n, the pad
    columns added)."""
    P = mesh.shape[axis]
    me = mesh.index[axis]
    panel = [(min(q * r_loc, n), min((q + 1) * r_loc, n)) for q in range(P)]
    x = mesh.reshard_rows(x, meshes.all_block_bounds(n, P), panel, axis)
    width = r_loc * P if unit_pad else x.shape[1]
    out = x.new_zeros((r_loc, width))
    out[:x.shape[0], :x.shape[1]] = x
    if unit_pad:
        rows = torch.arange(me * r_loc, (me + 1) * r_loc, device=x.device)
        pad = rows >= n
        out[pad.nonzero()[:, 0], rows[pad]] = 1.0
    return out


def _from_panel_rows(x, n, r_loc, mesh, axis):
    """Inverse of :func:`_to_panel_rows` (the pad rows and columns dropped)."""
    P = mesh.shape[axis]
    me = mesh.index[axis]
    panel = [(min(q * r_loc, n), min((q + 1) * r_loc, n)) for q in range(P)]
    start, stop = panel[me]
    x = x[:stop - start]
    return mesh.reshard_rows(x, panel, meshes.all_block_bounds(n, P), axis)


def blocked_cholesky(G, mesh, axis="space", panel_size=None):
    """Distributed right-looking blocked Cholesky of a row-sharded SPD matrix.

    ``G`` is this rank's row block of the (d, d) matrix; returns its row
    block of the lower factor. Per panel: the owner's rows ride one ``psum``
    (the others add zeros), the (b, b) diagonal Cholesky runs on every rank,
    the sub-panel solve is row-local, and the trailing update is one rank-b
    local matmul after an ``all_gather`` of the (r_loc, b) column panel.
    Nothing of size O(d^2) is replicated.
    """
    d = G.shape[1]
    b, r_loc, d_pad = _chol_pad_geometry(d, mesh, axis, panel_size)
    A = _to_panel_rows(G, d, r_loc, mesh, axis, unit_pad=True)
    row0 = mesh.index[axis] * r_loc
    for j in range(0, d_pad, b):
        owner = j // r_loc
        off = j - owner * r_loc
        cand = A[off:off + b] if owner == mesh.index[axis] else A.new_zeros((b, d_pad))
        panel_rows = mesh.psum(cand, axis)
        Ljj = torch.linalg.cholesky(panel_rows[:, j:j + b])
        # rows above the panel hold exact zeros in these columns
        Lcols = torch.linalg.solve_triangular(Ljj.T, A[:, j:j + b], upper=True, left=False)
        Lpan = mesh.all_gather(Lcols, axis).reshape(d_pad, b)
        below = min(max(j + b - row0, 0), r_loc)
        A[below:, j + b:].addmm_(Lcols[below:], Lpan[j + b:].T, alpha=-1.0)
        A[below:, j:j + b] = Lcols[below:]
        if owner == mesh.index[axis]:
            A[off:off + b, j:j + b] = torch.tril(Ljj)
            A[off:off + b, j + b:] = 0.0
    return _from_panel_rows(A[:, :d], d, r_loc, mesh, axis)


def blocked_tri_solve_lower(L, B, mesh, axis="space", panel_size=None, transpose=False):
    """Distributed ``L^{-1} B`` (or ``L^{-T} B``) with row-sharded operands.

    ``L`` is this rank's row block of a (d, d) lower-triangular factor and
    ``B`` its row block of a (d, K) right-hand side; returns its row block of
    the solution. Forward substitution walks the panels top-down, backward
    (``transpose``) bottom-up; per panel one ``psum`` of the owner's L rows
    and one of its (b, K) right-hand-side rows.
    """
    d = L.shape[1]
    K = B.shape[1]
    b, r_loc, d_pad = _chol_pad_geometry(d, mesh, axis, panel_size)
    L = _to_panel_rows(L, d, r_loc, mesh, axis, unit_pad=True)
    X = _to_panel_rows(B, d, r_loc, mesh, axis)
    me = mesh.index[axis]
    row0 = me * r_loc
    starts = range(0, d_pad, b)
    for j in (reversed(starts) if transpose else starts):
        owner = j // r_loc
        off = j - owner * r_loc
        mine = owner == me
        L_rows = mesh.psum(L[off:off + b] if mine else L.new_zeros((b, d_pad)), axis)
        B_panel = mesh.psum(X[off:off + b] if mine else X.new_zeros((b, K)), axis)
        Ljj = L_rows[:, j:j + b]
        if transpose:
            Xp = torch.linalg.solve_triangular(Ljj.T, B_panel, upper=True)
            # rows above eliminate through the coupling L[j:j+b, :j]^T
            above = min(max(j - row0, 0), r_loc)
            X[:above].addmm_(L_rows[:, row0:row0 + above].T, Xp, alpha=-1.0)
        else:
            Xp = torch.linalg.solve_triangular(Ljj, B_panel, upper=False)
            below = min(max(j + b - row0, 0), r_loc)
            X[below:].addmm_(L[below:, j:j + b], Xp, alpha=-1.0)
        if mine:
            X[off:off + b] = Xp
    return _from_panel_rows(X, d, r_loc, mesh, axis)


def blocked_cho_solve(L, B, mesh, axis="space", panel_size=None):
    """Distributed ``(L L^T)^{-1} B`` from a row-sharded Cholesky factor."""
    Y = blocked_tri_solve_lower(L, B, mesh, axis=axis, panel_size=panel_size)
    return blocked_tri_solve_lower(L, Y, mesh, axis=axis, panel_size=panel_size, transpose=True)


def sharded_triangular_solve(R, B, mesh, axis="space", lower=False):
    """``R X = B`` with ``R`` small and replicated and ``B`` (and ``X``)
    column-sharded: each rank solves its own columns, no communication."""
    return torch.linalg.solve_triangular(R, B, upper=not lower)


def sharded_gram(kernel, points, mesh, axis="space"):
    """This rank's rows of ``K(X, X)``: its block of the points against all
    of them, no communication. A radial kernel with static scales sends a
    block of at least 512^2 entries on a CUDA tensor to the Gram kernel."""
    start, stop = mesh.bounds(points.shape[0], axis)
    return kernel(points[start:stop], points.T)


def sharded_collocation_global(diffop, mesh_spatial, device_mesh, kernel=None,
                               nugget_gram_matrix=0.0, nugget_cholesky_E=0.0,
                               symmetrize_cholesky_E=False, axis="space"):
    """Global collocation with the three N x N Grams row-sharded.

    :func:`pnmol_tpu_torch.discretize.collocation_global` on a rank mesh:
    returns this rank's rows of ``D`` and of the Cholesky factor of ``E``.
    The nuggets go on the diagonal of the rank's rows; ``K`` is factorized by
    :func:`blocked_cholesky` and ``E`` too. The transposes GSPMD would
    reshard are all-to-alls of the blocks (``Mesh.transpose_rows``), and
    ``D L_k^T`` gathers ``L_k`` (layout collectives).
    """
    if kernel is None:
        kernel = kernels_module.SquareExponential(input_scale=1.0, output_scale=1.0)
    L_kx, LL_kx = discretize_module._differentiate_kernel(diffop, kernel)
    points = mesh_spatial.points
    N = points.shape[0]
    start, stop = device_mesh.bounds(N, axis)
    rows = points[start:stop]
    local = torch.arange(stop - start, device=points.device)

    gram_k = kernel(rows, points.T)
    gram_k[local, start + local] += nugget_gram_matrix
    gram_Lk = L_kx(rows, points.T)
    gram_LLk = LL_kx(rows, points.T)
    chol_k = blocked_cholesky(gram_k, device_mesh, axis)
    del gram_k
    Lk_T = device_mesh.transpose_rows(gram_Lk, (N, N), axis)
    D_T = blocked_cho_solve(chol_k, Lk_T, device_mesh, axis)
    D = device_mesh.transpose_rows(D_T, (N, N), axis)
    sizes = meshes.block_sizes(N, device_mesh.shape[axis])
    E = gram_LLk - D @ device_mesh.gather_rows(gram_Lk, sizes, axis).T
    if symmetrize_cholesky_E:
        E = 0.5 * (E + device_mesh.transpose_rows(E, (N, N), axis))
    E[local, start + local] += nugget_cholesky_E
    return D, blocked_cholesky(E, device_mesh, axis)


def ring_matmul(A, X, mesh, axis="space", *, rows):
    """``A @ X`` with ``A`` ROW-sharded and ``X`` and the output
    COLUMN-sharded, never holding a full ``A``.

    ``A`` is this rank's row block of the (rows, k) operand, ``X`` its
    column block of the (k, c) one (any column split). The row blocks of A,
    padded to ``ceil(rows / P)``, rotate around the ring (``ppermute``, P
    rounds, the last one returning each block to its owner) while each rank
    multiplies them into its own columns. Returns this rank's (rows, c)
    column block.
    """
    P = mesh.shape[axis]
    me = mesh.index[axis]
    rb = -(-rows // P)
    A_cur = A.new_zeros((rb, A.shape[1]))
    A_cur[:A.shape[0]] = A
    out = X.new_zeros((rb * P, X.shape[1]))
    for r in range(P):
        # after r rotations this rank holds the block of rank (me - r) mod P
        origin = (me - r) % P
        out[origin * rb:(origin + 1) * rb] = A_cur @ X
        A_cur = mesh.ppermute(A_cur, axis, 1)
    return out[:rows]


def gram_rowsharded(X, mesh, axis="space", unit_pad_diag=True):
    """``X X^T`` with ``X`` COLUMN-sharded and the Gram ROW-sharded.

    ``X`` is this rank's column block of the (m, k) factor (any column
    split). A ring reduce-scatter: each rank starts the partial of one
    (ceil(m/P), m_pad) row block from its columns, and the partials hop the
    ring (``ppermute``, P - 1 hops), each rank adding its contribution, so
    every block lands fully reduced on its owner. With ``unit_pad_diag`` the
    pad block gets an identity diagonal (the padded Gram stays SPD). Returns
    this rank's rows of the PADDED (m_pad, m_pad) Gram.
    """
    m = X.shape[0]
    P = mesh.shape[axis]
    me = mesh.index[axis]
    rb = -(-m // P)
    m_pad = rb * P
    Xp = X.new_zeros((m_pad, X.shape[1]))
    Xp[:m] = X

    def contrib(blk):
        return Xp[blk * rb:(blk + 1) * rb] @ Xp.T

    acc = contrib((me + P - 1) % P)
    for s in range(1, P):
        acc = mesh.ppermute(acc, axis, 1) + contrib((me + P - 1 - s) % P)
    if unit_pad_diag and m_pad > m:
        rows = torch.arange(me * rb, (me + 1) * rb, device=X.device)
        pad = rows >= m
        acc[pad.nonzero()[:, 0], rows[pad]] += 1.0
    return acc
