"""Communication-volume and per-rank FLOP model of the sharded tier.

The port's copy of :mod:`pnmol_tpu.utils.comm_model`: closed-form functions
of (D, m, P, panel) that enumerate, primitive by primitive, the collective
payloads and per-rank FLOPs of the distributed linear algebra
(:mod:`pnmol_tpu_torch.parallel.sharded_linalg`), of the two-QR
memory-bounded white step and of the distributed initialization. The
mesh's counters (:class:`pnmol_tpu_torch.parallel.meshes.Mesh`, region
``"schedule"``) hold the code to these counts, as the HLO walk of the JAX
package's tests holds the JAX tier. The port's panel sweep is the
``loop="unrolled"`` one; ``loop="scan"`` models the JAX tier's masked
full-width sweep.

Conventions
-----------
* ``payload_elements`` of a collective = the number of elements in ONE
  rank's operand. Wire traffic per rank follows from the algorithm: a ring
  all-reduce (``psum``) moves ``2 (P-1)/P x payload``, a ring all-gather
  ``(P-1) x payload`` (the payload is the local block), a ``ppermute`` hop
  its payload.
* FLOPs are the standard 2mnk matmul count per RANK on the local block
  shapes, triangular ops at their dense cost on the shapes the code runs.
"""

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Collective:
    """One collective instruction family in a kernel's schedule."""

    kind: str  # "all-reduce" | "all-gather" | "ppermute"
    payload_elements: int  # per-rank operand elements
    count: int = 1  # times issued per kernel invocation

    @property
    def total_payload(self):
        return self.payload_elements * self.count


@dataclass
class KernelCost:
    """Per-rank cost of one distributed kernel invocation."""

    name: str
    flops: float  # per-rank FLOPs
    collectives: list = field(default_factory=list)

    def payload(self, kind=None):
        return sum(
            c.total_payload
            for c in self.collectives
            if kind is None or c.kind == kind
        )

    def wire_bytes(self, P, dtype_bytes=8):
        """Bytes each rank moves over the link (ring algorithms)."""
        total = 0.0
        for c in self.collectives:
            if c.kind == "all-reduce":
                factor = 2.0 * (P - 1) / P
            elif c.kind == "all-gather":
                # payload is the local shard; the rank receives the other
                # P-1 shards and sends its own P-1 times around the ring
                factor = float(P - 1)
            else:  # ppermute: each hop sends the full per-rank payload
                factor = 1.0
            total += factor * c.total_payload * dtype_bytes
        return total

    def n_launches(self):
        return sum(c.count for c in self.collectives)


def _ceil_to(x, q):
    return -(-x // q) * q


# ---------------------------------------------------------------------------
# sharded_linalg primitives (each mirrors one function 1:1)
# ---------------------------------------------------------------------------

def blocked_qr_r_sharded_cost(rows, cols, P, panel=None, loop="unrolled",
                              reorthogonalize=True):
    """Cost of :func:`sharded_linalg.blocked_qr_r_sharded` (sharded-R panel
    QR: shifted CholeskyQR3 panels + BGS trailing updates).

    Geometry mirrors the code: L = ceil(cols/P) rounded to a panel multiple,
    cols padded to P*L, rows padded to a multiple of P.
    """
    L = -(-cols // P)
    b = max(1, min(panel or min(L, 256), L))
    L = _ceil_to(L, b)
    cols_pad = P * L
    rows_pad = _ceil_to(rows, P)
    r_loc = rows_pad // P
    n_panels = cols_pad // b
    n_bgs = 2 if reorthogonalize else 1

    coll = [
        # 3 CholeskyQR rounds per panel, one (b, b) Gram psum each
        Collective("all-reduce", b * b, 3 * n_panels),
    ]
    # trailing projection psums: (b, w) where w = full padded width in the
    # scan body, the shrinking trailing width in the unrolled body (the
    # last panel has no trailing update in the unrolled sweep)
    flops_chol = 0.0
    flops_trail = 0.0
    for i in range(n_panels):
        # cholqr: Gram (2 r_loc b^2) + triangular apply (b^2 r_loc), x3 rounds
        flops_chol += 3 * (2 * r_loc * b * b + r_loc * b * b)
        if loop == "scan":
            w = cols_pad
        else:
            w = cols_pad - (i + 1) * b
        if w > 0:
            coll.append(Collective("all-reduce", b * w, n_bgs))
            # proj (2 r_loc b w) + rank-b update (2 r_loc b w), per BGS pass
            flops_trail += n_bgs * 4 * r_loc * b * w
    return KernelCost(
        f"blocked_qr_r_sharded({rows}x{cols},b={b},{loop})",
        flops_chol + flops_trail,
        coll,
    )


def blocked_qr_r_cost(rows, cols, P, panel=None, reorthogonalize=True):
    """Cost of :func:`sharded_linalg.blocked_qr_r` (replicated-R variant —
    identical collective schedule to the unrolled sharded-R sweep, without
    the column padding to P*L)."""
    b = min(panel or min(cols, 256), cols)
    rows_pad = _ceil_to(rows, P)
    r_loc = rows_pad // P
    n_bgs = 2 if reorthogonalize else 1
    coll = []
    flops = 0.0
    starts = list(range(0, cols, b))
    for j0 in starts:
        j1 = min(j0 + b, cols)
        bw = j1 - j0
        coll.append(Collective("all-reduce", bw * bw, 3))
        flops += 3 * (2 * r_loc * bw * bw + r_loc * bw * bw)
        w = cols - j1
        if w > 0:
            coll.append(Collective("all-reduce", bw * w, n_bgs))
            flops += n_bgs * 4 * r_loc * bw * w
    return KernelCost(f"blocked_qr_r({rows}x{cols},b={b})", flops, coll)


def ring_matmul_cost(ra, k, cx, P):
    """Cost of :func:`sharded_linalg.ring_matmul`: P rounds, each a local
    (ra/P, k) x (k, cx/P) matmul + one ppermute of the (ra/P, k) A shard.

    The code runs the ppermute in all P rounds (the last rotation returns A
    to its owner), so P hops are counted, not the P-1 an optimal schedule
    would issue.
    """
    ra_pad = _ceil_to(ra, P)
    cx_pad = _ceil_to(cx, P)
    rb, cb = ra_pad // P, cx_pad // P
    return KernelCost(
        f"ring_matmul({ra}x{k}x{cx})",
        P * (2 * rb * k * cb),
        [Collective("ppermute", rb * k, P)],
    )


def gram_rowsharded_cost(m, k, P):
    """Cost of :func:`sharded_linalg.gram_rowsharded` (ring reduce-scatter
    form): P local (m/P, k/P) x (k/P, m_pad) slab products, P-1
    ppermute hops of the (m/P, m_pad) partial."""
    rb = -(-m // P)
    m_pad = rb * P
    kb = -(-k // P)
    return KernelCost(
        f"gram_rowsharded({m}x{k})",
        P * (2 * rb * kb * m_pad),
        [Collective("ppermute", rb * m_pad, P - 1)] if P > 1 else [],
    )


def _chol_geometry(d, P, panel):
    # mirrors sharded_linalg._chol_pad_geometry exactly, including the
    # clamp b <= ceil(d/P)
    r_loc = -(-d // P)
    b = panel if panel is not None else min(128, max(8, -(-d // (4 * P))))
    b = max(1, min(b, r_loc))
    r_loc = _ceil_to(r_loc, b)
    return b, r_loc, r_loc * P


def blocked_cholesky_cost(d, P, panel=None):
    """Cost of :func:`sharded_linalg.blocked_cholesky`: per panel one psum
    broadcast of the (b, d_pad) owner rows, one all-gather of the (r_loc, b)
    solved column panel, and a rank-b trailing update (counted full-width,
    the JAX tier's masked form; the port updates the trailing block only)."""
    b, r_loc, d_pad = _chol_geometry(d, P, panel)
    n_panels = d_pad // b
    coll = [
        Collective("all-reduce", b * d_pad, n_panels),
        Collective("all-gather", r_loc * b, n_panels),
    ]
    # per panel: trailing update 2 r_loc b d_pad + local solve b^2 r_loc
    # (+ the redundant (b, b) Cholesky, b^3/3, negligible)
    flops = n_panels * (2 * r_loc * b * d_pad + r_loc * b * b)
    return KernelCost(f"blocked_cholesky({d},b={b})", flops, coll)


def blocked_tri_solve_cost(d, K, P, panel=None):
    """Cost of ONE :func:`sharded_linalg.blocked_tri_solve_lower` pass:
    per panel two psum broadcasts — the (b, d_pad) owner L rows and the
    (b, K) rhs panel — and a local (r_loc, b) x (b, K) elimination."""
    b, r_loc, d_pad = _chol_geometry(d, P, panel)
    n_panels = d_pad // b
    coll = [
        Collective("all-reduce", b * d_pad, n_panels),
        Collective("all-reduce", b * K, n_panels),
    ]
    flops = n_panels * (2 * r_loc * b * K + b * b * K)
    return KernelCost(f"blocked_tri_solve({d},K={K},b={b})", flops, coll)


def blocked_cho_solve_cost(d, K, P, panel=None):
    fwd = blocked_tri_solve_cost(d, K, P, panel)
    bwd = blocked_tri_solve_cost(d, K, P, panel)
    return KernelCost(
        f"blocked_cho_solve({d},K={K})",
        fwd.flops + bwd.flops,
        fwd.collectives + bwd.collectives,
    )


# ---------------------------------------------------------------------------
# Composite: the two-QR memory-bounded step and the distributed init
# ---------------------------------------------------------------------------

def two_qr_step_cost(d, nu, n_bc, P, panel=None, qr_loop="unrolled"):
    """Per-rank cost of ONE two-QR memory-bounded sharded white step.

    Mirrors :func:`pnmol_tpu_torch.parallel.sharded_filter.
    make_space_sharded_white_step` with ``distributed_qr=True, two_qr=True``
    (the ``make_distributed_factorization(..., memory_bounded=True)``
    hooks):

    1. ``apply_H(Ql)``: ring matmuls ``G @ X0`` (d, d, D) + ``B @ X0``
       (n_bc, d, D)                                         [x2: Ql and Clp]
    2. ``innovation_whiten``: row-sharded Gram of (m, D+m) + distributed
       Cholesky(m) + cho_solve(m, 1)
    3. propagate QR: sharded-R panel QR of (2D, D)
    4. update QR: sharded-R panel QR of (m+D, m+D)

    Returns a list of KernelCost (one per primitive, in program order).
    """
    n = nu + 1
    D = n * d
    m = d + n_bc
    parts = [
        ring_matmul_cost(d, d, D, P),        # G @ X0(Ql)
        ring_matmul_cost(n_bc, d, D, P),     # B @ X0(Ql)
        gram_rowsharded_cost(m, D + m, P),   # innovation Gram
        blocked_cholesky_cost(m, P, panel),
        blocked_cho_solve_cost(m, 1, P, panel),
        blocked_qr_r_sharded_cost(2 * D, D, P, panel, loop=qr_loop),
        ring_matmul_cost(d, d, D, P),        # G @ X0(Clp)
        ring_matmul_cost(n_bc, d, D, P),     # B @ X0(Clp)
        blocked_qr_r_sharded_cost(m + D, m + D, P, panel, loop=qr_loop),
    ]
    return parts


def distributed_init_cost(d, nu, n_bc, P, panel=None, sharded_r=True):
    """Per-rank cost of the distributed initialization
    (:func:`pnmol_tpu_torch.parallel.sharded_init.sharded_white_initialize`,
    whose update QR is the replicated-R one: ``sharded_r=False``):
    prior phase (3 distributed Choleskys of (d, d) + one cho_solve with a
    (d, d) rhs) + the reduced init PDE update's pre-array QR on the
    derivative-{0,1} substate (rows = 2d' + m', cols = m' + d' with
    d' = 2d)."""
    dp = 2 * d  # derivative-{0,1} reduced substate
    mp = d + n_bc
    qr = (
        blocked_qr_r_sharded_cost(dp + mp, mp + dp, P, panel)
        if sharded_r
        else blocked_qr_r_cost(dp + mp, mp + dp, P, panel)
    )
    return [
        blocked_cholesky_cost(d, P, panel),      # L_S0
        blocked_cho_solve_cost(d, d, P, panel),  # W
        blocked_cholesky_cost(d, P, panel),      # C00
        blocked_cholesky_cost(d, P, panel),      # chol_gram
        qr,
    ]


# ---------------------------------------------------------------------------
# Time model + crossover projection
# ---------------------------------------------------------------------------

@dataclass
class ChipSpec:
    """Per-card numbers of the time model; defaults are the NVIDIA H100 SXM5
    80GB's published FP64 tensor-core peak (67 TFLOP/s) and HBM3 rate (3.35
    TB/s), the rates the PERF.md bounds use. ``efficiency`` scales the peak
    (1.0: the model's compute time is a bound). The card-to-card link rate
    and the per-collective latency have no default: no measurement of them
    exists here, so without them the model leaves the wire and launch times
    out (reported as NaN) and ``t_step_s`` is the compute time alone."""

    name: str = "NVIDIA H100 SXM5 80GB"
    peak_flops: float = 67e12
    efficiency: float = 1.0
    hbm_bytes_per_s: float = 3.35e12
    link_bytes_per_s: Optional[float] = None
    collective_launch_s: Optional[float] = None


def step_time_model(parts, P, chip=None, dtype_bytes=8):
    """Project one sharded step's wall time on P cards: per-rank FLOP time at
    ``chip.efficiency`` of the peak, plus the serialized wire time and the
    per-collective latency where ``chip`` gives them (collectives gate each
    panel's trailing update, so communication does not overlap compute)."""
    chip = chip or ChipSpec()
    flops = sum(p.flops for p in parts)
    wire = sum(p.wire_bytes(P, dtype_bytes) for p in parts)
    launches = sum(p.n_launches() for p in parts)
    t_flops = flops / (chip.peak_flops * chip.efficiency)
    nan = float("nan")
    t_wire = wire / chip.link_bytes_per_s if chip.link_bytes_per_s else nan
    t_launch = launches * chip.collective_launch_s if chip.collective_launch_s else nan
    t_step = t_flops + sum(t for t in (t_wire, t_launch) if t == t)
    return {
        "flops_per_device": flops,
        "wire_bytes_per_device": wire,
        "collective_launches": launches,
        "t_flops_s": t_flops,
        "t_wire_s": t_wire,
        "t_launch_s": t_launch,
        "t_step_s": t_step,
    }


def single_chip_step_time(d, nu, n_bc, chip=None):
    """Single-card two-QR step time from the same FLOP counting (P=1 makes
    every collective free), at the same efficiency, so the crossover
    compares like against like."""
    parts = two_qr_step_cost(d, nu, n_bc, P=1)
    chip = chip or ChipSpec()
    flops = sum(p.flops for p in parts)
    return flops / (chip.peak_flops * chip.efficiency)


def crossover_table(nu=1, n_bc=2, P=8, panel=256, chip=None,
                    d_values=(2000, 4096, 8192, 16384, 32768, 65536, 110592)):
    """Single-card against P-card step times over a D ladder (the model's
    projection; the wire time counts only where ``chip`` gives a link
    rate)."""
    chip = chip or ChipSpec()
    rows = []
    for d in d_values:
        parts = two_qr_step_cost(d, nu, n_bc, P, panel=panel)
        tm = step_time_model(parts, P, chip)
        t1 = single_chip_step_time(d, nu, n_bc, chip)
        rows.append({
            "d_points": d,
            "state_dim": (nu + 1) * d,
            "t_single_s": t1,
            "t_sharded_s": tm["t_step_s"],
            "sharded_speedup": t1 / tm["t_step_s"],
            "wire_gb_per_step": tm["wire_bytes_per_device"] / 1e9,
            "comm_fraction": 1.0 - tm["t_flops_s"] / tm["t_step_s"],
        })
    return rows
