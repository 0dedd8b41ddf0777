// Householder LQ of one wide panel, spread over the SMs: the CUDA counterpart
// of the TPU panel kernels `_block_lq_kernel`
// (pnmol_tpu/ops/qr_householder.py:535) and `_leaf_lq_kernel`
// (pnmol_tpu/ops/qr_householder.py:350), and, launched on the tall layout,
// of the TPU leaf kernel `_leaf_kernel` (pnmol_tpu/ops/qr_householder.py:75).
//
// Contract (identical to the TPU kernels'): given a row-major slab
// (rows, cols) and a diagonal offset `off` (rows <= cols - off), reflector k
// annihilates row k past lane off + k. Outputs:
//   lv (rows, cols): L at lanes <= off + row (beta on the diagonal lane) and
//                    the reflector tails at lanes > off + row (unit diagonal
//                    implicit);
//   tt (rows, rows): T^T, lower triangular with tau on the diagonal, of the
//                    compact-WY form Q = I - V^T T V (rows of V = reflectors).
// Numerics follow the TPU kernels exactly: sign = +1 if alpha >= 0,
// beta = -sign * ||x||, tau = (beta - alpha) / beta, and a zero row gives
// the identity reflector (tau = 0, v = e_{off+k}); no LAPACK rescaling.
// One unblocked recurrence runs over all panel rows (the TPU kernels' leaf
// loop and leaf merge exist for Mosaic's VMEM tiling): each reflector
// updates every later row, and row k of T^T is -tau_k (V_{<k} v_k)^T T^T.
//
// The tall layout (entry points leaf_qr_*): a Householder QR of a row-major
// tall slab A (rows >= leaf <= 128 columns), with the TPU leaf kernel's
// numerics, is exactly the LQ above of A^T at off = 0, transposed: the same
// reflectors, beta and tau, vr = lv^T and T = (T^T)^T. So one kernel serves
// both, with a compile-time layout: on the tall layout LQ row j is column j
// of A and LQ lane l is row l of A, a column CTA's chunk of `width` lanes is
// `width` consecutive rows of A (one contiguous span in memory), and the
// T^T CTA writes T. Only the chunk's load and store and that write differ;
// the exchange and the arithmetic are the same code.
//
// The bound on the H100, for an f64 128 x 3586 panel:
//   - operations: about 3 * cols * rows^2 = 175 MFLOP of FP64, 2.6 us at the
//     card's 67 TFLOP/s FP64 peak (its tensor cores, at full FP64 precision);
//   - bytes: the slab in, lv and T^T out, 7.5 MB, 2.2 us at 3.35 TB/s;
//   - the serial floor: reflector k needs row k after reflectors 0..k-1, and
//     its norm and its dot products are sums over the whole width, so every
//     reflector is one reduction across all CTAs that hold columns: `rows`
//     grid-wide barriers, about 1 us apiece.
// The floor dominates, so the design spends everything else on keeping each
// reflector's step between two barriers short:
//   - P cooperative column CTAs (one per SM, co-resident by
//     cudaLaunchCooperativeKernel; P from the wrapper's rule, 32 on 3586
//     columns and 56 on 6658; the same on a tall slab's rows) each own a
//     chunk of `width` consecutive columns of every row. The chunk is loaded
//     once, worked on in place for all reflectors and written once, so the
//     panel crosses device memory twice instead of once per reflector. It
//     lives in registers where it
//     fits (rows <= 128, width <= 128: 4 x 4 values a thread; a pass then
//     reads only rows k and k + 1 from shared memory), which every panel of
//     the solvers' sweeps does; a taller or wider panel keeps it in `lv` in
//     global memory, with the same arithmetic.
//   - One reduction per reflector: the CTAs reduce the raw partials of row
//     k, q_j = sum_{l>d} x_j[l] x_k[l] for every row j (q_k is sigma), and
//     a_j = x_j[d] comes from the CTA that owns lane d = off + k. After the
//     reduction every CTA forms alpha, beta, tau and inv = 1 / (alpha - beta)
//     itself, and s_j = a_j + inv q_j is v_k . x_j for every row at once:
//     the update weights for j > k, and z_j = V_j . v_k of the T^T row for
//     j < k (rows above k hold reflector tails at lanes >= d). One pass over
//     the chunk then scales row k into the reflector tail, applies the rank-1
//     update to the rows below and accumulates the partials of reflector
//     k + 1 on the updated values.
//   - The cross-CTA sum is deterministic: fixed slots, a fixed order, no
//     float atomics, so two launches give the same bits. Every CTA sums all
//     P slots of every row itself (P * rows values from L2, loads coalesced
//     along the rows), so one barrier per reflector suffices; the slots and
//     a_j are double-buffered by reflector parity, so a fast CTA can write
//     reflector k+1's partials while a slow one still reads k's. This
//     all-read moves P^2 * rows values through L2 per reflector, which keeps
//     P small. Two alternatives were timed on an H100 and were slower at
//     every P and shape tried (PERF.md): a reduce-scatter with two
//     barriers per reflector, and no barrier at all, each partial carrying
//     its reflector's epoch in the same 64-bit word so that a CTA spins only
//     on the words it reads. A cluster pre-reduction over DSMEM would need a
//     cluster launch that is also cooperative and is not used.
//   - T^T is off the barrier chain: CTA 0 writes each reflector's z row and
//     tau to a small global buffer, and one extra CTA, which reads the
//     barrier count but never adds to it, forms T^T row by row in its shared
//     memory (128 x 129 f64) as the rows are published, every row's entries
//     in parallel.
//   - The grid barrier is hand-rolled: one monotonic counter in global
//     memory (zeroed before each launch), a release add by each CTA and an
//     acquire spin until the count reaches the barrier's target; data that
//     crosses CTAs is read with __ldcg (L2, never a stale L1 line).
// What is left (pnmol_tpu_torch/ops/panel_lq_phases.py measures it, with
// this file built with -DPANEL_LQ_PHASES): per reflector about 1.5 us of
// barrier, 1.8 us of summing the partials (L2 latency), 0.6 us of scalars
// and 1.2-2.1 us of the pass over the chunk.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;    // rows a warp works on at once (independent chains)
constexpr int kRegCols = 4;  // columns per lane of a chunk held in registers
constexpr int kTtParts = 8;  // lanes that share one T^T entry's sum
constexpr int kMaxParts = 16;  // most partial sums of one q_j before they are combined
constexpr unsigned int kMaxPolls = 1u << 26;

// Built with -DPANEL_LQ_PHASES, thread 0 of the last column CTA sums the SM
// clock spent in each phase of the reflector loop (the grid barrier, the
// sums of the partials, the scalars, rows k and k + 1, the other rows with
// the next partials) and writes the five sums behind `scratch`'s tau slots.
// PHASE syncs the CTA first, so that a phase ends when all its threads do.
#ifdef PANEL_LQ_PHASES
#define PHASES_BEGIN                                \
  const bool prof_on = tid == 0 && p == g.ctas - 1; \
  long long prof[5] = {0}, prof_last = clock64();
#define PHASE(i)                     \
  __syncthreads();                   \
  if (prof_on) {                     \
    const long long now = clock64(); \
    prof[i] += now - prof_last;      \
    prof_last = now;                 \
  }
#define PHASES_END \
  if (prof_on)     \
    for (int i = 0; i < 5; ++i) taubuf[rows + i] = T(prof[i]);
#else
#define PHASES_BEGIN
#define PHASE(i)
#define PHASES_END
#endif

// Spin (one thread) with acquire loads until `count` reaches `target`. A
// count that never gets there (CTAs not co-resident) aborts the launch with
// an error after some seconds instead of hanging the card.
__device__ __forceinline__ void wait_count(const unsigned int* count, unsigned int target) {
  unsigned int seen, polls = 0;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
    if (++polls == kMaxPolls) __trap();
  } while (seen < target);
}

// The grid barrier of the `ctas` column CTAs (the pattern of CUTLASS's
// GenericBarrier): the CTA's threads meet, thread 0 adds one with release
// semantics and spins until every column CTA has added, the CTA meets again.
// `count` grows by `ctas` per barrier and is zeroed per launch.
__device__ __forceinline__ void grid_barrier(unsigned int* count, unsigned int& target,
                                             int ctas) {
  target += ctas;
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
    wait_count(count, target);
  }
  __syncthreads();
}

// The sums over the warp of v[0..3]: a butterfly that halves the values a
// lane keeps at each of the first two steps (6 shuffles instead of 20).
// Lane l ends with the sum of v[2 ((l >> 4) & 1) + ((l >> 3) & 1)].
template <typename T>
__device__ __forceinline__ T warp_sums4(const T (&v)[kGroup], int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8;
  const T k0 = (hi16 ? v[2] : v[0]) + __shfl_xor_sync(0xffffffffu, hi16 ? v[0] : v[2], 16);
  const T k1 = (hi16 ? v[3] : v[1]) + __shfl_xor_sync(0xffffffffu, hi16 ? v[1] : v[3], 16);
  T m = (hi8 ? k1 : k0) + __shfl_xor_sync(0xffffffffu, hi8 ? k0 : k1, 8);
  for (int o = 4; o > 0; o >>= 1) m += __shfl_xor_sync(0xffffffffu, m, o);
  return m;
}

// Per-launch geometry, the same in every CTA.
struct Geometry {
  int rows, cols, off, width, ctas;
  // CTA p holds lanes [p * width, min((p + 1) * width, cols)); it has a
  // partial of the reflector whose diagonal is lane d iff it holds a lane > d
  __device__ bool contributes(int p, int d) const {
    return min((p + 1) * width, cols) - 1 > d;
  }
};

// q_j of the reflector at diagonal lane d for every row j: thread t sums
// the slots q = t / rows, t / rows + nq, ... of row t % rows (the loads
// coalesced along the rows), then thread j sums the nq parts in part order.
// The order is fixed, so every CTA gets the same bits. out[j] = q_j. Called
// by the whole CTA (it synchronizes).
template <typename T>
__device__ void reduce_rows(const T* slots, const Geometry& g, int d, T* out, T* parts,
                            int tid) {
  const int nj = g.rows;
  const int nq = min(min(kThreads / nj, kMaxParts), g.ctas);
  const int qg = tid / nj;
  if (qg < nq) {
    const T* col = slots + tid % nj;
    T acc = T(0);
#pragma unroll 4
    for (int q = qg; q < g.ctas; q += nq)
      if (g.contributes(q, d)) acc += __ldcg(col + static_cast<size_t>(q) * g.rows);
    parts[tid] = acc;  // = parts[qg * rows + j]
  }
  __syncthreads();
  if (tid < nj) {
    T sum = T(0);
    for (int i = 0; i < nq; ++i) sum += parts[i * nj + tid];
    out[tid] = sum;
  }
}

// Strides of the chunk's element (row j, lane c) in memory: the wide layout
// keeps a row's lanes contiguous, the tall one a lane's rows.
template <bool kTall>
__device__ __forceinline__ size_t row_stride(const Geometry& g) {
  return kTall ? 1 : static_cast<size_t>(g.cols);
}
template <bool kTall>
__device__ __forceinline__ size_t lane_stride(const Geometry& g) {
  return kTall ? static_cast<size_t>(g.rows) : 1;
}

// Update the rows below `next` with the current reflector (vbuf, cbuf) if
// `update`, and write reflector `next`'s partials: the slot of this CTA
// (q_j over lanes > dn of this chunk) and, from the CTA that owns lane dn,
// a_j = x_j[dn]. Lanes below `cs` are left of the current diagonal. A warp
// takes kGroup rows at once. The chunk `x` is in global memory, in the
// layout of kTall.
template <bool kTall, typename T>
__device__ void pass_partials(T* x, int c0, int wp, int cs, int next, bool update,
                              const T* vbuf, const T* cbuf, T* slot, T* a_next,
                              const Geometry& g, int warp, int lane) {
  const int dn = g.off + next;
  const size_t sj = row_stride<kTall>(g), sc = lane_stride<kTall>(g);
  const T* xn = x + static_cast<size_t>(next) * sj;
  for (int j0 = warp; j0 < g.rows; j0 += kGroup * kWarps) {
    T* xj[kGroup];
    T cj[kGroup], acc[kGroup];
    bool valid[kGroup], upd[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int j = j0 + u * kWarps;
      valid[u] = j < g.rows;
      upd[u] = update && valid[u] && j > next;
      cj[u] = upd[u] ? cbuf[j] : T(0);
      xj[u] = x + static_cast<size_t>(j) * sj;
      acc[u] = T(0);
    }
    for (int c = cs + lane; c < wp; c += 32) {
      const T vn = xn[c * sc];
      const T vc = update ? vbuf[c] : T(0);
      const int l = c0 + c;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (!valid[u]) continue;
        T v = xj[u][c * sc];
        if (upd[u]) {
          v -= cj[u] * vc;
          xj[u][c * sc] = v;
        }
        if (l > dn) acc[u] += v * vn;
        else if (l == dn) a_next[j0 + u * kWarps] = v;
      }
    }
    const T sum = warp_sums4(acc, lane);
    const int j = j0 + (2 * ((lane >> 4) & 1) + ((lane >> 3) & 1)) * kWarps;
    if ((lane & 7) == 0 && j < g.rows && g.contributes(blockIdx.x, dn)) slot[j] = sum;
  }
}

// The chunk held in registers (rows <= 128, width <= 32 kRegCols): thread
// (warp, lane) holds rows warp + 32 u and columns lane + 32 i. Row `next`
// (updated) is in shared memory as xn, and row k (before scaling) as xk, so
// that every thread forms v_k from it. Updates the rows below `next` if
// `update`, then writes reflector `next`'s partials as pass_partials does.
template <typename T>
__device__ void reg_partials(T (&x)[kGroup][kRegCols], const T* xk, const T* xn, T inv,
                             int d, int c0, int wp, int cs, int next, bool update,
                             const T* cbuf, T* slot, T* a_next, const Geometry& g, int warp,
                             int lane) {
  const int dn = g.off + next;
  T acc[kGroup], cj[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int j = warp + u * kWarps;
    acc[u] = T(0);
    cj[u] = update && j > next && j < g.rows ? cbuf[j] : T(0);
  }
#pragma unroll
  for (int i = 0; i < kRegCols; ++i) {
    const int c = lane + 32 * i;
    if (c < cs || c >= wp) continue;
    const int l = c0 + c;
    const T v = update ? (l == d ? T(1) : xk[c] * inv) : T(0);
    const T vn = xn[c];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (update) x[u][i] -= cj[u] * v;
      if (l > dn) acc[u] += x[u][i] * vn;
      else if (l == dn && warp + u * kWarps < g.rows) a_next[warp + u * kWarps] = x[u][i];
    }
  }
  const T sum = warp_sums4(acc, lane);
  const int j = warp + (2 * ((lane >> 4) & 1) + ((lane >> 3) & 1)) * kWarps;
  if ((lane & 7) == 0 && j < g.rows && g.contributes(blockIdx.x, dn)) slot[j] = sum;
}

// T^T, formed by the extra CTA (blockIdx.x == ctas) while the column CTAs
// run the reflector loop: row k = -tau_k z_k^T T^T[:k, :k], tau_k on the
// diagonal, as soon as z_k and tau_k are published, i.e. once the barrier at
// the top of reflector k + 1 (the final one for the last row) has completed.
// It reads the barrier count but never adds to it, so it is not on the
// reflector chain. T^T stays in shared memory (row stride rows + 1); the
// kTtParts lanes that share entry i sum every kTtParts-th term of it. The
// wide layout writes T^T, the tall one its transpose T.
template <bool kTall, typename T>
__device__ void form_tt(T* tt, const T* zbuf, const T* taubuf, const unsigned int* count,
                        const Geometry& g, T* smem, int tid, int warp, int lane) {
  const int rows = g.rows;
  const int ldt = rows + 1;
  T* tts = smem;
  T* zk = tts + static_cast<size_t>(rows) * ldt;
  for (int k = 0; k < rows; ++k) {
    if (tid == 0) wait_count(count, static_cast<unsigned int>(g.ctas) * (k + 2));
    __syncthreads();
    if (tid < k) zk[tid] = __ldcg(zbuf + static_cast<size_t>(k) * (k - 1) / 2 + tid);
    const T tau = __ldcg(taubuf + k);
    __syncthreads();
    for (int i0 = warp * (32 / kTtParts); i0 < rows; i0 += kThreads / kTtParts) {
      const int i = i0 + lane / kTtParts;
      const int part = lane % kTtParts;
      T acc = T(0);
      if (i < k)
        for (int m = i + part; m < k; m += kTtParts)
          acc += zk[m] * tts[static_cast<size_t>(m) * ldt + i];
      for (int o = kTtParts / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (part == 0 && i < rows)
        tts[static_cast<size_t>(k) * ldt + i] = i < k ? -tau * acc : (i == k ? tau : T(0));
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * rows; e += kThreads) {
    const int r = kTall ? e % rows : e / rows, c = kTall ? e / rows : e % rows;
    tt[e] = tts[static_cast<size_t>(r) * ldt + c];
  }
}

// kRegisters: the chunk lives in registers (the wrapper's rule allows it for
// rows <= 128 and width <= 32 kRegCols); otherwise in lv. kTall: the slab,
// lv and tt are a tall slab, its vr and T (see the top of the file).
template <typename T, bool kRegisters, bool kTall>
__global__ void __launch_bounds__(kThreads, 1)
    panel_lq_kernel(const T* __restrict__ slab, T* lv, T* tt, T* scratch,
                    unsigned int* count, Geometry g) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = blockIdx.x;
  const int rows = g.rows;
  const int c0 = p * g.width;
  const int wp = min(g.width, g.cols - c0);

  // scratch: slots[2][ctas][rows] | a[2][rows] | z (packed lower triangle,
  // row k at k (k - 1) / 2) in rows^2 | tau[rows]
  T* slots = scratch;
  T* a_glob = slots + 2 * static_cast<size_t>(g.ctas) * rows;
  T* zbuf = a_glob + 2 * rows;
  T* taubuf = zbuf + static_cast<size_t>(rows) * rows;
  if (p == g.ctas) {
    form_tt<kTall>(tt, zbuf, taubuf, count, g, smem, tid, warp, lane);
    return;
  }

  // the chunk: in registers (xr; rows k and k + 1 by parity in shared
  // memory) or in lv (x); element (j, c) of the chunk is at
  // j * sj + c * sc from its start, in the slab and in lv alike
  T xr[kGroup][kRegCols];
  const size_t sj = row_stride<kTall>(g), sc = lane_stride<kTall>(g);
  const T* const src = slab + c0 * sc;
  T* const x = kRegisters ? nullptr : lv + c0 * sc;
  T* const rest = kRegisters ? smem + 2 * g.width : smem;
  T* vbuf = rest;            // v_k on this chunk
  T* cbuf = vbuf + g.width;  // tau_k s_j
  T* qbuf = cbuf + rows;     // q_j
  T* abuf = qbuf + rows;     // a_j
  T* parts = abuf + rows;    // kThreads partial sums of q_j

  T* xrow = smem;  // kRegisters: row k at xrow[(k & 1) * width]
  unsigned int target = 0;
  PHASES_BEGIN
  if constexpr (kRegisters) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
#pragma unroll
      for (int i = 0; i < kRegCols; ++i) {
        const int j = warp + u * kWarps, c = lane + 32 * i;
        xr[u][i] = j < rows && c < wp ? src[j * sj + c * sc] : T(0);
        if (j == 0 && c < wp) xrow[c] = xr[u][i];
      }
    __syncthreads();
    reg_partials(xr, xrow, xrow, T(0), g.off, c0, wp, max(g.off - c0, 0), 0, false, cbuf,
                 slots + static_cast<size_t>(p) * rows, a_glob, g, warp, lane);
  } else {
    if constexpr (kTall) {  // the chunk is one contiguous span
      for (size_t e = tid; e < static_cast<size_t>(wp) * rows; e += kThreads) x[e] = src[e];
    } else {
      for (int j = warp; j < rows; j += kWarps)
        for (int c = lane; c < wp; c += 32) x[j * sj + c] = src[j * sj + c];
    }
    __syncthreads();
    pass_partials<kTall>(x, c0, wp, max(g.off - c0, 0), 0, false, vbuf, cbuf,
                         slots + static_cast<size_t>(p) * rows, a_glob, g, warp, lane);
  }

  for (int k = 0; k < rows; ++k) {
    const int d = g.off + k;
    const int par = k & 1;
    const T* slots_k = slots + static_cast<size_t>(par) * g.ctas * rows;
    grid_barrier(count, target, g.ctas);
    PHASE(0)

    // --- q_j and a_j of reflector k into every CTA's shared memory ----------
    const T a_own = tid < rows ? __ldcg(a_glob + par * rows + tid) : T(0);
    reduce_rows(slots_k, g, d, qbuf, parts, tid);
    if (tid < rows) abuf[tid] = a_own;
    __syncthreads();
    PHASE(1)

    // --- reflector k, formed identically in every CTA -----------------------
    const T alpha = abuf[k];
    const T norm = sqrt(alpha * alpha + qbuf[k]);
    const T sign = alpha >= T(0) ? T(1) : T(-1);
    const T beta = -sign * norm;
    const bool safe = norm > T(0);
    const T inv = safe ? T(1) / (alpha - beta) : T(0);
    const T tau = safe ? (beta - alpha) / beta : T(0);
    if (tid < rows) {
      const T s = abuf[tid] + inv * qbuf[tid];  // v_k . x_j
      cbuf[tid] = tau * s;
      if (p == 0 && tid < k) zbuf[static_cast<size_t>(k) * (k - 1) / 2 + tid] = s;
    }
    if (p == 0 && tid == 0) taubuf[k] = tau;
    PHASE(2)

    // --- row k becomes [L | beta | tail]; row k + 1 takes the update --------
    const int cs = max(d - c0, 0);
    if (cs >= wp) continue;  // this chunk lies left of the diagonal
    const bool more = k + 1 < rows;
    const T c_next = more ? tau * (abuf[k + 1] + inv * qbuf[k + 1]) : T(0);
    if constexpr (kRegisters) {
      const T* xk = xrow + par * g.width;
      T* xn = xrow + (par ^ 1) * g.width;
      const int uk = k / kWarps, un = (k + 1) / kWarps;
      if (warp == k % kWarps || (more && warp == (k + 1) % kWarps)) {
#pragma unroll
        for (int i = 0; i < kRegCols; ++i) {
          const int c = lane + 32 * i;
          if (c < cs || c >= wp) continue;
          const bool diag = c0 + c == d;
          const T v = diag ? T(1) : xk[c] * inv;
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            if (warp == k % kWarps && u == uk) xr[u][i] = diag ? beta : v;
            if (more && warp == (k + 1) % kWarps && u == un) {
              xr[u][i] -= c_next * v;
              xn[c] = xr[u][i];
            }
          }
        }
      }
      __syncthreads();
      PHASE(3)
      if (more)
        reg_partials(xr, xk, xn, inv, d, c0, wp, cs, k + 1, true, cbuf,
                     slots + (static_cast<size_t>(par ^ 1) * g.ctas + p) * rows,
                     a_glob + (par ^ 1) * rows, g, warp, lane);
      PHASE(4)
      continue;
    }
    T* xk = x + k * sj;
    for (int c = cs + tid; c < wp; c += kThreads) {
      const bool diag = c0 + c == d;
      const T v = diag ? T(1) : xk[c * sc] * inv;
      vbuf[c] = v;
      xk[c * sc] = diag ? beta : v;
      if (more) xk[sj + c * sc] -= c_next * v;
    }
    __syncthreads();
    PHASE(3)

    // --- rows below k + 1 take the update; partials of reflector k + 1 ------
    if (more)
      pass_partials<kTall>(x, c0, wp, cs, k + 1, true, vbuf, cbuf,
                           slots + (static_cast<size_t>(par ^ 1) * g.ctas + p) * rows,
                           a_glob + (par ^ 1) * rows, g, warp, lane);
    PHASE(4)
  }
  PHASES_END
  grid_barrier(count, target, g.ctas);  // publishes the last z row to form_tt

  if constexpr (kRegisters) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
#pragma unroll
      for (int i = 0; i < kRegCols; ++i) {
        const int j = warp + u * kWarps, c = lane + 32 * i;
        if (j < rows && c < wp) lv[c0 * sc + j * sj + c * sc] = xr[u][i];
      }
  }
}

// Dynamic shared memory of one CTA (the same for all): a column CTA's rows k
// and k + 1 (chunk in registers), v, tau s, q, a and the partial sums of q;
// the T^T CTA's T^T (row stride rows + 1) and one z row.
size_t shared_bytes(int rows, int width, bool registers, size_t item) {
  const size_t chunk = registers ? 2 * static_cast<size_t>(width) : 0;
  const size_t loop = chunk + width + 3 * rows + kThreads;
  const size_t tail = static_cast<size_t>(rows) * (rows + 2);
  return (loop > tail ? loop : tail) * item;
}

// The most CTAs one launch may have on `device`: the shared-memory limit is
// raised to the most a block may use, once per device and kernel, and the
// occupancy (one CTA per SM: 1024 threads of 64 registers fill its register
// file) does not depend on the bytes below it.
template <typename T, bool kRegisters, bool kTall>
int max_ctas(int device, int* out) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {0};
  if (device < 0 || device >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (cached[device] == 0) {
    auto kernel = panel_lq_kernel<T, kRegisters, kTall>;
    int optin = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached[device] = per_sm * sms;
  }
  *out = cached[device];
  return 0;
}

// One launch in LQ terms: `rows` reflectors over `cols` lanes.
template <typename T, bool kRegisters, bool kTall>
int launch(const void* slab, void* lv, void* tt, void* scratch, void* count, int rows,
           int cols, int off, int ctas, int width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kRegisters && (rows > kGroup * kWarps || width > 32 * kRegCols))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(rows, width, kRegisters, sizeof(T));
  int most = 0;
  if (const int e = max_ctas<T, kRegisters, kTall>(device, &most)) return e;
  // the column CTAs and the T^T CTA must all be resident at once
  if (ctas < 1 || ctas + 1 > most) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  auto kernel = panel_lq_kernel<T, kRegisters, kTall>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(count, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geometry g{rows, cols, off, width, ctas};
  const T* slab_t = static_cast<const T*>(slab);
  T* lv_t = static_cast<T*>(lv);
  T* tt_t = static_cast<T*>(tt);
  T* scratch_t = static_cast<T*>(scratch);
  unsigned int* count_t = static_cast<unsigned int*>(count);
  void* args[] = {&slab_t, &lv_t, &tt_t, &scratch_t, &count_t, &g};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(ctas + 1),
                                    dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTall>
int launch_chunk(const void* slab, void* lv, void* tt, void* scratch, void* count, int rows,
                 int cols, int off, int ctas, int width, int registers, int device,
                 void* stream) {
  if (registers)
    return launch<T, true, kTall>(slab, lv, tt, scratch, count, rows, cols, off, ctas, width,
                                  device, stream);
  return launch<T, false, kTall>(slab, lv, tt, scratch, count, rows, cols, off, ctas, width,
                                 device, stream);
}

}  // namespace

// Plain C entry points for ctypes. All buffers are device pointers on
// `device`: `scratch` holds (2 ctas + 3 + rows) * rows elements of the
// slab's type, `count` one 32-bit word (zeroed here before the launch). The
// wrapper picks `ctas` column CTAs of `width` columns (covering every lane
// once; one more CTA forms T^T) and where each chunk lives: in registers if
// `registers` (rows <= 128 and width <= 128), else in lv. Built with
// -DPANEL_LQ_PHASES, `scratch` holds 5 more elements. The launch goes on
// `stream` and does not synchronize. Returns a
// cudaError_t (0 = success); a device that cannot hold ctas + 1 CTAs at once
// gives cudaErrorCooperativeLaunchTooLarge.
extern "C" int panel_lq_f64(const void* slab, void* lv, void* tt, void* scratch, void* count,
                            int rows, int cols, int off, int ctas, int width, int registers,
                            int device, void* stream) {
  return launch_chunk<double, false>(slab, lv, tt, scratch, count, rows, cols, off, ctas,
                                     width, registers, device, stream);
}

extern "C" int panel_lq_f32(const void* slab, void* lv, void* tt, void* scratch, void* count,
                            int rows, int cols, int off, int ctas, int width, int registers,
                            int device, void* stream) {
  return launch_chunk<float, false>(slab, lv, tt, scratch, count, rows, cols, off, ctas,
                                    width, registers, device, stream);
}

// The same on the tall layout: a (rows, cols) row-major tall slab (rows >=
// cols, cols <= 128 with the chunk in registers), its vr (rows, cols) and T
// (cols, cols). `ctas` CTAs of `width` slab rows; `scratch` holds
// (2 ctas + 3 + cols) * cols elements (5 more with -DPANEL_LQ_PHASES).
extern "C" int leaf_qr_f64(const void* slab, void* vr, void* t, void* scratch, void* count,
                           int rows, int cols, int ctas, int width, int registers, int device,
                           void* stream) {
  return launch_chunk<double, true>(slab, vr, t, scratch, count, cols, rows, 0, ctas, width,
                                    registers, device, stream);
}

extern "C" int leaf_qr_f32(const void* slab, void* vr, void* t, void* scratch, void* count,
                           int rows, int cols, int ctas, int width, int registers, int device,
                           void* stream) {
  return launch_chunk<float, true>(slab, vr, t, scratch, count, cols, rows, 0, ctas, width,
                                   registers, device, stream);
}
