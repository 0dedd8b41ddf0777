// Householder QR of one tall leaf slab: the CUDA counterpart of the TPU
// kernel `_leaf_kernel` (pnmol_tpu/ops/qr_householder.py:75).
//
// Contract (identical to the TPU kernel's): given a row-major slab
// (rows, cols) with 1 <= cols <= 32 and rows >= cols, whose column k has its
// diagonal at row k, reflector k annihilates column k below row k. Outputs:
//   vr (rows, cols): R in the upper triangle of the top (cols, cols) square
//                    (beta on the diagonal) and the reflector tails below the
//                    diagonal (unit diagonal implicit);
//   t  (cols, cols): the upper-triangular compact-WY factor of
//                    Q = H_0 H_1 ... = I - V T V^T, tau on the diagonal.
// Numerics follow the TPU kernel exactly: sign = +1 if alpha >= 0,
// beta = -sign * ||x||, tau = (beta - alpha) / beta, and a zero column gives
// the identity reflector (tau = 0); no LAPACK rescaling.
//
// What bounds it on the H100: the reflector chain is serial, and an f64 slab
// at the R-form step's shapes (up to 3586 x 32, 0.9 MB) is four times the
// 227 KB of shared memory one block can use. So ONE block of 1024 threads
// runs per slab and streams it through global memory, where it stays in the
// 50 MB L2. A row of the slab is 32 values, so a warp owns whole rows, lane j
// holding column j. Per column k, one pass over the rows below k does
// everything the TPU kernel's column step does:
//   - it writes the reflector tail v_r = a_rk / (alpha - beta) into column k
//     and applies the rank-1 update a_rj -= v_r (tau s_j) to columns j > k;
//   - on the updated values it accumulates P_j = sum_{r > k+1} a_r,k+1 a_rj
//     for the NEXT column: P_{k+1} is its sigma, and
//     s_j = a_k+1,j + inv P_j is v . a_j for every column at once, which
//     gives the update weights for j > k+1 and the T column for j < k+1
//     (the trick of the TPU kernel, qr_householder.py:130-135).
// Between passes warp 0 reduces the per-warp P over warps, forms the
// reflector, updates row k and the T column in shared memory. Each pass
// reads and writes the rows below k once (about 2 * rows * 32 * 8 bytes of
// L2 traffic per column in f64), with eight rows in flight per warp.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLeaf = 32;    // most columns a slab may have (one per lane)
constexpr int kRowUnroll = 8;  // rows in flight per warp in a pass

template <typename T>
__device__ __forceinline__ T shfl(T v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    leaf_qr_kernel(const T* __restrict__ slab, T* vr, T* t_out, int rows,
                   int cols) {
  __shared__ T red[kWarps][kLeaf + 1];  // per-warp partial P_j
  __shared__ T tmat[kLeaf][kLeaf + 1];  // T, built column by column
  __shared__ T s_c[kLeaf];              // tau * s_j of the current column
  __shared__ T s_inv;                   // 1 / (alpha - beta), or 0
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const size_t total = static_cast<size_t>(rows) * cols;
  for (size_t i = tid; i < total; i += kThreads) vr[i] = slab[i];
  for (int i = tid; i < kLeaf * (kLeaf + 1); i += kThreads) (&tmat[0][0])[i] = T(0);
  __syncthreads();

  // P_j of column 0: sum over rows r > 0 of a_r0 a_rj
  T acc = T(0);
  for (int r0 = 1 + warp; r0 < rows; r0 += kWarps * kRowUnroll) {
    T a[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int r = r0 + u * kWarps;
      a[u] = (r < rows && lane < cols) ? vr[static_cast<size_t>(r) * cols + lane] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) acc += shfl(a[u], 0) * a[u];
  }

  for (int k = 0; k < cols; ++k) {
    red[warp][lane] = acc;
    __syncthreads();  // also publishes row k, written by the previous pass

    // --- warp 0: reflector k, row k of R, column k of T ---------------------
    if (warp == 0) {
      T P = T(0);
      for (int w = 0; w < kWarps; ++w) P += red[w][lane];
      T* xk = vr + static_cast<size_t>(k) * cols;
      const T akj = lane < cols ? xk[lane] : T(0);
      const T sigma = shfl(P, k);
      const T alpha = shfl(akj, k);
      const T norm = sqrt(alpha * alpha + sigma);
      const T sign = alpha >= T(0) ? T(1) : T(-1);
      const T beta = -sign * norm;
      const bool safe = norm > T(0);
      const T inv = safe ? T(1) / (alpha - beta) : T(0);
      const T tau = safe ? (beta - alpha) / beta : T(0);
      const T s = akj + inv * P;  // v . a_j (v_k = 1, tails P_j-weighted)
      const T c = tau * s;
      if (lane < cols) {
        if (lane > k) xk[lane] = akj - c;
        else if (lane == k) xk[lane] = beta;
      }
      s_c[lane] = c;
      if (lane == 0) s_inv = inv;
      // T[:k, k] = -tau T[:k, :k] z with z_m = s_m (m < k); T[k, k] = tau
      T tz = T(0);
      for (int m = 0; m < k; ++m) {
        const T zm = shfl(s, m);
        if (lane < k) tz += tmat[lane][m] * zm;
      }
      if (lane < k) tmat[lane][k] = -tau * tz;
      else if (lane == k) tmat[k][k] = tau;
    }
    __syncthreads();

    // --- all warps: rows below k, and P of column k + 1 ----------------------
    const T inv = s_inv;
    const T c = s_c[lane];
    const bool next = k + 1 < cols;
    acc = T(0);
    for (int r0 = k + 1 + warp; r0 < rows; r0 += kWarps * kRowUnroll) {
      T a[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int r = r0 + u * kWarps;
        a[u] = (r < rows && lane < cols) ? vr[static_cast<size_t>(r) * cols + lane] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int r = r0 + u * kWarps;
        if (r >= rows) break;  // warp-uniform
        const T v = shfl(a[u], k) * inv;
        T val = a[u];
        if (lane == k) val = v;
        else if (lane > k) val -= v * c;
        if (lane < cols) vr[static_cast<size_t>(r) * cols + lane] = val;
        if (next && r > k + 1) acc += shfl(val, k + 1) * val;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < cols * cols; i += kThreads) t_out[i] = tmat[i / cols][i % cols];
}

template <typename T>
int launch(const void* slab, void* vr, void* t, int rows, int cols, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  leaf_qr_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(slab), static_cast<T*>(vr), static_cast<T*>(t), rows,
      cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. All buffers are device pointers on
// `device`; 1 <= cols <= 32 and rows >= cols (the wrapper checks). The launch
// goes on `stream` and does not synchronize. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int leaf_qr_f64(const void* slab, void* vr, void* t, int rows,
                           int cols, int device, void* stream) {
  return launch<double>(slab, vr, t, rows, cols, device, stream);
}

extern "C" int leaf_qr_f32(const void* slab, void* vr, void* t, int rows,
                           int cols, int device, void* stream) {
  return launch<float>(slab, vr, t, rows, cols, device, stream);
}
