// Householder LQ of one wide panel: the CUDA counterpart of the TPU panel
// kernels `_block_lq_kernel` (pnmol_tpu/ops/qr_householder.py:535) and
// `_leaf_lq_kernel` (pnmol_tpu/ops/qr_householder.py:350).
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
//
// What it computes, not how the TPU kernels block it: the leaf loop and the
// leaf-to-block T^T merge exist for Mosaic's VMEM tiling. Here one unblocked
// recurrence runs over all panel rows: each reflector updates every later
// row, and row k of T^T is -tau_k (V_{<k} v_k)^T T^T. This gives the same
// LV and T^T to rounding.
//
// What bounds it on the H100: the reflector chain is serial (reflector k
// needs row k after reflectors 0..k-1), and an f64 panel at the solver's
// shapes (128 x 3586, 3.7 MB) is far above the 227 KB of shared memory one
// block can use. So this first design runs ONE block of 1024 threads per
// panel and streams the panel through global memory, where it stays in the
// 50 MB L2. Per reflector: a block-wide reduction forms alpha and sigma of
// row k, then each warp takes whole rows, computes s_j = row_j . v_k
// (coalesced, four loads in flight per lane) and applies the rank-1 update
// in place. Its time is L2 traffic from one SM, about 3 * rows * cols * 8
// bytes per reflector. Spreading a panel over a thread-block cluster
// (DSMEM) or a cooperative grid is later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    panel_lq_kernel(const T* __restrict__ slab, T* lv, T* tt, T* z, int rows,
                    int cols, int off) {
  __shared__ T red[kWarps];
  __shared__ T s_tau, s_beta, s_inv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const size_t total = static_cast<size_t>(rows) * cols;
  for (size_t i = tid; i < total; i += kThreads) lv[i] = slab[i];
  __syncthreads();

  for (int k = 0; k < rows; ++k) {
    const int d = off + k;  // diagonal lane of row k
    T* xk = lv + static_cast<size_t>(k) * cols;

    // --- alpha and sigma of row k (block-wide reduction) ------------------
    T part = T(0);
    for (int l = d + 1 + tid; l < cols; l += kThreads) {
      const T x = xk[l];
      part += x * x;
    }
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (warp == 0) {
      T sigma = lane < kWarps ? red[lane] : T(0);
      sigma = warp_sum(sigma);
      if (lane == 0) {
        const T alpha = xk[d];
        const T norm = sqrt(alpha * alpha + sigma);
        const T sign = alpha >= T(0) ? T(1) : T(-1);
        const T beta = -sign * norm;
        const bool safe = norm > T(0);
        s_inv = safe ? T(1) / (alpha - beta) : T(0);
        s_tau = safe ? (beta - alpha) / beta : T(0);
        s_beta = beta;
      }
    }
    __syncthreads();
    const T tau = s_tau;
    const T inv = s_inv;

    // --- row k becomes [L | beta | reflector tail] -------------------------
    for (int l = d + 1 + tid; l < cols; l += kThreads) xk[l] *= inv;
    if (tid == 0) xk[d] = s_beta;
    __syncthreads();

    // --- s_j = row_j . v_k for every other row; rank-1 update below k ------
    // Rows above k hold reflector tails at lanes >= d (their diagonals are
    // left of d), so their dot is z_j = V_j . v_k for the T^T row. A zero
    // tau is the identity reflector: no update, and a zero T^T row.
    if (tau != T(0)) {
      for (int j = warp; j < rows; j += kWarps) {
        if (j == k) continue;
        T* xj = lv + static_cast<size_t>(j) * cols;
        T s = lane == 0 ? xj[d] : T(0);
        for (int l0 = d + 1 + lane; l0 < cols; l0 += 32 * kUnroll) {
          T a[kUnroll], b[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int l = l0 + 32 * u;
            a[u] = l < cols ? xj[l] : T(0);
            b[u] = l < cols ? xk[l] : T(0);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) s += a[u] * b[u];
        }
        s = warp_sum(s);
        if (j < k) {
          if (lane == 0) z[j] = s;
          continue;
        }
        const T c = tau * s;
        if (lane == 0) xj[d] -= c;
        for (int l0 = d + 1 + lane; l0 < cols; l0 += 32 * kUnroll) {
          T a[kUnroll], b[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int l = l0 + 32 * u;
            a[u] = l < cols ? xj[l] : T(0);
            b[u] = l < cols ? xk[l] : T(0);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int l = l0 + 32 * u;
            if (l < cols) xj[l] = a[u] - c * b[u];
          }
        }
      }
    }
    __syncthreads();

    // --- row k of T^T: -tau z^T T^T at lanes < k, tau on the diagonal ------
    for (int i = tid; i < rows; i += kThreads) {
      T val = T(0);
      if (i < k && tau != T(0)) {
        T acc = T(0);
        for (int m = i; m < k; ++m)
          acc += z[m] * tt[static_cast<size_t>(m) * rows + i];
        val = -tau * acc;
      } else if (i == k) {
        val = tau;
      }
      tt[static_cast<size_t>(k) * rows + i] = val;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* slab, void* lv, void* tt, void* z, int rows, int cols,
           int off, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  panel_lq_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(slab), static_cast<T*>(lv), static_cast<T*>(tt),
      static_cast<T*>(z), rows, cols, off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. `z` is scratch of `rows` elements; all
// buffers are device pointers on `device`; the launch goes on `stream` and
// does not synchronize. Returns the cudaError_t of the launch (0 = success).
extern "C" int panel_lq_f64(const void* slab, void* lv, void* tt, void* z,
                            int rows, int cols, int off, int device,
                            void* stream) {
  return launch<double>(slab, lv, tt, z, rows, cols, off, device, stream);
}

extern "C" int panel_lq_f32(const void* slab, void* lv, void* tt, void* z,
                            int rows, int cols, int off, int device,
                            void* stream) {
  return launch<float>(slab, lv, tt, z, rows, cols, off, device, stream);
}
