// Dense radial-kernel Gram matrix: the CUDA counterpart of the TPU kernel
// `_gram_tile_kernel` (pnmol_tpu/ops/pallas_gram.py:51).
//
// Contract: given row-major point clouds x (n, dim) and y (m, dim), already
// centred by the caller on the mean of x, write the row-major Gram
//   out[i, j] = phi(max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0))
// with phi the squared-exponential profile (profile 0)
//   s_out^2 exp(-d2 s_in^2 / 2)
// or the Matern(5/2) profile (profile 1)
//   r = sqrt(5 d2 s_in^2),  s_out^2 (1 + r + r^2 / 3) exp(-r).
// It evaluates the same distance-trick formula as the TPU kernel and the
// plain PyTorch version (not (x - y)^2), and forms d2 with explicitly
// rounded operations so that nvcc does not contract it into FMAs: the
// result matches the plain version to the rounding of exp and sqrt.
//
// What bounds it on the H100: the store of the output. Each entry costs dim
// multiply-adds and one exp, and the Gram itself (8 n m bytes in f64, 134 MB
// at 4096 x 4096) is the only large traffic. So the design spends its effort
// on the stores:
//   - a block of 256 threads takes a 32-row, 128-column output tile, and
//     each thread a run of 16-byte neighbours (2 doubles or 4 floats) in
//     each of several rows (8 in f64, 4 in f32): every store is one 16-byte
//     vector, and a warp writes 512 contiguous bytes of one row;
//   - the tile's coordinates are staged in shared memory once per tile, 4 at
//     a time: for dim <= 4, which covers every mesh the port builds, one
//     barrier per tile and none inside the dim loop; each thread forms the
//     squared norms of its own rows and columns from the staged values;
//   - ragged edge tiles (and rows whose start is not 16-byte aligned, when m
//     is not a multiple of the vector) take bounds-checked scalar stores
//     where the TPU kernel padded with 1e30 sentinel points.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 32;   // output rows per block
constexpr int kTileCols = 128;  // output columns per block
constexpr int kChunk = 4;       // coordinates staged per pass

// a thread's run of neighbouring entries, stored as one 16-byte vector
template <typename T>
struct Vec;
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ T profile_value(T d2, int profile, T in2, T out2) {
  if (profile == 0) return out2 * exp(-d2 * in2 / T(2));
  const T r = sqrt(T(5) * d2 * in2);
  return out2 * (T(1) + r + r * r / T(3)) * exp(-r);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gram_radial_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       T* __restrict__ out, int n, int m, int dim, int profile,
                       T in2, T out2, int vector_rows) {
  constexpr int kVec = Vec<T>::n;
  constexpr int kRowThreads = kTileCols / kVec;     // threads along a tile row
  constexpr int kRowStep = kThreads / kRowThreads;  // rows between a thread's rows
  constexpr int kRowsPer = kTileRows / kRowStep;    // rows per thread
  __shared__ T sx[kChunk][kTileRows];
  __shared__ T sy[kChunk][kTileCols];

  const int tid = threadIdx.x;
  const int ty = tid / kRowThreads;
  const int jt = kVec * (tid % kRowThreads);  // first column of the run, in the tile
  const int i0 = blockIdx.y * kTileRows;
  const int j0 = blockIdx.x * kTileCols;

  // x_i . y_j, |x_i|^2 and |y_j|^2, summed coordinate by coordinate
  T dot[kRowsPer][kVec], nx[kRowsPer], ny[kVec];
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) {
    nx[r] = T(0);
#pragma unroll
    for (int v = 0; v < kVec; ++v) dot[r][v] = T(0);
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) ny[v] = T(0);

  for (int c0 = 0; c0 < dim; c0 += kChunk) {
    if (c0 > 0) __syncthreads();  // every thread is done with the last chunk
    for (int e = tid; e < (kTileRows + kTileCols) * kChunk; e += kThreads) {
      const bool is_x = e < kTileRows * kChunk;
      const int t = is_x ? e : e - kTileRows * kChunk;
      const int r = t / kChunk, c = c0 + t % kChunk;
      const int g = (is_x ? i0 : j0) + r;
      if (is_x)
        sx[t % kChunk][r] = g < n && c < dim ? x[static_cast<size_t>(g) * dim + c] : T(0);
      else
        sy[t % kChunk][r] = g < m && c < dim ? y[static_cast<size_t>(g) * dim + c] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c0 + c >= dim) break;  // the same for the whole block
      T yv[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        yv[v] = sy[c][jt + v];
        ny[v] = add_rn(ny[v], mul_rn(yv[v], yv[v]));
      }
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) {
        const T xv = sx[c][ty + r * kRowStep];
        nx[r] = add_rn(nx[r], mul_rn(xv, xv));
#pragma unroll
        for (int v = 0; v < kVec; ++v) dot[r][v] = add_rn(dot[r][v], mul_rn(xv, yv[v]));
      }
    }
  }

  const int j = j0 + jt;
  if (j >= m) return;
  const bool whole = vector_rows && j + kVec <= m;
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) {
    const int i = i0 + ty + r * kRowStep;
    if (i >= n) break;
    T value[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      // d2 = (|x|^2 + |y|^2) - 2 x.y, in the plain version's order
      T d2 = sub_rn(add_rn(nx[r], ny[v]), mul_rn(T(2), dot[r][v]));
      d2 = d2 > T(0) ? d2 : T(0);
      value[v] = profile_value(d2, profile, in2, out2);
    }
    T* row = out + static_cast<size_t>(i) * m + j;
    if (whole) {
      typename Vec<T>::type packed;
      T* lanes = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int v = 0; v < kVec; ++v) lanes[v] = value[v];
      *reinterpret_cast<typename Vec<T>::type*>(row) = packed;
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (j + v < m) row[v] = value[v];
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, int n, int m, int dim,
           int profile, double input_scale, double output_scale, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every row's start is 16-byte aligned iff out is and m is a multiple of
  // the vector
  const int vector_rows = reinterpret_cast<std::uintptr_t>(out) % 16 == 0 &&
                          m % Vec<T>::n == 0;
  const dim3 grid((m + kTileCols - 1) / kTileCols, (n + kTileRows - 1) / kTileRows);
  gram_radial_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      n, m, dim, profile, static_cast<T>(input_scale * input_scale),
      static_cast<T>(output_scale * output_scale), vector_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. All buffers are device pointers on
// `device`; the launch goes on `stream` and does not synchronize. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int gram_radial_f64(const void* x, const void* y, void* out, int n,
                               int m, int dim, int profile, double input_scale,
                               double output_scale, int device, void* stream) {
  return launch<double>(x, y, out, n, m, dim, profile, input_scale,
                        output_scale, device, stream);
}

extern "C" int gram_radial_f32(const void* x, const void* y, void* out, int n,
                               int m, int dim, int profile, double input_scale,
                               double output_scale, int device, void* stream) {
  return launch<float>(x, y, out, n, m, dim, profile, input_scale,
                       output_scale, device, stream);
}
