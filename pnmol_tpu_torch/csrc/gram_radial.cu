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
// What bounds it on the H100: nothing heavy. Each output entry costs dim
// multiply-adds and one exp, and the Gram itself (8 n m bytes in f64) is the
// only large traffic, so the kernel is bound by the store of the output. One
// thread computes one entry; a block of 32 x 8 threads covers an 8-row,
// 32-column output tile, so each warp stores 32 neighbouring entries of one
// row. The block stages its x rows and y rows, dim in chunks of kChunk, and
// their squared norms in shared memory. Ragged edge tiles take bounds
// checks where the TPU kernel padded with 1e30 sentinel points.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kCols = 32;  // output columns per block (threadIdx.x)
constexpr int kRows = 8;   // output rows per block (threadIdx.y)
constexpr int kChunk = 4;  // coordinates staged per pass

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kCols * kRows)
    gram_radial_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       T* __restrict__ out, int n, int m, int dim, int profile,
                       T in2, T out2) {
  __shared__ T sx[kRows][kChunk];
  __shared__ T sy[kCols][kChunk];
  __shared__ T nx[kRows];
  __shared__ T ny[kCols];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int i0 = blockIdx.y * kRows;
  const int j0 = blockIdx.x * kCols;

  T dot = T(0);
  T norm_x = T(0);  // running |x_i|^2 of row ty (kept by threads tx == 0)
  T norm_y = T(0);  // running |y_j|^2 of column tx (kept by threads ty == 0)
  for (int c0 = 0; c0 < dim; c0 += kChunk) {
    // stage kRows x kChunk coordinates of x and kCols x kChunk of y
    if (tid < kRows * kChunk) {
      const int r = tid / kChunk, c = tid % kChunk;
      const int gi = i0 + r, gc = c0 + c;
      sx[r][c] = (gi < n && gc < dim) ? x[static_cast<size_t>(gi) * dim + gc] : T(0);
    } else if (tid < (kRows + kCols) * kChunk) {
      const int t = tid - kRows * kChunk;
      const int r = t / kChunk, c = t % kChunk;
      const int gj = j0 + r, gc = c0 + c;
      sy[r][c] = (gj < m && gc < dim) ? y[static_cast<size_t>(gj) * dim + gc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      dot = add_rn(dot, mul_rn(sx[ty][c], sy[tx][c]));
      if (tx == 0) norm_x = add_rn(norm_x, mul_rn(sx[ty][c], sx[ty][c]));
      if (ty == 0) norm_y = add_rn(norm_y, mul_rn(sy[tx][c], sy[tx][c]));
    }
    __syncthreads();
  }
  if (tx == 0) nx[ty] = norm_x;
  if (ty == 0) ny[tx] = norm_y;
  __syncthreads();

  const int i = i0 + ty;
  const int j = j0 + tx;
  if (i >= n || j >= m) return;
  // d2 = (|x|^2 + |y|^2) - 2 x.y, in the plain version's order
  T d2 = sub_rn(add_rn(nx[ty], ny[tx]), mul_rn(T(2), dot));
  d2 = d2 > T(0) ? d2 : T(0);
  T value;
  if (profile == 0) {
    value = out2 * exp(-d2 * in2 / T(2));
  } else {
    const T r = sqrt(T(5) * d2 * in2);
    value = out2 * (T(1) + r + r * r / T(3)) * exp(-r);
  }
  out[static_cast<size_t>(i) * m + j] = value;
}

template <typename T>
int launch(const void* x, const void* y, void* out, int n, int m, int dim,
           int profile, double input_scale, double output_scale, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kCols, kRows);
  const dim3 grid((m + kCols - 1) / kCols, (n + kRows - 1) / kRows);
  gram_radial_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      n, m, dim, profile, static_cast<T>(input_scale * input_scale),
      static_cast<T>(output_scale * output_scale));
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
