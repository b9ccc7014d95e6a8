// Fixed-order row reductions: each row's result depends on that row's data
// alone, not on how many rows a call holds.
//
// Replaces no kernel of the JAX package. It exists because PyTorch's own CUDA
// reductions choose their launch configuration from the whole tensor's
// shape: torch.sum over the last axis splits a row across more threads when
// there are fewer rows, and torch.cumsum picks its scan's thread shape from
// the row count. Both change the order in which a row is summed, so its last
// bits follow the batch. The adaptive dp5 stepper turns a last-bit
// difference of its right-hand side into another step sequence, so a
// walker's waveform and log L followed its batch on the card (the port's
// testing/batch_dependence.py measures it). These kernels fix the order of
// every sum:
//
//   row_sum     out[i] = sum_j x[i, j]: one block of kThreads threads per
//               row; thread t adds x[i, t], x[i, t + kThreads], ... in that
//               order, then a fixed shared-memory tree adds the partial sums.
//   row_cumsum  out[i, j] = sum_{j' <= j} x[i, j']: one block per row;
//               thread t owns a contiguous chunk of ceil(n / kThreads)
//               elements, adds it in order, thread 0 turns the chunk totals
//               into running offsets in order, then each thread rescans its
//               chunk from its offset.
//
// What bounds them: bytes. row_sum reads each input once (the likelihood's
// (B, 15,780) float64 residual, the RHS's (B, 256) Darwin integrands);
// row_cumsum reads its input twice (chunk totals, then the rescan) and
// writes its output once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math, which would contract and reorder).
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) row_sum_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long n, long long ld, T scale) {
  __shared__ T part[kThreads];
  const T* row = x + (long long)blockIdx.x * ld;
  T acc = 0;
  for (long long j = threadIdx.x; j < n; j += kThreads) acc += row[j];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0] * scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) row_cumsum_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long n, long long ld) {
  __shared__ T offset[kThreads];
  const T* row = x + (long long)blockIdx.x * ld;
  T* orow = out + (long long)blockIdx.x * n;
  const long long chunk = (n + kThreads - 1) / kThreads;
  const long long j0 = min((long long)threadIdx.x * chunk, n);
  const long long j1 = min(j0 + chunk, n);
  T s = 0;
  for (long long j = j0; j < j1; ++j) s += row[j];
  offset[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    T run = 0;
    for (int t = 0; t < kThreads; ++t) {
      const T v = offset[t];
      offset[t] = run;
      run += v;
    }
  }
  __syncthreads();
  T acc = offset[threadIdx.x];
  for (long long j = j0; j < j1; ++j) {
    acc += row[j];
    orow[j] = acc;
  }
}

}  // namespace

// x: n_rows rows of n elements, row stride ld (elements); out: n_rows values
// times scale (1 for a sum, 1/n for a mean). Returns the cudaError_t.
extern "C" int row_sum_f64(const double* x, double* out, long long n_rows, long long n,
                           long long ld, double scale, void* stream) {
  row_sum_kernel<double><<<(unsigned)n_rows, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, n, ld, scale);
  return (int)cudaGetLastError();
}

extern "C" int row_sum_f32(const float* x, float* out, long long n_rows, long long n,
                           long long ld, float scale, void* stream) {
  row_sum_kernel<float><<<(unsigned)n_rows, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, n, ld, scale);
  return (int)cudaGetLastError();
}

// x: n_rows rows of n elements, row stride ld; out: (n_rows, n) contiguous.
extern "C" int row_cumsum_f64(const double* x, double* out, long long n_rows, long long n,
                              long long ld, void* stream) {
  row_cumsum_kernel<double><<<(unsigned)n_rows, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, n, ld);
  return (int)cudaGetLastError();
}

extern "C" int row_cumsum_f32(const float* x, float* out, long long n_rows, long long n,
                              long long ld, void* stream) {
  row_cumsum_kernel<float><<<(unsigned)n_rows, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, n, ld);
  return (int)cudaGetLastError();
}
