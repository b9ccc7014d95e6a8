// Fixed-order row reductions: each row's result depends on that row's data,
// its length n and its dtype alone, never on how many rows a call holds, on
// the row's stride, on the alignment of its first element or on timing.
//
// Replaces no kernel of the JAX package. It exists because PyTorch's own CUDA
// reductions choose their launch configuration from the whole tensor's
// shape: torch.sum over the last axis splits a row across more threads when
// there are fewer rows, and torch.cumsum picks its scan's thread shape from
// the row count. Both change the order in which a row is summed, so its last
// bits follow the batch. The adaptive dp5 stepper turns a last-bit
// difference of its right-hand side into another step sequence, so a
// walker's waveform and log L followed its batch on the card (the port's
// testing/batch_dependence.py measures it).
//
//   row_sum     out[i] = scale * sum_j x[i, j] (scale 1 for a sum, 1/n for a
//               mean). n <= kSmallMax: one warp per row, 8 rows a block.
//               Lane l adds, in increasing j, the elements of the groups of
//               kVec consecutive elements whose index g = j / kVec has
//               g % 32 == l, then a fixed 5-step __shfl_xor_sync butterfly
//               adds the 32 lane sums (no shared memory, no __syncthreads).
//               n > kSmallMax: one block of 32 warps per row; the row is cut
//               into chunks of kChunk elements, warp w sums chunks w, w + 32,
//               ... as above, and thread 0 adds the chunk partials from
//               shared memory in chunk order: ((0 + p_0) + p_1) + ... At the
//               likelihood's 15,780 float64 bins the 31 chunks are in flight
//               at once, the whole row in one round trip; one launch, no
//               scratch, and no second launch whose host cost would exceed
//               the device time it saves.
//   row_cumsum  out[i, j] = sum_{j' <= j} x[i, j']: one block of
//               kScanThreads threads per row walks it in tiles of
//               kScanThreads * K elements (K = 8 for float32, 4 for
//               float64). A tile is loaded with coalesced 16-byte loads
//               (the next tile's loads are issued before this tile's scan)
//               into padded shared memory; thread t scans its K contiguous
//               elements serially, a Kogge-Stone __shfl_up_sync scan adds the
//               thread totals within each warp, each thread adds the 8 warp
//               totals in warp order, and a running carry adds the tiles in
//               tile order: out = (carry + (warp offset + lane offset)) +
//               local prefix. The results leave through shared memory as
//               coalesced stores. The input is read once, the output written
//               once.
//
// How the order is fixed: every tree, chunk and tile above is a function of
// n and the dtype (kVec = 16 bytes / sizeof(T)), so a row's additions are
// the same in any launch. A row whose first element is not 16-byte aligned
// (a row sliced out of a larger batch, or an odd row stride) takes scalar
// loads of the same elements in the same order: loads differ, additions do
// not. Atomics and a decoupled look-back are excluded: both add partials in
// the order the blocks happen to finish. No split grows with the row count.
// testing/row_order.py replays every addition in torch, and the card tests
// hold these kernels to it bit for bit; ops/row_ops.py checks at load that
// its copy of the constants below equals row_ops_constants().
//
// What bounds them on an H100: bytes at the path's big shapes (row_cumsum at
// (64 x 48, 15780) float32 moves 388 MB; row_sum at (32768, 256) float32
// reads 33.5 MB, at (64, 15780) float64 8.1 MB), launch latency at the
// RHS's (64, 256) float64, where the device work is a few microseconds and
// the host's launch path sets the rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math, which would contract and reorder).
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kVecBytes = 16;
constexpr long long kSmallMax = 2048;  // n <= kSmallMax: one warp per row
constexpr long long kChunk = 512;      // n > kSmallMax: one warp per chunk
constexpr int kSumWarps = 8;           // rows per block of the one-warp row_sum
constexpr int kLongWarps = 32;         // warps per row of the long-row row_sum
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / kWarp;

template <typename T> struct Shape;
template <> struct Shape<float> {
  using Vec = float4;
  static constexpr int kVec = 4;
  static constexpr int kScanK = 8;
};
template <> struct Shape<double> {
  using Vec = double2;
  static constexpr int kVec = 2;
  static constexpr int kScanK = 4;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0;
}

// A 16-byte group's elements, in index order.
__device__ __forceinline__ void unpack(const float4& v, float* e) {
  e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* e) {
  e[0] = v.x; e[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float* e) {
  return make_float4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ double2 pack(const double* e) { return make_double2(e[0], e[1]); }

template <typename T>
__device__ __forceinline__ T add_in_order(T acc, const typename Shape<T>::Vec& v) {
  T e[Shape<T>::kVec];
  unpack(v, e);
#pragma unroll
  for (int i = 0; i < Shape<T>::kVec; ++i) acc += e[i];
  return acc;
}

// The sum of seg[0, len) by one warp (every lane gets it): lane l adds its
// groups g = l, l + 32, ... of kVec elements in increasing order, the last
// (partial) group last, then the butterfly. kBatch loads of a lane are in
// flight at once (registers against latency); it does not touch the order.
template <int kBatch, typename T>
__device__ __forceinline__ T warp_segment_sum(const T* __restrict__ seg, long long len,
                                              int lane) {
  constexpr int V = Shape<T>::kVec;
  using Vec = typename Shape<T>::Vec;
  const long long groups = len / V;
  T acc = 0;
  if (aligned16(seg)) {
    // up to kBatch loads in flight, then their additions in order
    const Vec* v = reinterpret_cast<const Vec*>(seg);
    for (long long g = lane; g < groups; g += kBatch * kWarp) {
      Vec a[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (g + u * kWarp < groups) a[u] = v[g + u * kWarp];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (g + u * kWarp < groups) acc = add_in_order<T>(acc, a[u]);
    }
  } else {
    for (long long g = lane; g < groups; g += kWarp)
      for (int i = 0; i < V; ++i) acc += seg[g * V + i];
  }
  if (groups * V < len && lane == groups % kWarp)
    for (long long j = groups * V; j < len; ++j) acc += seg[j];
  for (int off = kWarp / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// n <= kSmallMax: warp w of the grid sums row w.
template <typename T>
__global__ void __launch_bounds__(kSumWarps * kWarp) row_sum_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long n_rows, long long n, long long ld,
    T scale) {
  const int lane = threadIdx.x % kWarp;
  const long long row = (long long)blockIdx.x * kSumWarps + threadIdx.x / kWarp;
  if (row >= n_rows) return;  // the whole warp leaves together
  const T s = warp_segment_sum<4>(x + row * ld, n, lane);
  if (lane == 0) out[row] = s * scale;
}

// n > kSmallMax: block b sums row b, warp w its chunks w, w + kLongWarps, ...;
// each round of kLongWarps chunk partials is added in chunk order by thread 0.
template <typename T>
__global__ void __launch_bounds__(kLongWarps * kWarp) row_sum_long_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long n, long long ld, T scale) {
  __shared__ T s_part[kLongWarps];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const T* row = x + (long long)blockIdx.x * ld;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  T acc = 0;  // thread 0's running sum of the partials
  for (long long first = 0; first < n_chunks; first += kLongWarps) {
    const long long c = first + warp;
    if (c < n_chunks) {
      const long long lo = c * kChunk;
      const T p = warp_segment_sum<8>(row + lo, min(kChunk, n - lo), lane);
      if (lane == 0) s_part[warp] = p;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long m = min((long long)kLongWarps, n_chunks - first);
      for (long long i = 0; i < m; ++i) acc += s_part[i];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc * scale;
}

// Shared-memory index of tile element j: one pad slot after every 128 bytes,
// so that thread t's K contiguous elements and the 16-byte groups of
// neighbouring lanes fall in distinct banks.
template <typename T>
__device__ __forceinline__ int padded(int j) {
  return j + j / (128 / (int)sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kScanThreads) row_cumsum_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long n, long long ld) {
  constexpr int K = Shape<T>::kScanK, V = Shape<T>::kVec;
  constexpr int kTile = kScanThreads * K, kLoads = K / V;
  constexpr int kPadded = kTile + kTile / (128 / (int)sizeof(T));
  using Vec = typename Shape<T>::Vec;
  __shared__ T s_in[kPadded];
  __shared__ T s_out[kPadded];
  __shared__ T s_warp[kScanWarps];
  const int t = threadIdx.x, lane = t % kWarp, warp = t / kWarp;
  const T* row = x + (long long)blockIdx.x * ld;
  T* orow = out + (long long)blockIdx.x * n;
  const bool in_vec = aligned16(row), out_vec = aligned16(orow);

  // reg holds this thread's share of one tile: with vector loads, group
  // t + q kScanThreads (elements V (t + q kScanThreads) + i at reg[q V + i]);
  // with scalar loads, element t + i kScanThreads at reg[i]. Past n: 0.
  T reg[K];
  auto load = [&](long long base) {
    if (in_vec) {
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const long long j = base + (long long)(t + q * kScanThreads) * V;
        if (j + V <= n) {
          unpack(*reinterpret_cast<const Vec*>(row + j), reg + q * V);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) reg[q * V + i] = j + i < n ? row[j + i] : T(0);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const long long j = base + t + i * kScanThreads;
        reg[i] = j < n ? row[j] : T(0);
      }
    }
  };
  auto stash = [&]() {
    if (in_vec) {
#pragma unroll
      for (int q = 0; q < kLoads; ++q)
#pragma unroll
        for (int i = 0; i < V; ++i)
          s_in[padded<T>((t + q * kScanThreads) * V + i)] = reg[q * V + i];
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) s_in[padded<T>(t + i * kScanThreads)] = reg[i];
    }
  };

  const long long n_tiles = (n + kTile - 1) / kTile;
  T carry = 0;
  load(0);
  for (long long tile = 0; tile < n_tiles; ++tile) {
    const long long base = tile * kTile;
    stash();
    __syncthreads();
    if (tile + 1 < n_tiles) load(base + kTile);  // in flight during this tile's scan

    T v[K];
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = s_in[padded<T>(t * K + i)];
#pragma unroll
    for (int i = 1; i < K; ++i) v[i] = v[i - 1] + v[i];
    T incl = v[K - 1];
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const T y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = y + incl;
    }
    T excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0;
    if (lane == kWarp - 1) s_warp[warp] = incl;
    __syncthreads();

    T before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kScanWarps; ++w) {
      if (w == warp) before = total;
      total = total + s_warp[w];
    }
    const T prefix = carry + (before + excl);
#pragma unroll
    for (int i = 0; i < K; ++i) s_out[padded<T>(t * K + i)] = prefix + v[i];
    carry = carry + total;
    __syncthreads();

    if (out_vec) {
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int e = (t + q * kScanThreads) * V;
        const long long j = base + e;
        if (j + V <= n) {
          T o[V];
#pragma unroll
          for (int i = 0; i < V; ++i) o[i] = s_out[padded<T>(e + i)];
          *reinterpret_cast<Vec*>(orow + j) = pack(o);
        } else {
          for (int i = 0; i < V && j + i < n; ++i) orow[j + i] = s_out[padded<T>(e + i)];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int e = t + i * kScanThreads;
        if (base + e < n) orow[base + e] = s_out[padded<T>(e)];
      }
    }
  }
}

template <typename T>
int launch_row_sum(const T* x, T* out, long long n_rows, long long n, long long ld, T scale,
                   cudaStream_t stream) {
  if (n <= kSmallMax) {
    const unsigned blocks = (unsigned)((n_rows + kSumWarps - 1) / kSumWarps);
    row_sum_kernel<T><<<blocks, kSumWarps * kWarp, 0, stream>>>(x, out, n_rows, n, ld, scale);
  } else {
    row_sum_long_kernel<T><<<(unsigned)n_rows, kLongWarps * kWarp, 0, stream>>>(x, out, n, ld,
                                                                                scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The constants that fix the order, for the wrapper's check against its own
// copy: {kVecBytes, kSmallMax, kChunk, kScanThreads, K float32, K float64}.
extern "C" void row_ops_constants(long long* out) {
  out[0] = kVecBytes;
  out[1] = kSmallMax;
  out[2] = kChunk;
  out[3] = kScanThreads;
  out[4] = Shape<float>::kScanK;
  out[5] = Shape<double>::kScanK;
}

// x: n_rows rows of n elements, row stride ld (elements); out: n_rows values
// times scale (1 for a sum, 1/n for a mean). Returns the cudaError_t.
extern "C" int row_sum_f64(const double* x, double* out, long long n_rows, long long n,
                           long long ld, double scale, void* stream) {
  return launch_row_sum<double>(x, out, n_rows, n, ld, scale, (cudaStream_t)stream);
}

extern "C" int row_sum_f32(const float* x, float* out, long long n_rows, long long n,
                           long long ld, float scale, void* stream) {
  return launch_row_sum<float>(x, out, n_rows, n, ld, scale, (cudaStream_t)stream);
}

// x: n_rows rows of n elements, row stride ld; out: (n_rows, n) contiguous.
extern "C" int row_cumsum_f64(const double* x, double* out, long long n_rows, long long n,
                              long long ld, void* stream) {
  row_cumsum_kernel<double><<<(unsigned)n_rows, kScanThreads, 0, (cudaStream_t)stream>>>(
      x, out, n, ld);
  return (int)cudaGetLastError();
}

extern "C" int row_cumsum_f32(const float* x, float* out, long long n_rows, long long n,
                              long long ld, void* stream) {
  row_cumsum_kernel<float><<<(unsigned)n_rows, kScanThreads, 0, (cudaStream_t)stream>>>(
      x, out, n, ld);
  return (int)cudaGetLastError();
}
