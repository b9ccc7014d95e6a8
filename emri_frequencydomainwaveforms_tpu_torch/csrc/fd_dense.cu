// Banded FD dense pass: per-run cubic evaluation + windowed accumulation.
//
// Replaces the Pallas TPU kernels of the JAX package,
// emri_frequencydomainwaveforms_tpu/ops/pallas/fd_dense.py:
//   fd_dense_accumulate          (_kernel, one program per mode; B = 1 here)
//   fd_dense_accumulate_batched  (_kernel_batched, walker batch x mode grid)
// and computes what the production XLA dense pass computes
// (models/summation_fd.py, _dense_slot_accumulate), which the Pallas body
// lacks in three places: the exact integer-cycle phase term (cycle counts
// nc mod r^3 in int32), the int32 bin-index band mask, and a second slot
// group (the turnover / negative extra slots) with its own window width.
//
// What bounds it: output bytes. At the production shape (128 walkers,
// 1,577,907 bins, 4 float32 spectra) one call writes 128 x 4 x 1.58M x 4 B
// ~= 3.2 GB, against ~14.4M sin/cos evaluations (the bin-slot pairs inside
// the kept bands) and at most ~32 MB of tables. At 3.35 TB/s the writes
// alone take ~0.97 ms; the arithmetic is a small fraction of that.
//
// Design: output-stationary, no atomics, every output byte written once.
// A block owns one walker x kTile contiguous bins (a 2-D grid of tiles x
// walkers). In its prologue the block reads each slot's window start, band
// limits and weights once and compacts, in slot order (main slots, then the
// extra slots), the slots whose kept band [g0 r + i_lo, g0 r + i_hi] meets
// the tile into a shared-memory list. On the production layout the windows
// sit in the lowest ~200k of 1.58M bins, so most tiles find no slot and only
// stream 16-byte zero vectors to the four spectra. In a tile with slots each
// thread owns 4 consecutive bins, walks the list in order (so each bin's sum
// runs in the reference's order), computes each bin's run and in-run offset
// itself (r may be any of 1..128, so 4 bins can straddle runs), reads a
// run's 15 coefficient words through L1 once per run, and stores one float4
// per spectrum. The band mask is a test that skips the bin (a select):
// masked lanes may hold NaN. Rows are padded to a multiple of 32 bins by the
// caller so that every float4 store is aligned; the pad columns hold zeros
// and are never read. The 1024-bin tile was measured best against tiles of
// 2048-8192 bins and against a persistent grid (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the fast sin/cos intrinsics lose
// accuracy outside [-pi, pi], and the envelope phase, unwrapped by a cumsum,
// grows on long bands). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // threads per block
constexpr int kVec = 4;                   // consecutive bins per thread
constexpr int kTile = kThreads * kVec;    // bins of one walker a block owns
constexpr int kWarps = kThreads / 32;

struct SlotGroup {
  const float* pc;    // (B, S, G, 4) phase cubic coefficients (2pi-cycle residuals)
  const int32_t* nc;  // (B, S, G, 3) integer 2pi-cycle counts of p1..p3
  const float* ec;    // (B, S, G, 8) signed-modulus cubic 0:4, envelope-phase cubic 4:8
  const int32_t* ilo; // (B, S) first kept window-local bin (INT32_MAX: dead slot)
  const int32_t* ihi; // (B, S) last kept window-local bin
  const float* w;     // (B, S, 4) weights w1r, w1i, w2r, w2i
  const int32_t* g0;  // (B, S) window start run
  int S;              // slots in the group
  int G;              // runs per window (g_band of the group)
};

// A slot whose kept band meets the block's tile, in summation order.
struct TileSlot {
  long long base;   // output bin of window-local bin 0 (g0 r)
  long long cell0;  // index of the slot's run 0 in its group's (B, S, G) tables
  int lo, hi;       // kept band in output bins, clipped to the tile and [0, nf)
  int group;        // 0: main slots, 1: extra slots
  int pad_;
  float4 w;         // w1r, w1i, w2r, w2i
};

__global__ void __launch_bounds__(kThreads)
fd_dense_kernel(SlotGroup ga, SlotGroup gb, float* __restrict__ out, int nf, int nf_pad, int r,
                float inv_r, int cyc_mask, float cyc_scale) {
  extern __shared__ TileSlot list[];
  __shared__ int warp_count[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_slots = ga.S + gb.S;
  const int b = blockIdx.y;
  const int t_lo = blockIdx.x * kTile;
  const int t_hi = min(t_lo + kTile, nf) - 1;  // last real bin of the tile

  // ---- prologue: the ordered list of slots that meet the tile ----
  int n_list = 0;
  for (int q0 = 0; q0 < n_slots; q0 += kThreads) {
    const int q = q0 + tid;
    bool meets = false;
    TileSlot e;
    if (q < n_slots) {
      const bool second = q >= ga.S;
      const int s = second ? q - ga.S : q;
      const int n_s = second ? gb.S : ga.S;
      const int n_g = second ? gb.G : ga.G;
      const long long slot = (long long)b * n_s + s;
      const int lo_l = max(__ldg((second ? gb.ilo : ga.ilo) + slot), 0);
      const int hi_l = min(__ldg((second ? gb.ihi : ga.ihi) + slot), n_g * r - 1);
      const long long base = (long long)__ldg((second ? gb.g0 : ga.g0) + slot) * r;
      const long long lo = max(base + lo_l, (long long)t_lo);
      const long long hi = min(base + hi_l, (long long)t_hi);
      meets = lo_l <= hi_l && lo <= hi;
      if (meets) {
        e.base = base;
        e.cell0 = slot * n_g;
        e.lo = (int)lo;
        e.hi = (int)hi;
        e.group = second ? 1 : 0;
        e.pad_ = 0;
        e.w = __ldg(reinterpret_cast<const float4*>(second ? gb.w : ga.w) + slot);
      }
    }
    // stable compaction: a slot's place is the count of meeting slots before it
    const unsigned ballot = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = n_list;
    int total = n_list;
    for (int k = 0; k < kWarps; ++k) {
      const int c = warp_count[k];
      before += k < warp ? c : 0;
      total += c;
    }
    if (meets) list[before + __popc(ballot & ((1u << lane) - 1u))] = e;
    n_list = total;
    __syncthreads();
  }

  const int i0 = t_lo + tid * kVec;  // the thread's 4 bins
  if (i0 >= nf_pad) return;
  float* ob = out + (long long)b * 4 * nf_pad + i0;
  if (n_list == 0) {
    // ---- empty tile: streaming zero vectors ----
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int c = 0; c < 4; ++c) __stcs(reinterpret_cast<float4*>(ob + (long long)c * nf_pad), z);
    return;
  }

  // ---- windowed tile ----
  float acc[kVec][4];
#pragma unroll
  for (int v = 0; v < kVec; ++v) acc[v][0] = acc[v][1] = acc[v][2] = acc[v][3] = 0.0f;
  for (int l = 0; l < n_list; ++l) {
    const TileSlot& e = list[l];
    if (i0 + kVec - 1 < e.lo || i0 > e.hi) continue;
    const bool second = e.group != 0;
    const float* pcg = second ? gb.pc : ga.pc;
    const int32_t* ncg = second ? gb.nc : ga.nc;
    const float* ecg = second ? gb.ec : ga.ec;
    const float4 w = e.w;
    int run_prev = -1;
    float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 ea = p, eb = p;
    int n1 = 0, n2 = 0, n3 = 0;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int i = i0 + v;
      if (i < e.lo || i > e.hi) continue;
      const int local = (int)(i - e.base);
      const int run = local / r;
      const int bb = local - run * r;
      if (run != run_prev) {
        const long long cell = e.cell0 + run;
        p = __ldg(reinterpret_cast<const float4*>(pcg) + cell);
        ea = __ldg(reinterpret_cast<const float4*>(ecg) + 2 * cell);
        eb = __ldg(reinterpret_cast<const float4*>(ecg) + 2 * cell + 1);
        n1 = __ldg(ncg + 3 * cell);
        n2 = __ldg(ncg + 3 * cell + 1);
        n3 = __ldg(ncg + 3 * cell + 2);
        run_prev = run;
      }
      const float xi = (float)bb * inv_r;
      float psi = p.x + xi * (p.y + xi * (p.z + xi * p.w));
      // exact integer-cycle phase: (n1 b r^2 + n2 b^2 r + n3 b^3) mod r^3
      // as a Horner chain reduced by the bitmask after every step, in the
      // reference's order; intermediates stay below 2^30 for |n| < 2^15,
      // r <= 128
      int u = (bb * n3) & cyc_mask;
      u = (r * n2 + u) & cyc_mask;
      u = (bb * u) & cyc_mask;
      u = (r * r * n1 + u) & cyc_mask;
      u = (bb * u) & cyc_mask;
      psi = psi + (float)u * cyc_scale;
      const float amp = ea.x + xi * (ea.y + xi * (ea.z + xi * ea.w));
      psi = (psi + eb.x) + xi * (eb.y + xi * (eb.z + xi * eb.w));
      float sn, cs;
      sincosf(psi, &sn, &cs);
      const float c_re = amp * cs;
      const float c_im = amp * sn;
      acc[v][0] += c_re * w.x - c_im * w.y;
      acc[v][1] += c_re * w.y + c_im * w.x;
      acc[v][2] += c_re * w.z - c_im * w.w;
      acc[v][3] += c_re * w.w + c_im * w.z;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    __stcs(reinterpret_cast<float4*>(ob + (long long)c * nf_pad),
           make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]));
  }
}

}  // namespace

extern "C" int fd_dense_launch(
    const float* pc0, const int32_t* nc0, const float* ec0, const int32_t* ilo0,
    const int32_t* ihi0, const float* w0, const int32_t* g00, int s0, int gb0,
    const float* pc1, const int32_t* nc1, const float* ec1, const int32_t* ilo1,
    const int32_t* ihi1, const float* w1, const int32_t* g01, int s1, int gb1,
    float* out, int n_batch, int nf, int nf_pad, int r, float inv_r, float cyc_scale,
    void* stream) {
  SlotGroup ga{pc0, nc0, ec0, ilo0, ihi0, w0, g00, s0, gb0};
  SlotGroup gb{pc1, nc1, ec1, ilo1, ihi1, w1, g01, s1, gb1};
  const dim3 grid((unsigned)((nf_pad + kTile - 1) / kTile), (unsigned)n_batch);
  const size_t smem = (size_t)(s0 + s1) * sizeof(TileSlot);
  fd_dense_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      ga, gb, out, nf, nf_pad, r, inv_r, r * r * r - 1, cyc_scale);
  return (int)cudaGetLastError();
}
