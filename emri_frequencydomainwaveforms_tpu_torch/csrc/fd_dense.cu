// Banded FD dense pass: per-run cubic evaluation + windowed accumulation.
//
// Replaces the Pallas TPU kernels of the JAX package,
// emri_frequencydomainwaveforms_tpu/ops/pallas/fd_dense.py:
//   fd_dense_accumulate          (_kernel, one program per mode)
//   fd_dense_accumulate_batched  (_kernel_batched, walker batch x mode grid)
// and computes what the production XLA dense pass computes
// (models/summation_fd.py, _dense_slot_accumulate), which the Pallas body
// lacks in three places: the exact integer-cycle phase term (cycle counts
// nc mod r^3 in int32), the int32 bin-index band mask, and a second slot
// group (the turnover / negative extra slots) with its own window width.
//
// What bounds it: output bytes. At the production shape (128 walkers,
// 1,577,907 bins, 4 float32 spectra) one call writes 128 x 4 x 1.58M x 4 B
// ~= 3.2 GB, against ~34.6M sin/cos evaluations (128 x (16 x 256 x 64 +
// 2 x 64 x 64) bin-slot pairs inside the windows). At 3.35 TB/s the writes
// alone take ~1 ms; the arithmetic is a small fraction of that.
//
// Design: output-stationary. The TPU grid ran modes in order and
// read-modify-wrote each mode's window; on Hopper blocks run in parallel in
// no order and the windows of different slots overlap. So each thread owns
// one output bin of one walker, loops over the slots in the reference's
// order (group 0 = main slots 0..S0-1, then group 1 = extra slots), adds the
// weighted contribution of every slot whose window and band cover the bin
// into four register accumulators, and writes each output byte exactly
// once. The summation order equals the reference's read-modify-write chain;
// there are no atomics and no separate zero fill.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the fast sin/cos intrinsics lose
// accuracy outside [-pi, pi]). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ void accumulate_group(const SlotGroup& grp, int b, int i, int r,
                                                 float inv_r, int cyc_mask, float cyc_scale,
                                                 float acc[4]) {
  const int win = grp.G * r;
  for (int s = 0; s < grp.S; ++s) {
    const int64_t slot = (int64_t)b * grp.S + s;
    const int local = i - grp.g0[slot] * r;
    if (local < 0 || local >= win) continue;
    // band mask as a select: a masked lane adds nothing, whatever its
    // (possibly non-finite) coefficients hold
    if (local < grp.ilo[slot] || local > grp.ihi[slot]) continue;
    const int run = local / r;
    const int bb = local - run * r;
    const int64_t cell = slot * grp.G + run;
    const float* pc = grp.pc + cell * 4;
    const int32_t* nc = grp.nc + cell * 3;
    const float* ec = grp.ec + cell * 8;

    const float xi = (float)bb * inv_r;
    float psi = pc[0] + xi * (pc[1] + xi * (pc[2] + xi * pc[3]));
    // exact integer-cycle phase: (n1 b r^2 + n2 b^2 r + n3 b^3) mod r^3 as
    // a Horner chain reduced by the bitmask after every step, in the
    // reference's order; intermediates stay below 2^30 for |n| < 2^15,
    // r <= 128
    int u = (bb * nc[2]) & cyc_mask;
    u = (r * nc[1] + u) & cyc_mask;
    u = (bb * u) & cyc_mask;
    u = (r * r * nc[0] + u) & cyc_mask;
    u = (bb * u) & cyc_mask;
    psi = psi + (float)u * cyc_scale;
    const float amp = ec[0] + xi * (ec[1] + xi * (ec[2] + xi * ec[3]));
    psi = (psi + ec[4]) + xi * (ec[5] + xi * (ec[6] + xi * ec[7]));
    float sn, cs;
    sincosf(psi, &sn, &cs);
    const float c_re = amp * cs;
    const float c_im = amp * sn;
    const float* w = grp.w + slot * 4;
    acc[0] += c_re * w[0] - c_im * w[1];
    acc[1] += c_re * w[1] + c_im * w[0];
    acc[2] += c_re * w[2] - c_im * w[3];
    acc[3] += c_re * w[3] + c_im * w[2];
  }
}

__global__ void fd_dense_kernel(SlotGroup g_main, SlotGroup g_extra, float* __restrict__ out,
                                int nf, int r, float inv_r, int cyc_mask, float cyc_scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= nf) return;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  accumulate_group(g_main, b, i, r, inv_r, cyc_mask, cyc_scale, acc);
  accumulate_group(g_extra, b, i, r, inv_r, cyc_mask, cyc_scale, acc);
  // (B, 4, nf), bin-major: coalesced stores per channel
  float* o = out + (int64_t)b * 4 * nf + i;
  o[0] = acc[0];
  o[(int64_t)nf] = acc[1];
  o[2 * (int64_t)nf] = acc[2];
  o[3 * (int64_t)nf] = acc[3];
}

}  // namespace

extern "C" int fd_dense_launch(
    const float* pc0, const int32_t* nc0, const float* ec0, const int32_t* ilo0,
    const int32_t* ihi0, const float* w0, const int32_t* g00, int s0, int gb0,
    const float* pc1, const int32_t* nc1, const float* ec1, const int32_t* ilo1,
    const int32_t* ihi1, const float* w1, const int32_t* g01, int s1, int gb1,
    float* out, int n_batch, int nf, int r, float inv_r, float cyc_scale, void* stream) {
  SlotGroup g_main{pc0, nc0, ec0, ilo0, ihi0, w0, g00, s0, gb0};
  SlotGroup g_extra{pc1, nc1, ec1, ilo1, ihi1, w1, g01, s1, gb1};
  const int threads = 256;
  dim3 grid((nf + threads - 1) / threads, n_batch);
  fd_dense_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      g_main, g_extra, out, nf, r, inv_r, r * r * r - 1, cyc_scale);
  return (int)cudaGetLastError();
}
