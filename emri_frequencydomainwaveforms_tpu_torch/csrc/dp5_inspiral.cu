// The adaptive Dormand-Prince 5(4) inspiral, every lane's whole loop on the
// card: one warp integrates one lane from its initial state to the stop
// surface, the horizon, max_steps knots or max_iters steps.
//
// Replaces no kernel of the JAX package, whose loop is a lax.while_loop
// under vmap. It exists because the plain version (models/integrate.py's
// integrate_inspiral over models/flux.py's inspiral_rhs) advances the whole
// batch one step at a time from the host: ~1,600 small float64 elementwise
// and index launches and one host read per step, so at the port's shapes
// (64-128 lanes, 130-300 steps) the host's launch path sets the rate and the
// card idles ~90 % of a call. Here a call is one launch.
//
// Algorithm: lane for lane the plain version's, operation for operation:
// the FSAL tableau, the RMS error norm (NaN read as inf), the step-size
// controller (fac clamped to [0.2, 5], no growth after a rejection, h at
// least 1e-6 and at most h_max_frac t_max), the landing on t_max, the
// rejection and halving of a step that crosses the stop surface unless it
// is tiny, max_iters and max_steps, and a lane whose initial rate is not
// finite keeping its one knot. The right-hand side is models/flux.py's
// inspiral_rhs: the exact geodesic's 2x2 Jacobian, the dissipative model
// (Peters-Mathews in closed form, or a FluxGrid by the clamped Catmull-Rom
// stencil of ops/interp2d.py), and the fundamental frequencies as periodic
// trapezoid sums over kNChi Darwin nodes (models/geodesic.py).
//
// Rounding: the plain version runs each operation as its own PyTorch kernel,
// so each is rounded once. Every float64 addition, subtraction,
// multiplication and division of the model goes through the type R below,
// whose operators are __dadd_rn / __dsub_rn / __dmul_rn / __ddiv_rn, which
// nvcc never contracts into an FMA; sqrt, log, pow and floor are the CUDA
// math library's, as PyTorch calls them. Where PyTorch rewrites an
// operation, so does this file: `scalar / tensor` is a reciprocal times the
// scalar, `tensor / python float` a product with the float's reciprocal
// (the caller passes 1 / du and 1 / de), `x ** 2` is x * x, and torch.mean
// over the 4 components adds (q0 + q2) + (q1 + q3) (two threads a row, each
// adding its strided pair; found on the card). The Darwin sums add in
// ops/row_ops.py's order for n <= kSmallMax (csrc/row_ops.cu): lane l of
// the warp adds the nodes j with (j / 2) % 32 == l in increasing j (the
// 16-byte groups of 2 doubles), then the 5-step __shfl_xor_sync butterfly.
// So the card's knots are the plain version's on the card, and a lane's
// knots do not depend on the batch.
//
// What bounds it: the per-step dependent chain. A step is 6 evaluations of
// the right-hand side, each kNChi / 32 = 8 nodes of 2 float64 divisions and
// 2 square roots per lane, a butterfly, and ~30 scalar operations with pow
// or log; every lane of the warp runs the scalar part too (it needs no
// shuffle and keeps the warp's control flow uniform). ~4 us an evaluation
// on an H100, a few milliseconds a trajectory of ~300 steps; the lanes of a
// batch run side by side, one warp per block, so a lane that stops early
// frees its slot and no lane waits for the slowest.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math). Plain C interface, loaded with
// ctypes by ops/dp5_inspiral.py, which checks at load that the order
// constants below equal ops/row_ops.py's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kVecBytes = 16;            // row_sum: a lane's group of consecutive elements
constexpr long long kSmallMax = 2048;    // row_sum: one warp per row up to this length
constexpr int kNChi = 256;               // Darwin nodes (models/geodesic.py _N_CHI)
constexpr int kVec = kVecBytes / 8;      // doubles in a group
constexpr int kRounds = kNChi / (kWarp * kVec);  // groups of a lane
static_assert(kNChi <= kSmallMax && kNChi % (kWarp * kVec) == 0, "one-warp row_sum order");

constexpr double kTwoPi = 2.0 * 3.141592653589793;
constexpr double kChiStep = kTwoPi / kNChi;  // models/geodesic.py's h

// A float64 rounded after every operation, as separate kernels round it.
struct R {
  double v;
  __device__ __forceinline__ R(double x = 0.0) : v(x) {}
};
__device__ __forceinline__ R operator+(R a, R b) { return R(__dadd_rn(a.v, b.v)); }
__device__ __forceinline__ R operator-(R a, R b) { return R(__dsub_rn(a.v, b.v)); }
__device__ __forceinline__ R operator*(R a, R b) { return R(__dmul_rn(a.v, b.v)); }
__device__ __forceinline__ R operator/(R a, R b) { return R(__ddiv_rn(a.v, b.v)); }
__device__ __forceinline__ R operator-(R a) { return R(-a.v); }
__device__ __forceinline__ R sqrt_(R a) { return R(sqrt(a.v)); }
__device__ __forceinline__ R pow_(R a, double b) { return R(pow(a.v, b)); }
__device__ __forceinline__ R log_(R a) { return R(log(a.v)); }
__device__ __forceinline__ R abs_(R a) { return R(fabs(a.v)); }
__device__ __forceinline__ bool isnan_(R a) { return a.v != a.v; }
__device__ __forceinline__ bool isfinite_(R a) { return isfinite(a.v); }
// `1.0 / x` in PyTorch: x.reciprocal() * 1.0
__device__ __forceinline__ R recip(R a) { return R(1.0) / a; }
// a[c] for a lane's c < 4 without indexing a register array
__device__ __forceinline__ double pick(const R a[4], int c) {
  return c == 0 ? a[0].v : c == 1 ? a[1].v : c == 2 ? a[2].v : a[3].v;
}

// PyTorch's NaN-propagating torch.minimum / maximum / clamp.
__device__ __forceinline__ R tmin(R a, R b) {
  return isnan_(a) ? a : isnan_(b) ? b : R(fmin(a.v, b.v));
}
__device__ __forceinline__ R tmax(R a, R b) {
  return isnan_(a) ? a : isnan_(b) ? b : R(fmax(a.v, b.v));
}
__device__ __forceinline__ R clamp_min(R a, double lo) { return isnan_(a) ? a : R(fmax(a.v, lo)); }
__device__ __forceinline__ R clamp_max(R a, double hi) { return isnan_(a) ? a : R(fmin(a.v, hi)); }
__device__ __forceinline__ R clamp(R a, double lo, double hi) {
  return isnan_(a) ? a : R(fmin(fmax(a.v, lo), hi));
}

// Dormand-Prince 5(4), as models/integrate.py's _A, _B5, _B4.
__constant__ double kA[7][6] = {
    {0, 0, 0, 0, 0, 0},
    {1.0 / 5, 0, 0, 0, 0, 0},
    {3.0 / 40, 9.0 / 40, 0, 0, 0, 0},
    {44.0 / 45, -56.0 / 15, 32.0 / 9, 0, 0, 0},
    {19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729, 0, 0},
    {9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176, -5103.0 / 18656, 0},
    {35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784, 11.0 / 84},
};
__constant__ double kB5[7] = {35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784,
                              11.0 / 84, 0.0};
__constant__ double kB4[7] = {5179.0 / 57600, 0.0, 7571.0 / 16695, 393.0 / 640,
                              -92097.0 / 339200, 187.0 / 2100, 1.0 / 40};

enum FluxKind { kPetersMathews = 0, kFluxGrid = 1 };

// What the right-hand side reads besides the state.
struct Model {
  const double* cos_chi;  // (kNChi,) cos of the Darwin nodes, as the plain version computes them
  int kind;               // FluxKind
  const double* grid;     // (n_u, n_e, 2) Edot, Ldot / nu (kFluxGrid)
  long long n_u, n_e;
  double u0, inv_du, e0, inv_de;  // the grid's axes; 1 / du and 1 / de from the host
};

// models/flux.py pn_flux_e_l
__device__ __forceinline__ void pm_flux(R p, R e, R& de, R& dl) {
  const R one_m_e2 = 1.0 - e * e;
  const R fac = one_m_e2 * sqrt_(one_m_e2);
  const R c = -(32.0 / 5.0);
  de = c * pow_(p, -5.0) * fac * (1.0 + (73.0 / 24.0) * e * e + (37.0 / 96.0) * pow_(e, 4.0));
  dl = c * pow_(p, -3.5) * fac * (1.0 + (7.0 / 8.0) * e * e);
}

// ops/interp2d.py _cr_weights
__device__ __forceinline__ void cr_weights(R t, R w[4]) {
  const R t2 = t * t;
  const R t3 = t2 * t;
  w[0] = -0.5 * t3 + t2 - 0.5 * t;
  w[1] = 1.5 * t3 - 2.5 * t2 + 1.0;
  w[2] = -1.5 * t3 + 2.0 * t2 + 0.5 * t;
  w[3] = 0.5 * t3 - 0.5 * t2;
}

// ops/interp2d.py _stencil, one axis: clamped origin and in-cell parameter.
__device__ __forceinline__ long long stencil(R q, double q0, double inv_dq, long long n, R& t) {
  const R f = (q - q0) * inv_dq;
  long long i = (long long)floor(f.v);
  i = i < 1 ? 1 : i > n - 3 ? n - 3 : i;
  t = clamp(f - R((double)i), -1.0, 2.0);
  return i;
}

// models/flux.py multipole_flux_e_l: interp2d_bicubic of the grid at
// (u_of_pe(p, e), e).
__device__ __forceinline__ void grid_flux(const Model& m, R p, R e, R& de, R& dl) {
  const R u = log_(p - (6.0 + 2.0 * e) + 0.5);
  R tx, ty;
  const long long ix = stencil(u, m.u0, m.inv_du, m.n_u, tx);
  const long long iy = stencil(e, m.e0, m.inv_de, m.n_e, ty);
  R wx[4], wy[4];
  cr_weights(tx, wx);
  cr_weights(ty, wy);
  R out0 = 0.0, out1 = 0.0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    R row0 = 0.0, row1 = 0.0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const double* v = m.grid + ((ix + a - 1) * m.n_e + (iy + b - 1)) * 2;
      row0 = row0 + wy[b] * R(__ldg(v));
      row1 = row1 + wy[b] * R(__ldg(v + 1));
    }
    out0 = out0 + wx[a] * row0;
    out1 = out1 + wx[a] * row1;
  }
  de = out0;
  dl = out1;
}

// models/flux.py pdot_edot with _energy_angmom_jacobian.
__device__ __forceinline__ void pdot_edot(const Model& m, R p, R e, R& pdot, R& edot) {
  R de_flux, dl_flux;
  if (m.kind == kFluxGrid) {
    grid_flux(m, p, e, de_flux, dl_flux);
  } else {
    pm_flux(p, e, de_flux, dl_flux);
  }
  const R big_n = (p - 2.0 - 2.0 * e) * (p - 2.0 + 2.0 * e);
  const R big_d = p - 3.0 - e * e;
  const R energy = sqrt_(big_n / (p * big_d));
  const R d32 = big_d * sqrt_(big_d);
  const R j00 = 0.5 * energy * (2.0 * (p - 2.0) / big_n - recip(p) - recip(big_d));
  const R j01 = 0.5 * energy * (2.0 * e / big_d - 8.0 * e / big_n);
  const R j10 = (big_d - 0.5 * p) / d32;
  const R j11 = p * e / d32;
  const R det = j00 * j11 - j01 * j10;
  pdot = (j11 * de_flux - j01 * dl_flux) / det;
  edot = (-j10 * de_flux + j00 * dl_flux) / det;
}

// models/geodesic.py fundamental_frequencies: this lane's nodes of the two
// Darwin integrands summed in row_sum's order, then the butterfly; every
// lane of the warp ends with the same sums.
__device__ __forceinline__ void frequencies(const Model& m, R p, R e, int lane, R& om_phi,
                                            R& om_r) {
  const R pm2 = p - 2.0;
  const R root = sqrt_(pm2 * pm2 - 4.0 * e * e);
  const R pp = p * p;
  const R pm6 = p - 6.0;
  R sum_t = 0.0, sum_phi = 0.0;
#pragma unroll
  for (int g = 0; g < kRounds; ++g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int j = (g * kWarp + lane) * kVec + i;
      const R ecos = e * R(__ldg(m.cos_chi + j));
      const R rad = pm6 - 2.0 * ecos;
      const R one_p = 1.0 + ecos;
      sum_phi = sum_phi + sqrt_(p / rad);
      sum_t = sum_t + pp * root / ((pm2 - 2.0 * ecos) * (one_p * one_p) * sqrt_(rad));
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    sum_t = sum_t + R(__shfl_xor_sync(kFull, sum_t.v, off));
    sum_phi = sum_phi + R(__shfl_xor_sync(kFull, sum_phi.v, off));
  }
  const R t_r = sum_t * kChiStep;
  const R dphi = sum_phi * kChiStep;
  om_phi = dphi / t_r;
  om_r = recip(t_r) * kTwoPi;
}

// models/flux.py inspiral_rhs
__device__ void rhs(const Model& m, R nu, const R y[4], int lane, R k[4]) {
  const R p = y[0];
  const R e = clamp_min(y[1], 1.0e-9);
  R pdot, edot;
  pdot_edot(m, p, e, pdot, edot);
  frequencies(m, p, e, lane, k[2], k[3]);
  k[0] = nu * pdot;
  k[1] = nu * edot;
}

struct Steps {
  long long max_steps, max_iters;
  double rtol, atol, h0, h_max_frac, delta_p_stop;
};

// models/integrate.py integrate_inspiral, for lane blockIdx.x.
__global__ void __launch_bounds__(kWarp) dp5_inspiral_kernel(
    Model m, Steps s, const double* __restrict__ y0, const double* __restrict__ t_max_in,
    const double* __restrict__ nu_in, double* __restrict__ t_out, double* __restrict__ y_out,
    double* __restrict__ k_out, int32_t* __restrict__ n_out, int32_t* __restrict__ iters_out) {
  const long long b = blockIdx.x;
  const int lane = threadIdx.x;
  const R t_max = t_max_in[b];
  const R nu = nu_in[b];
  double* t_knots = t_out + b * s.max_steps;
  double* y_knots = y_out + b * s.max_steps * 4;

  R y[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) y[c] = y0[b * 4 + c];
  if (lane == 0) t_knots[0] = 0.0;
  if (lane < 4) y_knots[lane] = y0[b * 4 + lane];

  R k[7][4];
  rhs(m, nu, y, lane, k[0]);
  bool done = false;
#pragma unroll
  for (int c = 0; c < 4; ++c) done = done || !isfinite_(k[0][c]);

  R t = 0.0, h = s.h0;
  long long count = 1, iters = 0;
  const R h_cap = t_max * s.h_max_frac;
  const R t_land = t_max * (1.0 - 1e-12);
  const R tiny_h = clamp_min(1e-9 * t_max, 1e-3);
  while (!done && iters < s.max_iters && count < s.max_steps) {
    const R hs = tmin(h, t_max - t);  // land exactly on t_max
    for (int i = 1; i < 7; ++i) {
      R yi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) yi[c] = y[c];
      for (int j = 0; j < i; ++j) {
        const R hj = hs * kA[i][j];
#pragma unroll
        for (int c = 0; c < 4; ++c) yi[c] = yi[c] + hj * k[j][c];
      }
      rhs(m, nu, yi, lane, k[i]);
    }
    R y5[4], y4[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) y5[c] = y4[c] = y[c];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const R h5 = hs * kB5[i], h4 = hs * kB4[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        y5[c] = y5[c] + h5 * k[i][c];
        y4[c] = y4[c] + h4 * k[i][c];
      }
    }
    R q[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const R scale = s.atol + s.rtol * tmax(abs_(y[c]), abs_(y5[c]));
      const R r = (y5[c] - y4[c]) / scale;
      q[c] = r * r;
    }
    R err_norm = sqrt_(((q[0] + q[2]) + (q[1] + q[3])) * 0.25);
    if (isnan_(err_norm)) err_norm = R(INFINITY);

    const bool accept = err_norm.v <= 1.0;
    const R fac = clamp(0.9 * pow_(err_norm.v > 0 ? err_norm : R(1e-16), -0.2), 0.2, 5.0);
    const R h_next = tmin(clamp_min(h * (accept ? fac : clamp_max(fac, 1.0)), 1e-6), h_cap);
    const R t_new = t + hs;
    const bool hit_stop = y5[0].v <= (6.0 + 2.0 * y5[1] + s.delta_p_stop).v;
    const bool hit_tmax = t_new.v >= t_land.v;
    // a step crossing the stop surface is rejected and halved unless tiny
    const bool tiny = hs.v <= tiny_h.v;
    const bool accept_final = accept && (!hit_stop || tiny);
    const bool reject_for_stop = accept && hit_stop && !tiny;

    if (accept_final) {
      if (lane == 0) t_knots[count] = t_new.v;
      if (lane < 4) y_knots[count * 4 + lane] = pick(y5, lane);
      count += 1;
      done = hit_stop || hit_tmax;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        k[0][c] = k[6][c];
        y[c] = y5[c];
      }
      t = t_new;
    }
    h = reject_for_stop ? hs * 0.5 : h_next;
    iters += 1;
  }
  if (lane < 4) k_out[b * 4 + lane] = pick(k[0], lane);
  if (lane == 0) {
    n_out[b] = (int32_t)count;
    iters_out[b] = (int32_t)iters;
  }
}

// models/flux.py inspiral_rhs alone, for row blockIdx.x (the card tests
// hold it to the plain version to the bit).
__global__ void __launch_bounds__(kWarp) dp5_rhs_kernel(Model m, const double* __restrict__ y,
                                                          const double* __restrict__ nu,
                                                          double* __restrict__ out) {
  const long long b = blockIdx.x;
  const int lane = threadIdx.x;
  R yb[4], k[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) yb[c] = y[b * 4 + c];
  rhs(m, nu[b], yb, lane, k);
  if (lane < 4) out[b * 4 + lane] = pick(k, lane);
}

Model make_model(const double* cos_chi, int kind, const double* grid, long long n_u,
                 long long n_e, double u0, double inv_du, double e0, double inv_de) {
  Model m;
  m.cos_chi = cos_chi;
  m.kind = kind;
  m.grid = grid;
  m.n_u = n_u;
  m.n_e = n_e;
  m.u0 = u0;
  m.inv_du = inv_du;
  m.e0 = e0;
  m.inv_de = inv_de;
  return m;
}

}  // namespace

// The constants that fix the Darwin sums' order, for the wrapper's check
// against ops/row_ops.py: {kVecBytes, kSmallMax, kNChi}.
extern "C" void dp5_inspiral_constants(long long* out) {
  out[0] = kVecBytes;
  out[1] = kSmallMax;
  out[2] = kNChi;
}

// y0: (n_b, 4) [p, e, Phi_phi, Phi_r]; t_max, nu: (n_b,); cos_chi: (kNChi,);
// grid: (n_u, n_e, 2) when kind is kFluxGrid, else unused. Writes knot 0 and
// each accepted step into t_out (n_b, max_steps) and y_out (n_b, max_steps,
// 4) (past n untouched), the rate at the last knot (the FSAL stage: the
// right-hand side there, to the bit) into k_out (n_b, 4), the live knot
// count into n_out and the lane's iterations into iters_out (n_b,) int32.
// Returns the cudaError_t.
extern "C" int dp5_inspiral_f64(const double* y0, const double* t_max, const double* nu,
                                const double* cos_chi, int kind, const double* grid,
                                long long n_u, long long n_e, double u0, double inv_du,
                                double e0, double inv_de, long long n_b, long long max_steps,
                                long long max_iters, double rtol, double atol, double h0,
                                double h_max_frac, double delta_p_stop, double* t_out,
                                double* y_out, double* k_out, int32_t* n_out,
                                int32_t* iters_out, void* stream) {
  const Model m = make_model(cos_chi, kind, grid, n_u, n_e, u0, inv_du, e0, inv_de);
  const Steps s{max_steps, max_iters, rtol, atol, h0, h_max_frac, delta_p_stop};
  dp5_inspiral_kernel<<<(unsigned)n_b, kWarp, 0, (cudaStream_t)stream>>>(
      m, s, y0, t_max, nu, t_out, y_out, k_out, n_out, iters_out);
  return (int)cudaGetLastError();
}

// y: (n, 4) states, nu: (n,); out: (n, 4) rates. Returns the cudaError_t.
extern "C" int dp5_rhs_f64(const double* y, const double* nu, const double* cos_chi, int kind,
                           const double* grid, long long n_u, long long n_e, double u0,
                           double inv_du, double e0, double inv_de, long long n, double* out,
                           void* stream) {
  const Model m = make_model(cos_chi, kind, grid, n_u, n_e, u0, inv_du, e0, inv_de);
  dp5_rhs_kernel<<<(unsigned)n, kWarp, 0, (cudaStream_t)stream>>>(m, y, nu, out);
  return (int)cudaGetLastError();
}
