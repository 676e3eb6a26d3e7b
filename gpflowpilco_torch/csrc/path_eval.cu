// Fused pathwise GP drift evaluation for Hopper (sm_90a), float32 and float64.
//
// Replaces the TPU kernels of gpflowpilco_tpu/ops/path_eval_pallas.py:
//   path_eval_fwd_{f32,f64}      <- _fwd_kernel (:58), launched by _fused_fwd_impl (:155)
//   path_eval_bwd_dx_{f32,f64}   <- _bwd_dx_kernel (:102), launched by _fused_vjp_bwd (:186)
//   path_eval_bwd_full_{f32,f64} <- _bwd_kernel (:90), launched by _fused_vjp_bwd (:186)
//
// For particle s and latent l, with w and v pre-scaled by the caller:
//   f[s,l] = sum_b cos(x_s . omega_lb + phase_lb) w[s,l,b]
//          + sum_m exp(-1/2 |x_s * il_l - z_lm|^2) v[s,l,m]
// where |x~ - z~|^2 = |x~|^2 + z2_lm - 2 x~ . z~, clamped at 0.
// The backward recomputes proj and k rather than storing them:
//   dx[s,:] = sum_l g[s,l] ( -sum_b sin(proj) w omega_lb
//                            + (sum_m kv z_lm - sum_m kv x~_s) il_l ),  kv = k v
//   dw[s,l,b] = cos(proj) g[s,l],   dv[s,l,m] = k g[s,l]   (full backward only)
//
// Bound on an H100 (SXM, 3.35 TB/s): every launch must read w (S,L,B) and
// v (S,L,M) once, and the full backward also write dw and dv; at S=B=1024,
// L=4, M=240 in float32 that is 20.7 MB (6.2 us), 41.4 MB (12.4 us) for the
// full backward, twice both in float64. The arithmetic (S*L*(B+M) ~ 5.2 M
// transcendentals and ~76 MFLOP) is far below that.
//
// Every entry runs on the same grid: latents on the block grid, (ceil(S /
// kTP), L) blocks of kTP particles, a warp a particle (kTP = 32 in float32,
// 128 blocks at S=1024, L=4, so each latent's tables are read from L2 by
// S/kTP blocks only; 16 in float64, whose 64 registers a thread at 1024
// threads would hold only 32 doubles). A block stages its latent's tables
// once into shared memory by cp.async as panels: row d < D holds coordinate
// d of every column (omega_lb, or z~_lm for the centers), row D the
// per-column scalar (phase_lb or z2_lm); the bases fill columns [0, bw),
// the centers [bw, bw + mw) (B and M rounded up to 4, the pads zero). Lane
// j takes the groups of 4 columns j, j + 32, ... in order; each group's w
// or v values arrive by cp.async kRing groups ahead into the lane's own
// shared-memory slots, 16 bytes a copy (one copy a group in float32, two in
// float64) where the rows are 16-byte aligned; the ring is 64 KB in both
// types. The lane's partial sums meet by a butterfly: no block barrier
// after staging. Columns that outgrow shared memory are staged in chunks of
// cw (a multiple of 128, so every lane has the same groups in each chunk;
// ops/path_eval_cuda.py:fwd_plan), a block barrier around each.
//
// Trigonometry: one range reduction gives both sin and cos. float32:
// x - 2 pi k (Cody-Waite, FMA), then the SFU's __sinf/__cosf, for a group
// whose arguments are within kTrigFast = 105615; float64 (no SFU): x - k
// pi/2 (two-part Cody-Waite, FMA), Taylor polynomials of sin and cos to
// r^17 on [-pi/4, pi/4], the quadrant's signs, within 2^20. A group past
// the bound takes sinf()/cosf() (sin()/cos()), whose Payne-Hanek slow
// paths keep a stack frame in local memory, off the fast path.
//
// Forward (fwd_warp, K1a): per group the lane's dots from the panels, the
// bases' cos(x . omega + phase) w, the centers' exp(-|x~ - z~|^2 / 2) v; x
// is scaled by il_l in place at the lane's first centers group.
//
// Backward (bwd_lanes; bwd_warp, K1b, dx only, and bwd_full_warp, K1c, dx,
// dw and dv): the forward's grid, staging, weight stream and
// lane-to-column partition. Once staged, the centers' rows are scaled by
// il_l in place, so that one sum per coordinate takes both kinds of
// column. Per group of 4 columns a lane computes the dots (proj, and -d2/2)
// once from the panels, then adds c_q times the group's rows: the bases' c
// = -sin(proj) w, the centers' kv = exp(-d2 / 2) v, also summed alone. At
// D <= 6 four of the rows stay in registers from the dots (not in float32
// K1c).
// K1c also writes the group's dw = cos(proj) g or dv = exp(-d2 / 2) g, 16
// bytes a store where the rows are aligned: dx's arithmetic is K1b's, so
// the two give the same dx bit for bit. The lane sums meet by butterfly and lane 0
// forms g[s,l] (acc - sum kv x~ il_l). With L > 1 each block writes its
// latent's partial dx_l into a (L, S, D) scratch and bwd_finish adds l = 0
// .. L-1 in order (no float atomics); with L = 1 the block writes dx itself.
//
// The |x|^2+|z|^2-2x.z cancellation stays plain FMA arithmetic in the
// entry's type (no fast math), as the JAX kernel pins HIGHEST precision.
//
// Each entry returns cudaGetLastError() as an int; the caller raises on
// nonzero. Entries launch on the given stream and do not synchronise.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;  // bwd_finish's blocks
constexpr int kRing = 4;       // a lane's weight groups in flight
constexpr int kRingBytes = 65536;  // the ring, kRing groups of 4 values a thread (FWD_RING_BYTES)
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may take (FWD_SMEM_MAX)
constexpr int kMaxD = 16;

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kTP = 32;  // particles a block, a warp each
  static constexpr float kTrigFast = 105615.0f;
};
template <>
struct Cfg<double> {
  static constexpr int kTP = 16;
  static constexpr double kTrigFast = 1048576.0;
};
static_assert(kRing * 4 * sizeof(float) * Cfg<float>::kTP * 32 == kRingBytes, "float ring");
static_assert(kRing * 4 * sizeof(double) * Cfg<double>::kTP * 32 == kRingBytes, "double ring");

// the entry's type's fma, exp, max, min, |.|, sin and cos
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sin(x) and cos(x) from one range reduction, for |x| <= Cfg<T>::kTrigFast.
// float: x - 2 pi k in [-pi, pi] (Cody-Waite, FMA), then the SFU's sin and
// cos (absolute error about 2^-21 on [-pi, pi]).
__device__ __forceinline__ float reduce_2pi(float x) {
  const float k = rintf(x * 0.159154943f);
  const float r = fmaf(k, -6.28318548f, x);  // 2 pi in float32, then the rest
  return fmaf(k, 1.74845553e-7f, r);
}
__device__ __forceinline__ void sin_cos_fast(float x, float* s, float* c) {
  const float r = reduce_2pi(x);
  *s = __sinf(r);
  *c = __cosf(r);
}
// double: x = k pi/2 + r (two-part Cody-Waite, FMA; |r| <= pi/4 up to
// rounding), Taylor polynomials of sin r and cos r to r^17 (truncation
// below 1e-17 there), then the quadrant k mod 4 picks and signs them.
__device__ __forceinline__ void sin_cos_fast(double x, double* s, double* c) {
  const double k = rint(x * 0.63661977236758134);
  const int q = (int)k;
  double r = fma(k, -1.5707963267948966, x);
  r = fma(k, -6.123233995736766e-17, r);
  const double r2 = r * r;
  double ps = 2.8114572543455206e-15, pc = 4.779477332387385e-14;  // 1/17!, 1/16!
  ps = fma(ps, r2, -7.647163731819816e-13);
  pc = fma(pc, r2, -1.1470745597729725e-11);
  ps = fma(ps, r2, 1.6059043836821613e-10);
  pc = fma(pc, r2, 2.08767569878681e-09);
  ps = fma(ps, r2, -2.505210838544172e-08);
  pc = fma(pc, r2, -2.755731922398589e-07);
  ps = fma(ps, r2, 2.7557319223985893e-06);
  pc = fma(pc, r2, 2.48015873015873e-05);
  ps = fma(ps, r2, -0.0001984126984126984);
  pc = fma(pc, r2, -0.001388888888888889);
  ps = fma(ps, r2, 0.008333333333333333);
  pc = fma(pc, r2, 0.041666666666666664);
  ps = fma(ps, r2, -0.16666666666666666);
  pc = fma(pc, r2, -0.5);
  ps = fma(ps, r2, 1.0);
  pc = fma(pc, r2, 1.0);
  const double sr = r * ps;
  const double sv = (q & 1) ? pc : sr, cv = (q & 1) ? sr : pc;
  *s = (q & 2) ? -sv : sv;
  *c = ((q + 1) & 2) ? -cv : cv;
}
template <typename T>
__device__ __forceinline__ T sin_fast(T x) {
  T s, c;
  sin_cos_fast(x, &s, &c);
  return s;
}
template <typename T>
__device__ __forceinline__ T cos_fast(T x) {
  T s, c;
  sin_cos_fast(x, &s, &c);
  return c;
}

// four values from 16-byte aligned shared memory; four to global memory,
// 16 bytes a store where ``vec``, else the first ``left`` one by one
__device__ __forceinline__ void lds4(float (&r)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
}
__device__ __forceinline__ void lds4(double (&r)[4], const double* p) {
  const double2 u = reinterpret_cast<const double2*>(p)[0], v = reinterpret_cast<const double2*>(p)[1];
  r[0] = u.x, r[1] = u.y, r[2] = v.x, r[3] = v.y;
}
__device__ __forceinline__ void st4(float* p, const float (&r)[4], bool vec, int left) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < left) p[q] = r[q];
  }
}
__device__ __forceinline__ void st4(double* p, const double (&r)[4], bool vec, int left) {
  if (vec) {
    reinterpret_cast<double2*>(p)[0] = make_double2(r[0], r[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(r[2], r[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < left) p[q] = r[q];
  }
}

// cp.async from global into shared memory: 16 bytes (both 16-byte
// aligned, bypassing L1), or one value zero-filled where !valid (src is
// then not read). The #else branches are what a host compiler sees.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
#else
  memcpy(dst, src, 16);
#endif
}
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"((int)sizeof(T)),
               "r"(valid ? (int)sizeof(T) : 0)
               : "memory");
#else
  *dst = valid ? *src : T(0);
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

template <typename T>
struct Args {
  const T *x, *w, *v, *omega, *phase, *z, *z2, *il;
  const T* g;          // the backward's cotangent (S, L)
  T* out;              // f (S, L); the backward's dx (S, D) at L = 1, else its partials (L, S, D)
  T *dw, *dv;          // the full backward's dw (S, L, B) and dv (S, L, M)
  int S, L, B, M, D;
  int bw, mw, cw;      // B and M rounded up to 4; the panels' chunk width
  bool vec_w, vec_v;   // w's and v's rows are 16-byte aligned (and dw's and dv's, with vec_dw)
  bool vec_dw, vec_dv;
};

// Issue the cp.async copies of columns [c0, c0 + cw) of latent l's panels
// (rows 0..D of a.cw values), reading each table in its own order, as one
// commit group; zero the pads.
template <typename T>
__device__ __forceinline__ void stage_panels(T* pan, const Args<T>& a, int l, int c0) {
  const int tid = threadIdx.x, nth = blockDim.x, D = a.D, cw = a.cw;
  // i / D as umulhi(i, ceil(2^32 / D)) for D > 1: exact for i < 2^16 (a
  // chunk holds fewer than 2^16 / D columns: fwd_plan)
  const unsigned inv_d = (unsigned)((0x100000000ull + D - 1) / D);
  const auto div_d = [&](int i) { return D == 1 ? i : (int)__umulhi(i, inv_d); };
  const int b0 = c0, b1 = min(c0 + cw, a.B);
  if (b0 < b1) {
    const T* src = a.omega + ((size_t)l * a.B + b0) * D;
    for (int i = tid; i < (b1 - b0) * D; i += nth) {
      const int c = div_d(i);
      cp_async_elem(pan + (i - c * D) * cw + c, src + i, true);
    }
    for (int c = b0 + tid; c < b1; c += nth) cp_async_elem(pan + D * cw + c - c0, a.phase + (size_t)l * a.B + c, true);
  }
  const int m0 = max(c0 - a.bw, 0), m1 = min(c0 + cw - a.bw, a.M);
  if (m0 < m1) {
    const int j0 = a.bw + m0 - c0;
    const T* src = a.z + ((size_t)l * a.M + m0) * D;
    for (int i = tid; i < (m1 - m0) * D; i += nth) {
      const int c = div_d(i);
      cp_async_elem(pan + (i - c * D) * cw + j0 + c, src + i, true);
    }
    for (int c = m0 + tid; c < m1; c += nth) cp_async_elem(pan + D * cw + j0 + c - m0, a.z2 + (size_t)l * a.M + c, true);
  }
  cp_async_commit();
  // the pads: bases columns [B, bw), centers columns bw + [M, mw)
  for (int i = tid; i < (D + 1) * 8; i += nth) {
    const int r = i / 8, c = i % 8;
    const int col = c < 4 ? a.B + c : a.bw + a.M + c - 4;
    if (col < (c < 4 ? a.bw : a.bw + a.mw) && col >= c0 && col < c0 + cw) pan[r * cw + col - c0] = T(0);
  }
}

// A lane's weights: its groups (columns 4 g, g = lane + 32 item, of the
// concatenated [w | v] row of its warp's particle), each copied kRing items
// ahead by cp.async into the lane's own slots of the ring (one commit group
// an item, empty past the row), then read from there.
template <typename T>
struct WStream {
  static constexpr int kVec = 16 / sizeof(T);  // values a 16-byte copy carries
  const T *w, *v;  // the particle's rows of w and v
  T* slot;         // the lane's slot of item 0; the next are 4 blockDim.x values on

  __device__ WStream(const Args<T>& a, T* ring, int s, int l)
      : w(a.w + ((size_t)s * a.L + l) * a.B), v(a.v + ((size_t)s * a.L + l) * a.M),
        slot(ring + 4 * threadIdx.x) {}
  __device__ T* at(int item) const { return slot + (item & (kRing - 1)) * 4 * blockDim.x; }
  __device__ void issue(const Args<T>& a, int item) {
    const int c = 4 * ((threadIdx.x & 31) + 32 * item);
    if (c < a.bw + a.mw) {
      const bool base = c < a.bw;
      const T* src = base ? w + c : v + (c - a.bw);
      const int left = base ? a.B - c : a.M - (c - a.bw);  // the row's columns from src on
      if (base ? a.vec_w : a.vec_v) {
#pragma unroll
        for (int h = 0; h < 4; h += kVec) cp_async16(at(item) + h, src + h);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) cp_async_elem(at(item) + q, src + min(q, left - 1), q < left);
      }
    }
    cp_async_commit();
  }
  // item's weights, once its copy has landed; then the copy kRing ahead
  __device__ void take(const Args<T>& a, T (&wv)[4], int item) {
    cp_async_wait<kRing - 1>();
    lds4(wv, at(item));
    issue(a, item + kRing);
  }
};

// Blocks (ceil(S / kTP), L) of kTP warps; warp u takes particle kTP
// blockIdx.x + u. Dynamic shared memory: the ring (kRingBytes), then the
// panels ((D + 1) x cw values). x is scaled by il_l in place at the lane's
// first centers group.
template <typename T, int DM>
__global__ void __launch_bounds__(Cfg<T>::kTP * 32, 1) fwd_warp(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  T* ring = reinterpret_cast<T*>(fwd_smem);
  T* pan = ring + (size_t)kRing * 4 * blockDim.x;
  const int l = blockIdx.y, lane = threadIdx.x & 31, D = a.D;
  const int s = blockIdx.x * Cfg<T>::kTP + (threadIdx.x >> 5);
  const int cols = a.bw + a.mw;
  const int items = s < a.S ? (cols / 4 - lane + 31) / 32 : 0;  // this lane's groups
  WStream<T> ws(a, ring, s, l);
  for (int k = 0; k < kRing && s < a.S; ++k) ws.issue(a, k);

  // x (zero past D) and |x il_l|^2
  T x[DM], x2 = T(0), acc = T(0);
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    x[d] = (d < D && s < a.S) ? a.x[(size_t)s * D + d] : T(0);
    const T xs = d < D ? x[d] * a.il[(size_t)l * D + d] : T(0);
    x2 = fma_(xs, xs, x2);
  }

  int k = 0;
  bool scaled = false;
  for (int c0 = 0; c0 < cols; c0 += a.cw) {
    if (c0) __syncthreads();  // the previous chunk is consumed
    stage_panels(pan, a, l, c0);
    cp_async_wait<0>();
    __syncthreads();
    const int kend = min(k + a.cw / 128, items);
    for (; k < kend; ++k) {
      T wv[4];
      ws.take(a, wv, k);
      const int c = 4 * (lane + 32 * k), j = c - c0;
      if (c >= a.bw && !scaled) {  // from here on x~ = x il_l
        scaled = true;
#pragma unroll
        for (int d = 0; d < DM; ++d) x[d] *= d < D ? a.il[(size_t)l * D + d] : T(0);
      }
      T sc[4], dt[4] = {T(0), T(0), T(0), T(0)};
      lds4(sc, pan + D * a.cw + j);
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        if (d < D) {
          T o[4];
          lds4(o, pan + d * a.cw + j);
#pragma unroll
          for (int q = 0; q < 4; ++q) dt[q] = fma_(x[d], o[q], dt[q]);
        }
      }
      if (c < a.bw) {  // bases: sum_q cos(x . omega + phase) w
        T big = T(0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dt[q] += sc[q];
          big = max_(big, abs_(dt[q]));
        }
        if (big <= Cfg<T>::kTrigFast) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc = fma_(cos_fast(dt[q]), wv[q], acc);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc = fma_(cos_(dt[q]), wv[q], acc);
        }
      } else {  // centers: sum_q exp(-|x~ - z~|^2 / 2) v
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const T d2 = max_(x2 + sc[q] - T(2) * dt[q], T(0));
          acc = fma_(exp_(T(-0.5) * d2), wv[q], acc);
        }
      }
    }
  }
  const T total = warp_sum(acc);
  if (lane == 0 && s < a.S) a.out[(size_t)s * a.L + l] = total;
}

// The backward on the forward's grid and staging: warp u takes particle
// kTP blockIdx.x + u of latent blockIdx.y; dynamic shared memory as
// fwd_warp's. Once staged, the centers' coordinate rows are scaled by il_l
// in place, so that x . (z~ il) = x~ . z~ and kv (z~ il) is the centers'
// term of dx before the x~ part: x stays unscaled and one sum acc takes
// -sin(proj) w omega over the bases and kv z~ il over the centers, kvsum
// the centers' kv. At DM <= 6 the first kHeld = 4 panel rows of a group
// stay in registers from the dots to the update and the others are read
// again; wider, all are read again (more held rows spill at 64 registers a
// float32 thread). A group past kTrigFast reads them all again, so that the
// full-range sin finds its registers free. FULL (K1c) also writes the
// group's dw = cos(proj) g or dv = exp(-d2 / 2) g; dx's arithmetic does not
// depend on FULL, nor on which rows are held. A (the arguments' type) and
// the held rows are what kept the float32 instances from spilling (ptxas
// on the card): float32 K1b takes the arguments by value and holds four
// rows at D <= 6 (by reference it spills 8 bytes there); float32 K1c,
// whose dw or dv group takes four more registers, takes them by reference
// and holds none (holding four it spills 16 bytes at D <= 6, by value 4 at
// D <= 8). float64 takes them by reference and holds four rows at D <= 6:
// that spills 36 bytes (K1b) and 96 (K1c) there, and still ran 0.0459 and
// 0.0552 ms alone where holding none ran 0.0558 and 0.0625 without a spill
// (H100 SXM at 700 W; S = B = 1024, L = 4, M = 240, D = 6).
template <typename T, int DM, bool FULL, typename A>
__device__ __forceinline__ void bwd_lanes(A a) {
  constexpr int kHeld = DM <= 6 && !(FULL && sizeof(T) == 4) ? 4 : 0;  // rows kept in registers from the dots
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* ring = reinterpret_cast<T*>(bwd_smem);
  T* pan = ring + (size_t)kRing * 4 * blockDim.x;
  const int l = blockIdx.y, lane = threadIdx.x & 31, D = a.D;
  const int s = blockIdx.x * Cfg<T>::kTP + (threadIdx.x >> 5);
  const int cols = a.bw + a.mw;
  const int items = s < a.S ? (cols / 4 - lane + 31) / 32 : 0;  // this lane's groups
  WStream<T> ws(a, ring, s, l);
  for (int k = 0; k < kRing && s < a.S; ++k) ws.issue(a, k);
  // K1c: g[s,l] in every lane, and the particle's rows of dw and dv
  const T gfull = FULL && s < a.S ? a.g[(size_t)s * a.L + l] : T(0);
  T* const dw = FULL ? a.dw + ((size_t)s * a.L + l) * a.B : nullptr;
  T* const dv = FULL ? a.dv + ((size_t)s * a.L + l) * a.M : nullptr;

  T x[DM], x2 = T(0), acc[DM], kvsum = T(0);
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    x[d] = (d < D && s < a.S) ? a.x[(size_t)s * D + d] : T(0);
    const T xs = d < D ? x[d] * a.il[(size_t)l * D + d] : T(0);
    x2 = fma_(xs, xs, x2);
    acc[d] = T(0);
  }

  int k = 0;
  for (int c0 = 0; c0 < cols; c0 += a.cw) {
    if (c0) __syncthreads();  // the previous chunk is consumed
    stage_panels(pan, a, l, c0);
    cp_async_wait<0>();
    __syncthreads();
    const int j0 = max(a.bw - c0, 0), j1 = min(a.bw + a.mw - c0, a.cw);  // the chunk's centers
    if (j0 < j1) {
      for (int i = threadIdx.x; i < D * (j1 - j0); i += blockDim.x) {
        const int d = i / (j1 - j0);
        pan[d * a.cw + j0 + i - d * (j1 - j0)] *= a.il[(size_t)l * D + d];
      }
      __syncthreads();
    }
    const int kend = min(k + a.cw / 128, items);
    for (; k < kend; ++k) {
      T wv[4];
      ws.take(a, wv, k);
      const int c = 4 * (lane + 32 * k), j = c - c0;
      const bool base = c < a.bw;
      // dt: the bases' x . omega + phase, the centers' x~ . z~ - (|x~|^2 +
      // |z~|^2) / 2 = -|x~ - z~|^2 / 2; o: the first kHeld rows; gv: K1c's
      // dw or dv of the group
      T dt[4], cq[4], o[kHeld ? kHeld : 1][4], gv[4];
      lds4(dt, pan + D * a.cw + j);
#pragma unroll
      for (int q = 0; q < 4; ++q) dt[q] = base ? dt[q] : T(-0.5) * (x2 + dt[q]);
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        if (d < D) {
          T row[4];
          lds4(row, pan + d * a.cw + j);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dt[q] = fma_(x[d], row[q], dt[q]);
            if (d < kHeld) o[d < kHeld ? d : 0][q] = row[q];
          }
        }
      }
      // acc += c_q times the group's rows, held or read again
      const auto add_rows = [&](bool held) {
#pragma unroll
        for (int d = 0; d < DM; ++d) {
          if (d < D) {
            T row[4];
            if (held && d < kHeld) {
#pragma unroll
              for (int q = 0; q < 4; ++q) row[q] = o[d < kHeld ? d : 0][q];
            } else {
              lds4(row, pan + d * a.cw + j);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[d] = fma_(cq[q], row[q], acc[d]);
          }
        }
      };
      if (base) {  // bases: c_q = -sin(x . omega + phase) w; K1c: dw = cos(.) g
        T big = T(0);
#pragma unroll
        for (int q = 0; q < 4; ++q) big = max_(big, abs_(dt[q]));
        if (big <= Cfg<T>::kTrigFast) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (FULL) {
              T sn, cs;
              sin_cos_fast(dt[q], &sn, &cs);
              cq[q] = -sn * wv[q];
              gv[q] = cs * gfull;
            } else {
              cq[q] = -sin_fast(dt[q]) * wv[q];
            }
          }
          add_rows(true);
        } else {  // rows read again, so that the full-range sin finds its registers free
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            cq[q] = -sin_(dt[q]) * wv[q];
            if (FULL) gv[q] = cos_(dt[q]) * gfull;
          }
          add_rows(false);
        }
        if (FULL) st4(dw + c, gv, a.vec_dw, a.B - c);
      } else {  // centers: kv_q = exp(-|x~ - z~|^2 / 2) v; K1c: dv = exp(.) g
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const T kq = exp_(min_(dt[q], T(0)));
          cq[q] = kq * wv[q];
          kvsum += cq[q];
          if (FULL) gv[q] = kq * gfull;
        }
        add_rows(true);
        if (FULL) st4(dv + (c - a.bw), gv, a.vec_dv, a.M - (c - a.bw));
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < D) acc[d] = warp_sum(acc[d]);
  kvsum = warp_sum(kvsum);
  if (lane == 0 && s < a.S) {  // g (acc - kvsum x~ il)
    const T gl = FULL ? gfull : a.g[(size_t)s * a.L + l];
    T* out = a.out + ((a.L == 1 ? 0 : (size_t)l * a.S) + s) * D;
#pragma unroll
    for (int d = 0; d < DM; ++d) {
      if (d < D) {
        const T il = a.il[(size_t)l * D + d];
        out[d] = gl * fma_(-kvsum * (x[d] * il), il, acc[d]);
      }
    }
  }
}

// K1b: dx only
template <typename T, int DM>
__global__ void __launch_bounds__(Cfg<T>::kTP * 32, 1) bwd_warp(const Args<T> a) {
  if constexpr (sizeof(T) == 4)
    bwd_lanes<T, DM, false, const Args<T>>(a);
  else
    bwd_lanes<T, DM, false, const Args<T>&>(a);
}

// K1c: dx, dw and dv
template <typename T, int DM>
__global__ void __launch_bounds__(Cfg<T>::kTP * 32, 1) bwd_full_warp(const Args<T> a) {
  bwd_lanes<T, DM, true, const Args<T>&>(a);
}

// dx[i] = sum_l part[l, i] over l = 0 .. L-1 in order, i over S x D
template <typename T>
__global__ void bwd_finish(const T* __restrict__ part, T* __restrict__ dx, int n, int L) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T t = part[i];
  for (int l = 1; l < L; ++l) t += part[(size_t)l * n + i];
  dx[i] = t;
}

inline bool bad_shape(int S, int L, int B, int M, int D, int cw) {
  return S <= 0 || L <= 0 || B <= 0 || M <= 0 || D <= 0 || D > kMaxD || cw <= 0 || cw % 128;
}

// a K1 kernel on (ceil(S / kTP), L) blocks
template <typename T>
int launch_warp(void (*kernel)(Args<T>), const Args<T>& a, cudaStream_t st) {
  constexpr int threads = Cfg<T>::kTP * 32;
  const size_t bytes = (size_t)kRingBytes + (size_t)(a.D + 1) * a.cw * sizeof(T);
  if (bytes > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) return err;
  kernel<<<dim3((a.S + Cfg<T>::kTP - 1) / Cfg<T>::kTP, a.L), threads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
Args<T> make_args(const T* x, const T* w, const T* v, const T* omega, const T* phase, const T* z, const T* z2,
                  const T* il, const T* g, T* out, T* dw, T* dv, int S, int L, int B, int M, int D, int cw) {
  const auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return Args<T>{x, w, v, omega, phase, z, z2, il, g, out, dw, dv, S, L, B, M, D, (B + 3) / 4 * 4,
                 (M + 3) / 4 * 4, cw, B % 4 == 0 && al16(w), M % 4 == 0 && al16(v),
                 B % 4 == 0 && al16(dw), M % 4 == 0 && al16(dv)};
}

template <typename T>
int fwd_entry(const T* x, const T* w, const T* v, const T* omega, const T* phase, const T* z, const T* z2,
              const T* il, T* out, int S, int L, int B, int M, int D, int cw, void* stream) {
  if (bad_shape(S, L, B, M, D, cw)) return (int)cudaErrorInvalidValue;
  const Args<T> a = make_args<T>(x, w, v, omega, phase, z, z2, il, nullptr, out, nullptr, nullptr,
                                 S, L, B, M, D, cw);
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 6) return launch_warp(fwd_warp<T, 6>, a, st);
  if (D <= 8) return launch_warp(fwd_warp<T, 8>, a, st);
  return launch_warp(fwd_warp<T, 16>, a, st);
}

// dx-only (dw == dv == nullptr) or full backward; part: the (L, S, D)
// scratch of the per-latent partials (unused at L = 1)
template <typename T>
int bwd_entry(const T* x, const T* w, const T* v, const T* omega, const T* phase, const T* z, const T* z2,
              const T* il, const T* g, T* dx, T* dw, T* dv, T* part, int S, int L, int B, int M, int D, int cw,
              void* stream) {
  if (bad_shape(S, L, B, M, D, cw)) return (int)cudaErrorInvalidValue;
  const Args<T> a = make_args<T>(x, w, v, omega, phase, z, z2, il, g, L == 1 ? dx : part, dw, dv,
                                 S, L, B, M, D, cw);
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (dw == nullptr) {
    err = D <= 6 ? launch_warp(bwd_warp<T, 6>, a, st)
          : D <= 8 ? launch_warp(bwd_warp<T, 8>, a, st)
                   : launch_warp(bwd_warp<T, 16>, a, st);
  } else {
    err = D <= 6 ? launch_warp(bwd_full_warp<T, 6>, a, st)
          : D <= 8 ? launch_warp(bwd_full_warp<T, 8>, a, st)
                   : launch_warp(bwd_full_warp<T, 16>, a, st);
  }
  if (err || L == 1) return err;
  const int n = S * D;
  bwd_finish<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(part, dx, n, L);
  return (int)cudaGetLastError();
}

}  // namespace

// cw: the panels' chunk width, a multiple of 128 (ops/path_eval_cuda.py:fwd_plan)
extern "C" int path_eval_fwd_f32(const float* x, const float* w, const float* v, const float* omega,
                                 const float* phase, const float* z, const float* z2, const float* il,
                                 float* out, int S, int L, int B, int M, int D, int cw, void* stream) {
  return fwd_entry(x, w, v, omega, phase, z, z2, il, out, S, L, B, M, D, cw, stream);
}
extern "C" int path_eval_fwd_f64(const double* x, const double* w, const double* v, const double* omega,
                                 const double* phase, const double* z, const double* z2, const double* il,
                                 double* out, int S, int L, int B, int M, int D, int cw, void* stream) {
  return fwd_entry(x, w, v, omega, phase, z, z2, il, out, S, L, B, M, D, cw, stream);
}

// part: the (L, S, D) scratch of the per-latent partials (unused at L = 1);
// cw as the forward's
extern "C" int path_eval_bwd_dx_f32(const float* x, const float* w, const float* v, const float* omega,
                                    const float* phase, const float* z, const float* z2, const float* il,
                                    const float* g, float* dx, float* part, int S, int L, int B, int M, int D,
                                    int cw, void* stream) {
  return bwd_entry<float>(x, w, v, omega, phase, z, z2, il, g, dx, nullptr, nullptr, part, S, L, B, M, D, cw,
                          stream);
}
extern "C" int path_eval_bwd_dx_f64(const double* x, const double* w, const double* v, const double* omega,
                                    const double* phase, const double* z, const double* z2, const double* il,
                                    const double* g, double* dx, double* part, int S, int L, int B, int M,
                                    int D, int cw, void* stream) {
  return bwd_entry<double>(x, w, v, omega, phase, z, z2, il, g, dx, nullptr, nullptr, part, S, L, B, M, D, cw,
                           stream);
}

// dw (S, L, B) and dv (S, L, M) beside dx; part and cw as the dx-only backward's
extern "C" int path_eval_bwd_full_f32(const float* x, const float* w, const float* v, const float* omega,
                                      const float* phase, const float* z, const float* z2, const float* il,
                                      const float* g, float* dx, float* dw, float* dv, float* part,
                                      int S, int L, int B, int M, int D, int cw, void* stream) {
  if (dw == nullptr || dv == nullptr) return (int)cudaErrorInvalidValue;
  return bwd_entry<float>(x, w, v, omega, phase, z, z2, il, g, dx, dw, dv, part, S, L, B, M, D, cw, stream);
}
extern "C" int path_eval_bwd_full_f64(const double* x, const double* w, const double* v, const double* omega,
                                      const double* phase, const double* z, const double* z2, const double* il,
                                      const double* g, double* dx, double* dw, double* dv, double* part,
                                      int S, int L, int B, int M, int D, int cw, void* stream) {
  if (dw == nullptr || dv == nullptr) return (int)cudaErrorInvalidValue;
  return bwd_entry<double>(x, w, v, omega, phase, z, z2, il, g, dx, dw, dv, part, S, L, B, M, D, cw, stream);
}
