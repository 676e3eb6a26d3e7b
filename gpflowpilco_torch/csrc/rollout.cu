// The whole pathwise policy-rollout loss for Hopper (sm_90a), float32 and
// float64.
//
// Replaces the TPU kernels of gpflowpilco_tpu/ops/rollout_pallas.py:
//   rollout_fwd_{f32,f64} <- _fwd_kernel (:195), launched by _fwd_impl (:420)
//   rollout_bwd_{f32,f64} <- _bwd_kernel (:221), launched by _vjp_bwd (:499)
//
// Forward: for each particle, all T steps of
//   e = encode(x); g_l = sum_m exp(-1/2 |e il_l - zp_lm|^2) alpha_lm;
//   u = s (Phi(g Wp' + mc_p) - 1/2); xu = [e, u];
//   f_l = sum_b cos(xu . omega_lb + phase_lb) w_slb
//       + sum_m exp(-1/2 |xu ild_l - zd_lm|^2) v_slm;
//   x += dt (f Wd' + mc_d); loss += -exp(-1/2 err' P err), err = encode(x) - target,
// writing the loss (S,) and the trajectory (T+1, S, D).
// Backward: from the stored trajectory, the adjoint of the state through
// the cost, the drift, the squash and the policy, returned as partial dzp
// (Lp, Mp, De) and dalpha (Lp, Mp) per slot of rows and dilp (Lp, De) per
// particle, summed outside the kernels (no atomics). The cost's gradient
// uses sym(P) err, exact for any P.
//
// The drift operands carry a member axis K in front (1 for an SVGP drift);
// particle s rides member s / per. A forward block takes kFwdParticles
// particles of one member; a bwd_jac block takes rows of one member.
//
// Bound on an H100 (SXM): per particle and step the forward does
// Ld (B + M) projections of Dxu terms with a cos or an exp each, about 85k
// operations at the cartpole's widths (S=1024, B=1024, M=240, Ld=4,
// Dxu=6; chip_smoke.py's rollout_bound_ms), 2.6 GFLOP over 30 steps:
// 0.039 ms in float32, 0.077 ms in float64, above the ~21 MB of unique
// bytes (w, v, the trajectory; 0.006 ms). The backward needs about 147k
// per particle and step (a sin and two Dxu-term passes per basis and
// center, no cos or weight), about 1.7x the forward.
// Forward design: the steps are sequential (x_{t+1} depends on x_t through
// cos, exp and Phi), so a particle's 30 steps run one after another in its
// own warps (two at Dxu <= 8), and a block holds kFwdParticles particles of
// one member: 128 blocks of 16 warps at the slice's S=1024, one an SM. A
// first launch (fwd_panels) writes each member's drift tables (omega,
// phase, zd, zd2) transposed into panels, so that lanes on neighbouring
// columns hit distinct banks. The forward stages them into shared memory by
// 16-byte cp.async, once for all T steps where they fit (the resident
// route: 142 KB at the slice's float32 widths), else every step in
// double-buffered chunks of ring_cols columns with one block barrier a
// chunk (the ring route: float64 at the slice's widths); the wrapper picks
// the route by size. A particle's lane j takes the column groups j, j + 64,
// ... of every table (a group is 16 bytes of columns: one shared-memory
// load per table row), in order, its w and v groups arriving by cp.async
// kStream groups ahead (WStream); the partials meet by __shfl_xor_sync
// butterflies and then the two warps' totals through shared memory (one
// 64-thread named barrier a step), so every lane holds every total and runs
// the small serial parts (encoder, policy, squash, Euler) itself: no block
// barrier inside the step loop on the resident route. The cost, which the
// dynamics do not read, runs once after the loop, a step a lane. The bases'
// cos is branch-free (cos_fast) wherever a bound on the latent's arguments
// allows it, which lets a group's columns interleave. Both routes give each
// lane the same columns in the same order, so their results are
// bit-identical, and a particle's result does not depend on its block.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md, scripts/k3_bench.py): at
// the slice's shape 0.38 ms in float32, 1.26 ms in float64, about 10x and
// 16x the bound: per-latent work runs at about half the issue rate, and the
// per-step serial parts, run by every warp in step, take about a fifth.
// Backward design: every heavy term of a step is linear in the carried
// adjoint, with coefficients that depend on the trajectory alone, so all
// T x S steps' Jacobians are formed at once (bwd_jac: a thread per (row,
// drift latent), the bases and centers staged by cp.async), then each
// step's small linear maps (bwd_maps), then only the D x D recurrence runs
// in sequence (bwd_adjoint), then the policy gradients over all rows
// (bwd_grads). See the backward section below.
// The |x|^2+|z|^2-2x.z expansions are plain FMA loops in the working type
// (no fast math), as the JAX kernel pins HIGHEST precision. The normal CDF
// is normcdf, exact, where the TPU kernel approximated it.
//
// Each entry returns cudaGetLastError() as an int; the caller raises on
// nonzero. Entries launch on the given stream and do not synchronise.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kFwdParticles = 8;  // particles per forward block
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use (227 KB; FWD_SMEM_MAX)
constexpr int kXchBytes = 3072;   // the forward's exchange area at the front of its shared memory
constexpr int kStream = 4;        // weight groups a forward lane keeps in flight (WStream)
// register / shared capacities; the wrapper (ops/rollout_cuda.py) checks them
constexpr int kMaxD = 8, kMaxU = 4, kMaxLp = 4, kMaxLd = 8;

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float sn(float x) { return sinf(x); }
__device__ __forceinline__ double sn(double x) { return sin(x); }
__device__ __forceinline__ float cs(float x) { return cosf(x); }
__device__ __forceinline__ double cs(double x) { return cos(x); }
__device__ __forceinline__ float ncdf(float x) { return normcdff(x); }
__device__ __forceinline__ double ncdf(double x) { return normcdf(x); }
__device__ __forceinline__ float mx(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double mx(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fm(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fm(double a, double b, double c) { return fma(a, b, c); }

struct Dims {
  int S, K, per, T, D, De, U, Lp, Mp, Ld, B, M, Dxu, code, na, tiles;
  double dt, squash;
};

template <typename T>
struct Ops {
  const T *x0, *zp, *zp2, *alpha, *ilp, *wp, *mcp, *omega, *phase, *ild, *zd, *zd2, *w, *v, *wd,
      *mcd, *target, *precis;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int DM>
__device__ __forceinline__ void load_row(T (&r)[DM], const T* p, int n) {
#pragma unroll
  for (int d = 0; d < DM; ++d) r[d] = d < n ? p[d] : T(0);
}

template <typename T, int DM>
__device__ __forceinline__ T dot(const T (&a)[DM], const T (&b)[DM]) {
  T s = T(0);
#pragma unroll
  for (int d = 0; d < DM; ++d) s = fm(a[d], b[d], s);
  return s;
}

__device__ __forceinline__ int active_dim(const Dims& n, int j) { return (n.code >> (4 * j)) & 15; }

__device__ __forceinline__ bool is_active(const Dims& n, int dim) {
  for (int j = 0; j < n.na; ++j)
    if (active_dim(n, j) == dim) return true;
  return false;
}

// e = [sin x_a, cos x_a, x_inactive (ascending)], zero beyond De up to DM
template <typename T, int DM>
__device__ void encode(const Dims& n, const T* x, T (&e)[DM]) {
#pragma unroll
  for (int i = 0; i < DM; ++i) e[i] = T(0);
  for (int j = 0; j < n.na; ++j) {
    const T xa = x[active_dim(n, j)];
    e[j] = sn(xa);
    e[n.na + j] = cs(xa);
  }
  int i = 2 * n.na;
  for (int dim = 0; dim < n.D; ++dim)
    if (!is_active(n, dim)) e[i++] = x[dim];
}

// gx += (d encode / dx)^T ge
template <typename T>
__device__ void encode_bwd(const Dims& n, const T* x, const T* ge, T* gx) {
  for (int j = 0; j < n.na; ++j) {
    const int dim = active_dim(n, j);
    gx[dim] += ge[j] * cs(x[dim]) - ge[n.na + j] * sn(x[dim]);
  }
  int i = 2 * n.na;
  for (int dim = 0; dim < n.D; ++dim)
    if (!is_active(n, dim)) gx[dim] += ge[i++];
}

// -err' P err / 2 and, when ge is given, ge = -c sym(P) err scaled by gscale
template <typename T, int DXU>
__device__ T cost(const Dims& n, const Ops<T>& o, const T* x, T* ge, T gscale) {
  T e[DXU];
  encode<T, DXU>(n, x, e);
  T err[DXU];
  for (int i = 0; i < DXU; ++i) err[i] = i < n.De ? e[i] - o.target[i] : T(0);
  T q = T(0);
  for (int i = 0; i < n.De; ++i) {
    T pe = T(0);
    for (int j = 0; j < n.De; ++j) pe = fm(o.precis[i * n.De + j], err[j], pe);
    q = fm(err[i], pe, q);
  }
  const T c = -ex(T(-0.5) * q);
  if (ge != nullptr) {
    for (int i = 0; i < n.De; ++i) {
      T ps = T(0);
      for (int j = 0; j < n.De; ++j)
        ps = fm(T(0.5) * (o.precis[i * n.De + j] + o.precis[j * n.De + i]), err[j], ps);
      ge[i] = gscale * -c * ps;
    }
  }
  return c;
}

// graw_u = mc_p + Wp g
template <typename T>
__device__ __forceinline__ T graw_of(const Dims& n, const Ops<T>& o, const T (&g)[kMaxLp], int u) {
  T a = o.mcp[u];
#pragma unroll
  for (int l = 0; l < kMaxLp; ++l)
    if (l < n.Lp) a = fm(o.wp[u * n.Lp + l], g[l], a);
  return a;
}

// cp.async of one element into shared memory; zero-filled when !valid
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
               "n"((int)sizeof(T)), "r"(valid ? (int)sizeof(T) : 0)
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


// ----------------------------------------------------------------- forward
// A block: kFwdParticles particles of one member, fwd_wpp warps each. A
// particle's lane j (of its 32 fwd_wpp lanes) takes the column groups g = j,
// j + 32 fwd_wpp, ... of each drift latent's bases and then its centers,
// into one partial; a group is group_of<T>() adjacent columns, 16 bytes: one
// shared-memory load per table row, and one of the particle's w or v
// (WStream). The partials meet by butterfly in each warp, then warp by warp
// in order through the exchange area (one named barrier a step for the
// particle's warps). Every warp evaluates the policy itself (lane j takes
// centers j, j + 32, ...). The member's tables sit in shared memory as
// panels: row i < DXU holds coordinate i of every column (zero for i >=
// Dxu), row DXU the per-column scalar (phase or |z|^2).

template <typename T>
__host__ __device__ constexpr int group_of() { return 16 / (int)sizeof(T); }
// columns of a ring chunk, a multiple of 32 groups (so a lane's groups and
// their order are the resident route's); two chunks fit in shared memory
template <typename T, int DXU>
__host__ __device__ constexpr int ring_cols() { return sizeof(T) == 8 && DXU > 8 ? 512 : 1024; }
__host__ __device__ constexpr int round_up(int a, int g) { return (a + g - 1) / g * g; }

// warps per particle: two at Dxu <= 8 (16 warps an SM), one at DXU = 16,
// whose 64 table values a group need the registers of a 256-thread block
template <int DXU>
__host__ __device__ constexpr int fwd_wpp() { return DXU <= 8 ? 2 : 1; }

// the forward's shared memory: the exchange area, the weight streams'
// rings (kStream 16-byte slots a thread), then the tables
template <int DXU>
__host__ __device__ constexpr size_t fwd_front_bytes() {
  return kXchBytes + (size_t)kStream * 32 * kFwdParticles * fwd_wpp<DXU>() * 16;
}

template <typename T, int DXU>
size_t fwd_smem_bytes(const Dims& n, bool ring) {
  constexpr int G = group_of<T>();
  if (ring) return fwd_front_bytes<DXU>() + 2 * (size_t)(DXU + 1) * ring_cols<T, DXU>() * sizeof(T);
  return fwd_front_bytes<DXU>() + (size_t)n.Ld * (DXU + 1) * (round_up(n.B, G) + round_up(n.M, G)) * sizeof(T);
}

// cos(x) for |x| <= kCosFast without a branch. float32: x = 2 pi k + r
// (Cody-Waite, FMA), r in [-pi, pi], then the SFU's cos (__cosf: absolute
// error 2^-21.41 there, against cosf's ~7e-8; PERF.md measures both and
// the Cephes-polynomial version, scripts/k6_fwd_cos_poly.patch, and the
// float32 bars hold). float64: x = k pi/2 + r, then cos r or sin r on
// [-pi/4, pi/4] by quadrant, Taylor to r^17 (1e-16). A latent whose bound
// on the bases' arguments leaves the range takes cos() for the step
// (fwd_warp).
constexpr float kCosFastF = 105615.0f;
constexpr double kCosFastD = 1048576.0;
__device__ __forceinline__ float cos_fast(float x) {
  const float k = rintf(x * 0.159154943f);
  float r = fmaf(k, -6.28318548f, x);  // 2 pi in float32, then the rest
  r = fmaf(k, 1.74845553e-7f, r);
  return __cosf(r);
}
__device__ __forceinline__ double cos_fast(double x) {
  const double k = rint(x * 0.63661977236758134);
  const long long q = (long long)k;
  double r = fma(k, -1.5707963267948966, x);
  r = fma(k, -6.123233995736766e-17, r);
  const double r2 = r * r;
  const bool odd = q & 1;
  // 1/(2i+1)! (sin) or 1/(2i)! (cos), alternating in sign
  double p = odd ? 2.8114572543455206e-15 : 4.779477332387385e-14;
  p = fma(p, r2, odd ? -7.647163731819816e-13 : -1.1470745597729725e-11);
  p = fma(p, r2, odd ? 1.6059043836821613e-10 : 2.08767569878681e-09);
  p = fma(p, r2, odd ? -2.505210838544172e-08 : -2.755731922398589e-07);
  p = fma(p, r2, odd ? 2.7557319223985893e-06 : 2.48015873015873e-05);
  p = fma(p, r2, odd ? -0.0001984126984126984 : -0.001388888888888889);
  p = fma(p, r2, odd ? 0.008333333333333333 : 0.041666666666666664);
  p = fma(p, r2, odd ? -0.16666666666666666 : -0.5);
  p = fma(p, r2, 1.0);
  const double v = odd ? r * p : p;
  return (q + 1) & 2 ? -v : v;
}
template <typename T>
__device__ __forceinline__ T cos_fast_range() { return sizeof(T) == 4 ? T(kCosFastF) : T(kCosFastD); }

// bar.sync on `threads` threads (a particle's warps) at barrier `id`
__device__ __forceinline__ void named_sync(int id, int threads) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
#endif
}

__device__ __forceinline__ void lds_group(float (&r)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
}
__device__ __forceinline__ void lds_group(double (&r)[2], const double* p) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  r[0] = v.x, r[1] = v.y;
}
// columns [c, c + G) of a particle's weight row of cnt columns, zero past
// cnt (predicated single loads, no branch)
template <typename T, int G>
__device__ __forceinline__ void ldg_group(T (&r)[G], const T* row, int c, int cnt) {
#pragma unroll
  for (int q = 0; q < G; ++q) r[q] = c + q < cnt ? __ldg(row + c + q) : T(0);
}

// 16 bytes from global into shared memory, bypassing L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

extern __shared__ __align__(16) unsigned char fwd_smem[];  // the forward's dynamic shared memory

// A lane's weights in the order its panel loops take them (per latent its
// bases' groups, then its centers'; step after step), each group copied
// kStream groups ahead by cp.async into the lane's own slot of a ring in
// shared memory (after the exchange area; slot k of thread t at (k kThreads
// + t) G: a warp's slots are adjacent). One commit group an item, so take()
// waits for its item with cp.async.wait_group alone; the slot it read takes
// the group kStream ahead. Used where w and v rows hold whole aligned
// groups.
template <typename T, int kLanes, int kThreads>
struct WStream {
  const T *w, *v;  // the particle's rows: Ld x B and Ld x M
  int nbl, per, l, r, taken;  // the lane's groups a latent (bases, all; 0 without a stream); the next item

  __device__ static T* slot(int k) {
    return reinterpret_cast<T*>(fwd_smem + kXchBytes) + (k * kThreads + threadIdx.x) * group_of<T>();
  }
  // item `item` (the next in order) into slot k, while the T steps have one
  __device__ void issue(const Dims& n, int k, int item) {
    constexpr int G = group_of<T>();
    if (item < n.T * n.Ld * per) {
      const int pl = threadIdx.x % kLanes;
      const T* src = r < nbl ? w + (size_t)l * n.B + (pl + kLanes * r) * G
                             : v + (size_t)l * n.M + (pl + kLanes * (r - nbl)) * G;
      cp_async16(slot(k), src);
      if (++r == per) r = 0, l = l + 1 == n.Ld ? 0 : l + 1;
    }
    cp_async_commit();
  }
  template <int G>
  __device__ int take(T (&out)[G]) {
    cp_async_wait<kStream - 1>();
    const int k = taken++ & (kStream - 1);
    lds_group(out, slot(k));
    return k;
  }
};

// The member tables in the forward's panel layout, in global memory: per
// (member, latent) the bases' panel (DXU + 1 rows of bw columns), then the
// centers' (DXU + 1 rows of mw); row i < DXU holds coordinate i of every
// column (zero for i >= Dxu), row DXU the per-column scalar (phase or
// |z|^2), columns past B or M zero. So the forward stages whole rows by
// 16-byte copies. After all panels, per (member, latent) the largest |.| of
// each bases row, for fwd_warp's bound on the cos arguments. A block per
// (member, latent, row).
constexpr int kPanelThreads = 256;
template <typename T, int DXU>
__global__ void __launch_bounds__(kPanelThreads) fwd_panels(Ops<T> o, Dims n, T* __restrict__ panels) {
  constexpr int G = group_of<T>();
  __shared__ T red[kPanelThreads / 32];
  const int bw = round_up(n.B, G), mw = round_up(n.M, G);
  const size_t kl = blockIdx.x / (DXU + 1);  // member k, latent l: k Ld + l
  const int i = blockIdx.x % (DXU + 1);
  T* dst = panels + kl * (DXU + 1) * (bw + mw);
  const T* rows[2] = {o.omega + kl * n.B * n.Dxu, o.zd + kl * n.M * n.Dxu};
  const T* scal[2] = {o.phase + kl * n.B, o.zd2 + kl * n.M};
  T top = T(0);
  for (int c = 0; c < 2; ++c) {  // the bases' row i, then the centers'
    const int wide = c ? mw : bw, cnt = c ? n.M : n.B;
    T* row = dst + (c ? (DXU + 1) * bw + i * mw : i * bw);
    for (int j = threadIdx.x; j < wide; j += kPanelThreads) {
      T val = T(0);
      if (j < cnt && i == DXU) val = scal[c][j];
      else if (j < cnt && i < n.Dxu) val = rows[c][(size_t)j * n.Dxu + i];
      row[j] = val;
      if (c == 0) top = mx(top, val < T(0) ? -val : val);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) top = mx(top, __shfl_xor_sync(0xffffffffu, top, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = top;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kPanelThreads / 32; ++w) top = mx(top, red[w]);
    panels[(size_t)n.K * n.Ld * (DXU + 1) * (bw + mw) + kl * (DXU + 1) + i] = top;
  }
}

// rows 0..DXU, columns [j0, j0 + wide), of a panel in global memory (rows
// gstride apart) into shared memory (rows sstride apart), 16 bytes a copy;
// wide is a multiple of the group. The caller commits.
template <typename T, int DXU, int kThreads>
__device__ __forceinline__ void stage_rows(T* dst, int sstride, const T* src, int gstride, int j0, int wide) {
  constexpr int G = group_of<T>();
#pragma unroll
  for (int i = 0; i <= DXU; ++i)
    for (int j = threadIdx.x * G; j < wide; j += kThreads * G)
      cp_async16(dst + i * sstride + j, src + (size_t)i * gstride + j0 + j);
}

// acc + sum over lane pl's groups g = pl, pl + kLanes, ... < ng of a panel
// (the first group at column c0 of the particle's weight row of cnt
// columns): kCenters false, the bases' cos(xu . omega_b + phase_b) w_b
// (cos_fast, or with kExact cos()); true, the centers' exp(-1/2 |xs -
// zd_m|^2) v_m (xs = the scaled input, x2 = |xs|^2). The weights from the
// lane's stream (kStreamed) or by single loads; the group's columns in
// order; no branch in the loop body.
template <typename T, int DXU, int kLanes, bool kCenters, bool kStreamed, bool kExact, typename S>
__device__ __forceinline__ T panel_loop(const Dims& n, const T* panel, int stride, int ng, int c0, int cnt,
                                        const T* row, const T (&xin)[DXU], T x2, T acc, int pl, S& ws) {
  constexpr int G = group_of<T>();
  for (int g = pl; g < ng; g += kLanes) {
    T wv[G], sc[G], tb[DXU][G];
    int k = 0;
    if (kStreamed) k = ws.take(wv);
    else ldg_group(wv, row, c0 + g * G, cnt);
    lds_group(sc, panel + DXU * stride + g * G);
#pragma unroll
    for (int i = 0; i < DXU; ++i) lds_group(tb[i], panel + i * stride + g * G);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      T v;
      if (kCenters) {
        T xz = T(0);
#pragma unroll
        for (int i = 0; i < DXU; ++i) xz = fm(xin[i], tb[i][q], xz);
        v = ex(T(-0.5) * mx(x2 + sc[q] - T(2) * xz, T(0)));
      } else {
        T pr = sc[q];
#pragma unroll
        for (int i = 0; i < DXU; ++i) pr = fm(xin[i], tb[i][q], pr);
        v = kExact ? cs(pr) : cos_fast(pr);
      }
      acc = fm(v, wv[q], acc);
    }
    if (kStreamed) ws.issue(n, k, ws.taken + kStream - 1);  // the slot just read takes the group kStream ahead
  }
  return acc;
}

// panel_loop with its weights' feed, and for the bases cos() where exact
template <typename T, int DXU, int kLanes, bool kCenters, typename S>
__device__ __forceinline__ T panel_sum(const Dims& n, const T* panel, int stride, int ng, int c0, int cnt,
                                       const T* row, bool stream, bool exact, const T (&xin)[DXU], T x2, T acc,
                                       int pl, S& ws) {
#define K6_PANEL(STREAMED, EXACT) \
  panel_loop<T, DXU, kLanes, kCenters, STREAMED, EXACT>(n, panel, stride, ng, c0, cnt, row, xin, x2, acc, pl, ws)
  if constexpr (!kCenters) {
    if (exact) return stream ? K6_PANEL(true, true) : K6_PANEL(false, true);
  }
  return stream ? K6_PANEL(true, false) : K6_PANEL(false, false);
#undef K6_PANEL
}

// The drift's input xu = [e, u] at state x, the same in every lane: the
// encoder, the policy's latents (lane j takes centers j, j + 32, ...; the
// partials meet by butterfly), the mixing Wp and the squash.
template <typename T, int DXU>
__device__ __forceinline__ void drift_input(const Dims& n, const Ops<T>& o, const T* x, T (&xu)[DXU]) {
  const int lane = threadIdx.x & 31;
  T e[DXU];
  encode<T, DXU>(n, x, e);
  T g[kMaxLp];
#pragma unroll
  for (int l = 0; l < kMaxLp; ++l) {
    g[l] = T(0);
    if (l < n.Lp) {
      T es[DXU];
      T s2 = T(0);
#pragma unroll
      for (int i = 0; i < DXU; ++i) {
        es[i] = i < n.De ? e[i] * o.ilp[l * n.De + i] : T(0);
        s2 = fm(es[i], es[i], s2);
      }
      T acc = T(0);
      for (int m = lane; m < n.Mp; m += 32) {
        T zr[DXU];
        load_row(zr, o.zp + ((size_t)l * n.Mp + m) * n.De, n.De);
        const T d2 = mx(s2 + o.zp2[l * n.Mp + m] - T(2) * dot(es, zr), T(0));
        acc = fm(ex(T(-0.5) * d2), o.alpha[l * n.Mp + m], acc);
      }
      g[l] = warp_sum(acc);
    }
  }
#pragma unroll
  for (int i = 0; i < DXU; ++i) {
    T val = T(0);
    if (i < n.De) val = e[i];
    else if (i < n.Dxu) val = T(n.squash) * (ncdf(graw_of(n, o, g, i - n.De)) - T(0.5));
    xu[i] = val;
  }
}

// All T steps of kFwdParticles particles of one member. kRing: the tables
// stream through two chunk buffers every step (one block barrier a chunk);
// else they are staged once (no block barrier inside the step loop). The
// cost, which the dynamics do not read, runs after the step loop: the
// particle's first warp takes the steps t = lane, lane + 32, ... from the
// trajectory it wrote, and the lanes' sums meet by butterfly.
template <typename T, int DXU, bool kRing>
__global__ void __launch_bounds__(32 * kFwdParticles * fwd_wpp<DXU>())
    fwd_warp(Ops<T> o, Dims n, const T* __restrict__ panels, T* __restrict__ loss, T* __restrict__ traj) {
  constexpr int G = group_of<T>(), kCols = ring_cols<T, DXU>();
  constexpr int kWpp = fwd_wpp<DXU>(), kLanes = 32 * kWpp, kThreads = kLanes * kFwdParticles;
  T* xch = reinterpret_cast<T*>(fwd_smem);  // [particle][step & 1][warp][kMaxLd], then [particle][16]
  T* tab = reinterpret_cast<T*>(fwd_smem + fwd_front_bytes<DXU>());
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x / kLanes;  // the block's particle
  const int wip = (threadIdx.x % kLanes) >> 5;  // the warp within the particle
  const int pl = threadIdx.x % kLanes;  // the particle's lane
  const int k = blockIdx.x / n.tiles;
  const int p = (blockIdx.x % n.tiles) * kFwdParticles + slot;
  const bool active = p < n.per;  // idle warps shadow the member's first particle and write nothing
  const size_t s = (size_t)k * n.per + (active ? p : 0);
  const int bw = round_up(n.B, G), mw = round_up(n.M, G);
  const int lat = (DXU + 1) * (bw + mw);  // a latent's two panels
  const int nbc = (n.B + kCols - 1) / kCols, nlc = nbc + (n.M + kCols - 1) / kCols;  // ring chunks

  // ring chunk c of a step (per latent: the bases' chunks, then the
  // centers') into buffer `buf` of the ring
  auto stage_chunk = [&](int c, int buf) {
    const int l = c / nlc, r = c % nlc;
    const bool basis = r < nbc;
    const int j0 = (basis ? r : r - nbc) * kCols;
    T* dst = tab + (size_t)buf * (DXU + 1) * kCols;
    const T* src = panels + ((size_t)k * n.Ld + l) * lat + (basis ? 0 : (DXU + 1) * bw);
    const int wide = round_up(min(kCols, (basis ? n.B : n.M) - j0), G);
    stage_rows<T, DXU, kThreads>(dst, kCols, src, basis ? bw : mw, j0, wide);
    cp_async_commit();
  };
  if (kRing) {
    stage_chunk(0, 0);
  } else {
    const T* member = panels + (size_t)k * n.Ld * lat;  // the member's panels
    for (int q = threadIdx.x * G; q < n.Ld * lat; q += kThreads * G) cp_async16(tab + q, member + q);
    cp_async_commit();
  }

  // the lane's weight stream, where the w and v rows hold whole aligned
  // groups (else single loads)
  const bool stream = n.B % G == 0 && n.M % G == 0 && (reinterpret_cast<size_t>(o.w) & 15) == 0 &&
                      (reinterpret_cast<size_t>(o.v) & 15) == 0;
  WStream<T, kLanes, kThreads> ws;
  ws.w = o.w + s * n.Ld * n.B, ws.v = o.v + s * n.Ld * n.M;
  ws.nbl = pl < bw / G ? (bw / G - pl + kLanes - 1) / kLanes : 0;
  ws.per = stream && active ? ws.nbl + (pl < mw / G ? (mw / G - pl + kLanes - 1) / kLanes : 0) : 0;
  ws.l = ws.r = ws.taken = 0;
#pragma unroll
  for (int j = 0; j < kStream; ++j) ws.issue(n, j, j);

  // the state, the same in every lane; step 0's input overlaps the copies
  T x[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) x[d] = d < n.D ? o.x0[s * n.D + d] : T(0);
  if (active && pl < n.D) traj[s * n.D + pl] = o.x0[s * n.D + pl];
  T xu[DXU];
  drift_input<T, DXU>(n, o, x, xu);
  if (!kRing) {
    cp_async_wait<0>();
    __syncthreads();
    if (!active) return;
  }

  int q = 0;  // ring chunks consumed
  for (int step = 0; step < n.T; ++step) {
    T f[kMaxLd];
#pragma unroll
    for (int j = 0; j < kMaxLd; ++j) f[j] = T(0);
    for (int l = 0; l < n.Ld; ++l) {
      const size_t kl = (size_t)k * n.Ld + l;
      const T* wrow = o.w + (s * n.Ld + l) * n.B;
      const T* vrow = o.v + (s * n.Ld + l) * n.M;
      // the centers' scaled input xs = xu ild and x2 = |xs|^2, formed where
      // they are needed (not held through the bases)
      T xs[DXU];
      auto scaled = [&]() {
        T x2 = T(0);
#pragma unroll
        for (int i = 0; i < DXU; ++i) {
          xs[i] = i < n.Dxu ? xu[i] * o.ild[kl * n.Dxu + i] : T(0);
          x2 = fm(xs[i], xs[i], x2);
        }
        return x2;
      };
      // cos_fast where every basis's argument stays in its range: |phase|
      // + sum |xu_i| |omega_i| against the rows' largest magnitudes
      const T* top = panels + (size_t)n.K * n.Ld * lat + kl * (DXU + 1);
      T bound = top[DXU];
#pragma unroll
      for (int i = 0; i < DXU; ++i) bound = fm(xu[i] < T(0) ? -xu[i] : xu[i], top[i], bound);
      const bool exact = !(bound <= cos_fast_range<T>());
      T acc = T(0);
      if (!kRing) {
        const T* pb = tab + l * lat;
        acc = panel_sum<T, DXU, kLanes, false>(n, pb, bw, bw / G, 0, n.B, wrow, stream, exact, xu, T(0), acc, pl,
                                               ws);
        const T x2 = scaled();
        acc = panel_sum<T, DXU, kLanes, true>(n, pb + (DXU + 1) * bw, mw, mw / G, 0, n.M, vrow, stream, exact, xs, x2,
                                              acc, pl, ws);
      } else {
        for (int r = 0; r < nlc; ++r, ++q) {
          cp_async_wait<0>();
          __syncthreads();  // chunk q is in for every thread; every warp is done with chunk q - 1
          if (q + 1 < n.T * n.Ld * nlc) stage_chunk((q + 1) % (n.Ld * nlc), (q + 1) & 1);
          if (!active) continue;
          const T* buf = tab + (size_t)(q & 1) * (DXU + 1) * kCols;
          const bool basis = r < nbc;
          const int j0 = (basis ? r : r - nbc) * kCols;
          const int ng = (min(kCols, (basis ? n.B : n.M) - j0) + G - 1) / G;
          if (basis) {
            acc = panel_sum<T, DXU, kLanes, false>(n, buf, kCols, ng, j0, n.B, wrow, stream, exact, xu, T(0), acc, pl,
                                                   ws);
          } else {
            const T x2 = scaled();
            acc = panel_sum<T, DXU, kLanes, true>(n, buf, kCols, ng, j0, n.M, vrow, stream, exact, xs, x2, acc, pl,
                                                  ws);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxLd; ++j)
        if (j == l) f[j] = acc;
    }
    if (!active) continue;  // the ring's idle warps keep to its barriers
    // the latents' partials meet by butterfly in each warp, then the
    // particle's warps add their totals in warp order: every lane of the
    // particle holds every total
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < kMaxLd; ++j)
        if (j < n.Ld) f[j] += __shfl_xor_sync(0xffffffffu, f[j], off);
    if (kWpp > 1) {
      T* mine = xch + ((slot * 2 + (step & 1)) * kWpp) * kMaxLd;  // this step's slots, by parity
      if (lane < kMaxLd) {
#pragma unroll
        for (int j = 0; j < kMaxLd; ++j)
          if (j == lane) mine[wip * kMaxLd + j] = f[j];
      }
      named_sync(1 + slot, kLanes);
#pragma unroll
      for (int j = 0; j < kMaxLd; ++j) {
        if (j < n.Ld) {
          T t = mine[j];
#pragma unroll
          for (int w = 1; w < kWpp; ++w) t += mine[w * kMaxLd + j];
          f[j] = t;
        }
      }
    }
    // the Euler step
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d < n.D) {
        T fd = o.mcd[k * n.D + d];
#pragma unroll
        for (int j = 0; j < kMaxLd; ++j)
          if (j < n.Ld) fd = fm(o.wd[d * n.Ld + j], f[j], fd);
        x[d] = x[d] + T(n.dt) * fd;
        if (pl == d) traj[((size_t)(step + 1) * n.S + s) * n.D + d] = x[d];
      }
    }
    if (step + 1 < n.T) {
      // the next input: the particle's first warp forms it, the others read it
      if (wip == 0) drift_input<T, DXU>(n, o, x, xu);
      if (kWpp > 1) {
        T* next = xch + kFwdParticles * 2 * kWpp * kMaxLd + slot * 16;
        if (wip == 0 && lane == 0) {
#pragma unroll
          for (int i = 0; i < DXU; ++i) next[i] = xu[i];
        }
        named_sync(1 + slot, kLanes);
        if (wip != 0) {
#pragma unroll
          for (int i = 0; i < DXU; ++i) xu[i] = next[i];
        }
      }
    }
  }
  if (!active || wip != 0) return;
  __syncwarp();  // the states lanes 0..D-1 wrote
  T c = T(0);
  for (int t = lane; t < n.T; t += 32) {
    T xt[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) xt[d] = d < n.D ? traj[((size_t)(t + 1) * n.S + s) * n.D + d] : T(0);
    c += cost<T, DXU>(n, o, xt, nullptr, T(0));
  }
  c = warp_sum(c);
  if (lane == 0) loss[s] = c;
}

// ---------------------------------------------------------------- backward
// Every heavy term of a backward step is linear in the carried adjoint, with
// coefficients fixed by the stored trajectory, so the backward runs as four
// launches: bwd_jac (every step's drift Jacobians at once), bwd_maps (every
// step's linear maps and cost term), bwd_adjoint (the small recurrence, a
// thread per particle) and bwd_grads (the policy gradients over all rows).
// A row is a (step t, particle s) pair. Scratch (ops/rollout_cuda.py sizes
// it from the shapes): jac (T, S, Ld, Dxu), maps (T, NM, S), glat (T, Lp, S).

constexpr int kJacThreads = 128;  // bwd_jac
// adjacent rows per bwd_jac thread: two in float32 (128 registers, four
// blocks an SM), one in float64 (two rows take 208 registers)
template <typename T>
__host__ __device__ constexpr int jac_rpt() { return sizeof(T) == 4 ? 2 : 1; }
// rows of a bwd_jac block, all of one member
template <typename T>
__host__ __device__ constexpr int jac_rows() { return kJacThreads * jac_rpt<T>(); }
constexpr int kChunk = 64;         // omega or zd rows a bwd_jac block stages per pass
constexpr int kRowThreads = 64;    // bwd_maps: a thread per row
constexpr int kAdjThreads = 32;    // bwd_adjoint: a thread per particle
constexpr int kGradRows = 64;      // rows per bwd_grads block (GRAD_ROWS)
constexpr int kGradThreads = 64;

// maps fields of a row: A_t^T (D x D, [d'][d]), the policy-latent map
// (Lp x D), the cost term c_{t+1} (D), h_l . e (Lp x De) for dilp
__host__ __device__ __forceinline__ int nmaps(const Dims& n) { return n.D * n.D + n.Lp * n.D + n.D + n.Lp * n.De; }

// The policy's latents g_l at one encoded state e (sequential over Mp).
template <typename T, int DXU>
__device__ void policy_row(const Dims& n, const Ops<T>& o, const T (&e)[DXU], T (&g)[kMaxLp]) {
#pragma unroll
  for (int l = 0; l < kMaxLp; ++l) {
    T acc = T(0);
    if (l < n.Lp) {
      T es[DXU];
      T s2 = T(0);
#pragma unroll
      for (int i = 0; i < DXU; ++i) {
        es[i] = i < n.De ? e[i] * o.ilp[l * n.De + i] : T(0);
        s2 = fm(es[i], es[i], s2);
      }
      for (int m = 0; m < n.Mp; ++m) {
        T zr[DXU];
        load_row(zr, o.zp + ((size_t)l * n.Mp + m) * n.De, n.De);
        const T d2 = mx(s2 + o.zp2[l * n.Mp + m] - T(2) * dot(es, zr), T(0));
        acc = fm(ex(T(-0.5) * d2), o.alpha[l * n.Mp + m], acc);
      }
    }
    g[l] = acc;
  }
}

// A staged row of DXU values from shared memory, 16 bytes a load
template <int DXU>
__device__ __forceinline__ void lds_row(float (&r)[DXU], const float* p) {
#pragma unroll
  for (int i = 0; i < DXU; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    r[i] = v.x, r[i + 1] = v.y, r[i + 2] = v.z, r[i + 3] = v.w;
  }
}
template <int DXU>
__device__ __forceinline__ void lds_row(double (&r)[DXU], const double* p) {
#pragma unroll
  for (int i = 0; i < DXU; i += 2) {
    const double2 v = *reinterpret_cast<const double2*>(p + i);
    r[i] = v.x, r[i + 1] = v.y;
  }
}

// Phase 1. Block: one member k, drift latent l and tile of jac_rows rows of
// that member, particle-major (a particle's steps adjacent, so a tile reads
// the w and v rows of a few particles). Thread: jac_rpt adjacent rows; it
// recomputes each step's input xu and accumulates J_l = d f_l / d xu over
// the B bases and M centers, whose omega and phase (zd and zd2) rows arrive
// by cp.async in chunks of kChunk, double-buffered. Each staged row serves
// the thread's rows from registers; each cell's sin or exp once.
template <typename T, int DXU>
__global__ void __launch_bounds__(kJacThreads) bwd_jac(const T* __restrict__ traj, Ops<T> o, Dims n,
                                                       T* __restrict__ jac) {
  constexpr int R = jac_rpt<T>(), kRows = jac_rows<T>();
  __shared__ __align__(16) T srow[2][kChunk][DXU];
  __shared__ T ssc[2][kChunk];
  const int rows = n.per * n.T;
  const int tiles = (rows + kRows - 1) / kRows;
  const int l = blockIdx.x % n.Ld;
  const int k = blockIdx.x / (n.Ld * tiles);
  const int r0 = (blockIdx.x / n.Ld) % tiles * kRows + threadIdx.x * R;
  const size_t kl = (size_t)k * n.Ld + l;
  const int nb = (n.B + kChunk - 1) / kChunk;
  const int nc = nb + (n.M + kChunk - 1) / kChunk;

  // chunk c (bases first, then centers) into buffer c & 1
  auto stage = [&](int c) {
    const bool basis = c < nb;
    const int j0 = (basis ? c : c - nb) * kChunk, cnt = basis ? n.B : n.M;
    const T* src = basis ? o.omega + kl * n.B * n.Dxu : o.zd + kl * n.M * n.Dxu;
    const T* ssrc = basis ? o.phase + kl * n.B : o.zd2 + kl * n.M;
    for (int q = threadIdx.x; q < kChunk * DXU; q += kJacThreads) {
      const int j = q / DXU, i = q % DXU;
      const bool v = j0 + j < cnt && i < n.Dxu;
      cp_async_elem(&srow[c & 1][j][i], v ? src + (size_t)(j0 + j) * n.Dxu + i : src, v);
    }
    for (int j = threadIdx.x; j < kChunk; j += kJacThreads)
      cp_async_elem(&ssc[c & 1][j], j0 + j < cnt ? ssrc + j0 + j : ssrc, j0 + j < cnt);
    cp_async_commit();
  };
  stage(0);  // its copy overlaps the rows' recomputed forward

  // the rows' step inputs; a ragged tile's spare rows repeat the last row
  // and are not written
  T xu[R][DXU];
  const T* wrow[R];
  const T* vrow[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int rr = min(r0 + q, rows - 1);
    const int t = rr % n.T;
    const size_t s = (size_t)k * n.per + rr / n.T;
    wrow[q] = o.w + (s * n.Ld + l) * n.B;
    vrow[q] = o.v + (s * n.Ld + l) * n.M;
    T x[kMaxD];
    for (int d = 0; d < n.D; ++d) x[d] = traj[((size_t)t * n.S + s) * n.D + d];
    T e[DXU];
    encode<T, DXU>(n, x, e);
    T g[kMaxLp];
    policy_row(n, o, e, g);
#pragma unroll
    for (int i = 0; i < DXU; ++i) {
      T val = T(0);
      if (i < n.De) val = e[i];
      else if (i < n.Dxu) val = T(n.squash) * (ncdf(graw_of(n, o, g, i - n.De)) - T(0.5));
      xu[q][i] = val;
    }
  }

  // -sum_b sin(xu . omega_lb + phase_lb) w_slb omega_lb
  T jb[R][DXU];
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int i = 0; i < DXU; ++i) jb[q][i] = T(0);
  int c = 0;
  for (; c < nb; ++c) {
    if (c + 1 < nc) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int b0 = c * kChunk, cnt = min(kChunk, n.B - b0);
    // unrolled by 4 here and by 2 over the centers, whose loop holds more
    // values (by 4 there the float32 kernel spills)
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      T orow[DXU];
      lds_row(orow, srow[c & 1][j]);
      const T ph = ssc[c & 1][j];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const T cf = sn(dot(xu[q], orow) + ph) * __ldg(wrow[q] + b0 + j);
#pragma unroll
        for (int i = 0; i < DXU; ++i) jb[q][i] = fm(-cf, orow[i], jb[q][i]);
      }
    }
    __syncthreads();  // the buffer is refilled by the next pass
  }

  // sum_m kv_m zd_lm and sum_m kv_m, kv_m = exp(-1/2 |xs - zd_lm|^2) v_slm
  T il[DXU], xs[R][DXU], x2[R], jc[R][DXU], kvsum[R];
#pragma unroll
  for (int i = 0; i < DXU; ++i) il[i] = i < n.Dxu ? o.ild[kl * n.Dxu + i] : T(0);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    x2[q] = kvsum[q] = T(0);
#pragma unroll
    for (int i = 0; i < DXU; ++i) {
      xs[q][i] = xu[q][i] * il[i];
      x2[q] = fm(xs[q][i], xs[q][i], x2[q]);
      jc[q][i] = T(0);
    }
  }
  for (; c < nc; ++c) {
    if (c + 1 < nc) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int m0 = (c - nb) * kChunk, cnt = min(kChunk, n.M - m0);
#pragma unroll 2
    for (int j = 0; j < cnt; ++j) {
      T zr[DXU];
      lds_row(zr, srow[c & 1][j]);
      const T zz = ssc[c & 1][j];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const T d2 = mx(x2[q] + zz - T(2) * dot(xs[q], zr), T(0));
        const T kv = ex(T(-0.5) * d2) * __ldg(vrow[q] + m0 + j);
        kvsum[q] += kv;
#pragma unroll
        for (int i = 0; i < DXU; ++i) jc[q][i] = fm(kv, zr[i], jc[q][i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = r0 + q;
    if (r < rows) {
      const size_t s = (size_t)k * n.per + r / n.T;
      T* out = jac + (((size_t)(r % n.T) * n.S + s) * n.Ld + l) * n.Dxu;
#pragma unroll
      for (int i = 0; i < DXU; ++i)
        if (i < n.Dxu) out[i] = fm(jc[q][i] - kvsum[q] * xs[q][i], il[i], jb[q][i]);
    }
  }
}

// Phase 1, continued. Thread: one row (t, s), step-major. With y the
// adjoint of x_{t+1} plus the cost's gradient there, the step's adjoint is
//   gxu = G y,  G = dt sum_l J_l Wd[:, l]^T          (the drift, through Wd)
//   glat = Mg y,  Mg[l'] = sum_u s pdf(graw_u) Wp[u, l'] G[De + u]   (squash)
//   ges_l' = glat_l' h_l',  h_l = sum_m kp alpha zp_lm - es_l sum_m kp alpha
//   g_t = y + encode_bwd(x_t, G[:De] y + sum_l' ilp_l' ges_l') = A_t^T y,
// all linear in y: the maps are pushed through by the D unit vectors y = e_d.
template <typename T, int DXU>
__global__ void __launch_bounds__(kRowThreads) bwd_maps(const T* __restrict__ traj, const T* __restrict__ gl,
                                                        Ops<T> o, Dims n, const T* __restrict__ jac,
                                                        T* __restrict__ maps) {
  const int row = blockIdx.x * kRowThreads + threadIdx.x;
  if (row >= n.S * n.T) return;
  const int t = row / n.S, s = row % n.S;
  const int fmg = n.D * n.D, fc = fmg + n.Lp * n.D, fhe = fc + n.D;
  T* out = maps + (size_t)t * nmaps(n) * n.S + s;  // field f at out[f * S]
  const T* jr = jac + ((size_t)t * n.S + s) * n.Ld * n.Dxu;
  T x[kMaxD], x1[kMaxD];
  for (int d = 0; d < n.D; ++d) {
    x[d] = traj[((size_t)t * n.S + s) * n.D + d];
    x1[d] = traj[((size_t)(t + 1) * n.S + s) * n.D + d];
  }
  // the cost's gradient at x_{t+1}
  {
    T ge1[DXU], cv[kMaxD];
    cost<T, DXU>(n, o, x1, ge1, gl[s]);
    for (int d = 0; d < n.D; ++d) cv[d] = T(0);
    encode_bwd(n, x1, ge1, cv);
    for (int d = 0; d < n.D; ++d) out[(size_t)(fc + d) * n.S] = cv[d];
  }
  // the policy at x_t: latents g_l, and h_l scaled by ilp_l (for ge) and by e (for dilp)
  T e[DXU];
  encode<T, DXU>(n, x, e);
  T g[kMaxLp], hi[kMaxLp][DXU];
#pragma unroll
  for (int l = 0; l < kMaxLp; ++l) {
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < DXU; ++i) hi[l][i] = T(0);
    if (l < n.Lp) {
      T es[DXU], hz[DXU];
      T s2 = T(0);
#pragma unroll
      for (int i = 0; i < DXU; ++i) {
        es[i] = i < n.De ? e[i] * o.ilp[l * n.De + i] : T(0);
        s2 = fm(es[i], es[i], s2);
        hz[i] = T(0);
      }
      for (int m = 0; m < n.Mp; ++m) {
        T zr[DXU];
        load_row(zr, o.zp + ((size_t)l * n.Mp + m) * n.De, n.De);
        const T d2 = mx(s2 + o.zp2[l * n.Mp + m] - T(2) * dot(es, zr), T(0));
        const T a = ex(T(-0.5) * d2) * o.alpha[l * n.Mp + m];
        acc += a;
#pragma unroll
        for (int i = 0; i < DXU; ++i) hz[i] = fm(a, zr[i], hz[i]);
      }
#pragma unroll
      for (int i = 0; i < DXU; ++i) {
        if (i < n.De) {
          const T h = hz[i] - es[i] * acc;
          hi[l][i] = h * o.ilp[l * n.De + i];
          out[(size_t)(fhe + l * n.De + i) * n.S] = h * e[i];
        }
      }
    }
    g[l] = acc;
  }
  T pd[kMaxU];
#pragma unroll
  for (int u = 0; u < kMaxU; ++u) {
    const T gr = u < n.U ? graw_of(n, o, g, u) : T(0);
    pd[u] = T(n.squash) * T(0.3989422804014327) * ex(T(-0.5) * gr * gr);
  }
  // column d of G, Mg and A_t^T
  for (int d = 0; d < n.D; ++d) {
    T gx[DXU];
#pragma unroll
    for (int i = 0; i < DXU; ++i) gx[i] = T(0);
    for (int l = 0; l < n.Ld; ++l) {
      const T wl = T(n.dt) * o.wd[d * n.Ld + l];
#pragma unroll
      for (int i = 0; i < DXU; ++i)
        if (i < n.Dxu) gx[i] = fm(jr[l * n.Dxu + i], wl, gx[i]);
    }
    T mg[kMaxLp];
#pragma unroll
    for (int l = 0; l < kMaxLp; ++l) {
      T a = T(0);
#pragma unroll
      for (int i = 0; i < DXU; ++i) {
        const int u = i - n.De;
        if (l < n.Lp && u >= 0 && u < n.U) a = fm(gx[i] * pd[u], o.wp[u * n.Lp + l], a);
      }
      mg[l] = a;
      if (l < n.Lp) out[(size_t)(fmg + l * n.D + d) * n.S] = a;
    }
    T ge[DXU];
#pragma unroll
    for (int i = 0; i < DXU; ++i) {
      T a = i < n.De ? gx[i] : T(0);
#pragma unroll
      for (int l = 0; l < kMaxLp; ++l) a = fm(hi[l][i], mg[l], a);
      ge[i] = a;
    }
    T col[kMaxD];
    for (int q = 0; q < n.D; ++q) col[q] = q == d ? T(1) : T(0);
    encode_bwd(n, x, ge, col);
    for (int q = 0; q < n.D; ++q) out[(size_t)(q * n.D + d) * n.S] = col[q];
  }
}

// Phase 2. Thread: one particle; for t = T-1 .. 0: y = g + c_{t+1},
// glat_t = Mg_t y, dilp += glat_t h_t e_t, g = A_t^T y. Step t-1's maps
// (coalesced: step-major, particles adjacent) arrive by cp.async into the
// thread's own column of shared memory while step t runs, so the chain of
// dependent steps waits on shared memory, not on L2.
template <typename T, int DXU>
__global__ void __launch_bounds__(kAdjThreads) bwd_adjoint(const T* __restrict__ maps, Dims n,
                                                           T* __restrict__ glat, T* __restrict__ dilp) {
  extern __shared__ __align__(16) unsigned char adj_smem[];
  T* buf = reinterpret_cast<T*>(adj_smem);  // [2][nmaps][kAdjThreads]
  const int lane = threadIdx.x;
  const int s = blockIdx.x * kAdjThreads + lane;
  const bool valid = s < n.S;
  const int nm = nmaps(n);
  const int fmg = n.D * n.D, fc = fmg + n.Lp * n.D, fhe = fc + n.D;
  // step t's maps into buffer t & 1, this thread's column only (no barrier)
  auto stage = [&](int t) {
    const T* src = maps + (size_t)t * nm * n.S + (valid ? s : 0);
    T* dst = buf + (size_t)(t & 1) * nm * kAdjThreads + lane;
    for (int f = 0; f < nm; ++f) cp_async_elem(dst + f * kAdjThreads, src + (size_t)f * n.S, valid);
    cp_async_commit();
  };
  T g[kMaxD], acc[kMaxLp][DXU];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) g[d] = T(0);
#pragma unroll
  for (int l = 0; l < kMaxLp; ++l)
#pragma unroll
    for (int i = 0; i < DXU; ++i) acc[l][i] = T(0);
  stage(n.T - 1);
  for (int t = n.T - 1; t >= 0; --t) {
    if (t > 0) {
      stage(t - 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const T* in = buf + (size_t)(t & 1) * nm * kAdjThreads + lane;  // field f at in[f * kAdjThreads]
    T y[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) y[d] = d < n.D ? g[d] + in[(fc + d) * kAdjThreads] : T(0);
#pragma unroll
    for (int l = 0; l < kMaxLp; ++l) {
      if (l < n.Lp) {
        T a = T(0);
#pragma unroll
        for (int d = 0; d < kMaxD; ++d)
          if (d < n.D) a = fm(in[(fmg + l * n.D + d) * kAdjThreads], y[d], a);
        if (valid) glat[((size_t)t * n.Lp + l) * n.S + s] = a;
#pragma unroll
        for (int i = 0; i < DXU; ++i)
          if (i < n.De) acc[l][i] = fm(a, in[(fhe + l * n.De + i) * kAdjThreads], acc[l][i]);
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxD; ++q) {
      T a = T(0);
      if (q < n.D) {
#pragma unroll
        for (int d = 0; d < kMaxD; ++d)
          if (d < n.D) a = fm(in[(q * n.D + d) * kAdjThreads], y[d], a);
      }
      g[q] = a;
    }
  }
  if (!valid) return;
#pragma unroll
  for (int l = 0; l < kMaxLp; ++l)
#pragma unroll
    for (int i = 0; i < DXU; ++i)
      if (l < n.Lp && i < n.De) dilp[((size_t)s * n.Lp + l) * n.De + i] = acc[l][i];
}

// Phase 3. Block: kGradRows rows, step-major; the rows' scaled policy
// inputs are staged in shared memory, then a thread per policy center
// (l, m) walks the rows in order: dalpha = sum kp glat, dzp = alpha
// (sum kp glat es - dalpha zp). Each block writes its slot; the wrapper adds
// the slots in order.
template <typename T, int DXU>
__global__ void __launch_bounds__(kGradThreads) bwd_grads(const T* __restrict__ traj,
                                                          const T* __restrict__ glat, Ops<T> o, Dims n,
                                                          T* __restrict__ dzp, T* __restrict__ dal) {
  __shared__ T es[kGradRows][kMaxLp][DXU];
  __shared__ T e2[kGradRows][kMaxLp], ga[kGradRows][kMaxLp];
  const int rows = n.S * n.T, r0 = blockIdx.x * kGradRows;
  for (int j = threadIdx.x; j < kGradRows; j += kGradThreads) {
    const int row = r0 + j;
    const bool valid = row < rows;
    const int t = valid ? row / n.S : 0, s = valid ? row % n.S : 0;
    T x[kMaxD], e[DXU];
    for (int d = 0; d < n.D; ++d) x[d] = traj[((size_t)t * n.S + s) * n.D + d];
    encode<T, DXU>(n, x, e);
#pragma unroll
    for (int l = 0; l < kMaxLp; ++l) {
      T s2 = T(0);
#pragma unroll
      for (int i = 0; i < DXU; ++i) {
        const T v = (valid && l < n.Lp && i < n.De) ? e[i] * o.ilp[l * n.De + i] : T(0);
        es[j][l][i] = v;
        s2 = fm(v, v, s2);
      }
      e2[j][l] = s2;
      ga[j][l] = (valid && l < n.Lp) ? glat[((size_t)t * n.Lp + l) * n.S + s] : T(0);
    }
  }
  __syncthreads();
  const int nr = min(kGradRows, rows - r0);
  for (int c = threadIdx.x; c < n.Lp * n.Mp; c += kGradThreads) {
    const int l = c / n.Mp;
    T zr[DXU], p1[DXU];
    load_row(zr, o.zp + (size_t)c * n.De, n.De);
    const T z2 = o.zp2[c];
#pragma unroll
    for (int i = 0; i < DXU; ++i) p1[i] = T(0);
    T p0 = T(0);
    for (int j = 0; j < nr; ++j) {
      T esr[DXU];
#pragma unroll
      for (int i = 0; i < DXU; ++i) esr[i] = es[j][l][i];
      const T d2 = mx(e2[j][l] + z2 - T(2) * dot(esr, zr), T(0));
      const T a = ex(T(-0.5) * d2) * ga[j][l];
      p0 += a;
#pragma unroll
      for (int i = 0; i < DXU; ++i) p1[i] = fm(a, esr[i], p1[i]);
    }
    const size_t slot = (size_t)blockIdx.x * n.Lp * n.Mp + c;
    dal[slot] = p0;
    const T al = o.alpha[c];
#pragma unroll
    for (int i = 0; i < DXU; ++i)
      if (i < n.De) dzp[slot * n.De + i] = al * (p1[i] - p0 * zr[i]);
  }
}

inline bool bad_dims(const Dims& n) {
  return n.S <= 0 || n.K <= 0 || n.per <= 0 || n.S != n.K * n.per || n.T <= 0 || n.D <= 0 ||
         n.D > kMaxD || n.na <= 0 || n.na > n.D || n.De != n.D + n.na || n.U <= 0 ||
         n.U > kMaxU || n.Lp <= 0 || n.Lp > kMaxLp || n.Ld <= 0 || n.Ld > kMaxLd || n.Mp <= 0 ||
         n.B <= 0 || n.M <= 0 || n.Dxu != n.De + n.U || n.Dxu > 16;
}

template <typename T, int DXU, bool kRing>
int launch_fwd_route(const Ops<T>& o, const Dims& n, T* panels, T* loss, T* traj, cudaStream_t st) {
  const size_t smem = fwd_smem_bytes<T, DXU>(n, kRing);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  int err;
  if (smem > 48 * 1024 &&
      (err = (int)cudaFuncSetAttribute(fwd_warp<T, DXU, kRing>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem)))
    return err;
  fwd_panels<T, DXU><<<n.K * n.Ld * (DXU + 1), kPanelThreads, 0, st>>>(o, n, panels);
  if ((err = (int)cudaGetLastError())) return err;
  fwd_warp<T, DXU, kRing><<<n.K * n.tiles, 32 * kFwdParticles * fwd_wpp<DXU>(), smem, st>>>(o, n, panels, loss,
                                                                                          traj);
  return (int)cudaGetLastError();
}

template <typename T, int DXU>
int launch_fwd_width(const Ops<T>& o, const Dims& n, T* panels, T* loss, T* traj, int ring, cudaStream_t st) {
  return ring ? launch_fwd_route<T, DXU, true>(o, n, panels, loss, traj, st)
              : launch_fwd_route<T, DXU, false>(o, n, panels, loss, traj, st);
}

// ring: 0 the resident route, 1 the ring (ops/rollout_cuda.py:fwd_plan
// picks); panels: scratch of K Ld (DXU + 1) (bw + mw + 1) elements
// (fwd_panels)
template <typename T>
int launch_fwd(const Ops<T>& o, Dims n, T* panels, T* loss, T* traj, int ring, void* stream) {
  if (bad_dims(n) || (ring != 0 && ring != 1)) return (int)cudaErrorInvalidValue;
  n.tiles = (n.per + kFwdParticles - 1) / kFwdParticles;
  cudaStream_t st = (cudaStream_t)stream;
  if (n.Dxu <= 6) return launch_fwd_width<T, 6>(o, n, panels, loss, traj, ring, st);
  if (n.Dxu <= 8) return launch_fwd_width<T, 8>(o, n, panels, loss, traj, ring, st);
  return launch_fwd_width<T, 16>(o, n, panels, loss, traj, ring, st);
}

template <typename T, int DXU>
int launch_bwd_phases(const T* traj, const T* gl, const Ops<T>& o, const Dims& n, T* jac, T* maps,
                      T* glat, T* dzp, T* dal, T* dilp, cudaStream_t st) {
  const int rows = n.S * n.T;
  const int jac_blocks = n.K * ((n.per * n.T + jac_rows<T>() - 1) / jac_rows<T>()) * n.Ld;
  bwd_jac<T, DXU><<<jac_blocks, kJacThreads, 0, st>>>(traj, o, n, jac);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bwd_maps<T, DXU><<<(rows + kRowThreads - 1) / kRowThreads, kRowThreads, 0, st>>>(traj, gl, o, n, jac,
                                                                                    maps);
  if ((err = (int)cudaGetLastError())) return err;
  const size_t adj_smem = 2 * (size_t)nmaps(n) * kAdjThreads * sizeof(T);
  if (adj_smem > 48 * 1024 &&
      (err = (int)cudaFuncSetAttribute(bwd_adjoint<T, DXU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)adj_smem)))
    return err;
  bwd_adjoint<T, DXU><<<(n.S + kAdjThreads - 1) / kAdjThreads, kAdjThreads, adj_smem, st>>>(maps, n, glat,
                                                                                          dilp);
  if ((err = (int)cudaGetLastError())) return err;
  bwd_grads<T, DXU><<<(rows + kGradRows - 1) / kGradRows, kGradThreads, 0, st>>>(traj, glat, o, n, dzp,
                                                                                  dal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* traj, const T* gl, const Ops<T>& o, Dims n, T* jac, T* maps, T* glat, T* dzp,
               T* dal, T* dilp, void* stream) {
  if (bad_dims(n)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n.Dxu <= 8) return launch_bwd_phases<T, 8>(traj, gl, o, n, jac, maps, glat, dzp, dal, dilp, st);
  return launch_bwd_phases<T, 16>(traj, gl, o, n, jac, maps, glat, dzp, dal, dilp, st);
}

}  // namespace

// operands after x0, in ops/rollout_cuda.py's OPERANDS order
#define ROLLOUT_OPERANDS(T)                                                                      \
  const T *zp, const T *zp2, const T *alpha, const T *ilp, const T *wp, const T *mcp,           \
      const T *omega, const T *phase, const T *ild, const T *zd, const T *zd2, const T *w,      \
      const T *v, const T *wd, const T *mcd, const T *target, const T *precis
#define ROLLOUT_SCALARS                                                                          \
  int S, int K, int per, int T_, int D, int De, int U, int Lp, int Mp, int Ld, int B, int M,   \
      int code, int na, double dt, double squash
#define ROLLOUT_OPS(T, X0)                                                                       \
  Ops<T> { X0, zp, zp2, alpha, ilp, wp, mcp, omega, phase, ild, zd, zd2, w, v, wd, mcd, target, \
           precis }
#define ROLLOUT_DIMS Dims{S, K, per, T_, D, De, U, Lp, Mp, Ld, B, M, De + U, code, na, 0, dt, squash}

#define ROLLOUT_ENTRIES(T, SFX)                                                                  \
  extern "C" int rollout_fwd_##SFX(const T* x0, ROLLOUT_OPERANDS(T), T* panels, T* loss,      \
                                   T* traj, ROLLOUT_SCALARS, int ring, void* stream) {        \
    return launch_fwd<T>(ROLLOUT_OPS(T, x0), ROLLOUT_DIMS, panels, loss, traj, ring, stream);  \
  }                                                                                            \
  extern "C" int rollout_bwd_##SFX(const T* traj, const T* gl, ROLLOUT_OPERANDS(T), T* jac,   \
                                   T* maps, T* glat, T* dzp, T* dal, T* dilp, ROLLOUT_SCALARS,  \
                                   void* stream) {                                             \
    return launch_bwd<T>(traj, gl, ROLLOUT_OPS(T, nullptr), ROLLOUT_DIMS, jac, maps, glat, dzp, \
                         dal, dilp, stream);                                                   \
  }

ROLLOUT_ENTRIES(float, f32)
ROLLOUT_ENTRIES(double, f64)
