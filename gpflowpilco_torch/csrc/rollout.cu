// The whole pathwise policy-rollout loss for Hopper (sm_90a), float32 and
// float64.
//
// Replaces the TPU kernels of gpflowpilco_tpu/ops/rollout_pallas.py:
//   rollout_fwd_{f32,f64} <- _fwd_kernel (:195), launched by _fwd_impl (:420)
//   rollout_bwd_{f32,f64} <- _bwd_kernel (:221), launched by _vjp_bwd (:499)
//
// Forward: for a tile of particles, all T steps of
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
// particle s rides member s / per. A forward block takes a tile of kTile
// particles of one member, so every omega and zd row it reads from L2
// serves kTile particles, as in csrc/path_eval.cu; a bwd_jac block takes
// rows of one member.
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
// cos, exp and Phi), so a block runs its 30 steps one after another; one
// 256-thread block per tile; the tile's states, encoded inputs and per-step
// scalars live in shared memory across the steps; threads stride over the
// bases B, the centers M and the policy centers Mp, each holding the tile's
// xu rows in registers; per-step sums meet in a warp-shuffle plus
// shared-memory block reduction; the small serial parts (encoder, squash,
// Euler, cost) run on one thread per particle.
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4;  // particles per block
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

// Sums vals[i] over the block; thread i < N gets the total of entry i.
// `red` holds kWarps * N values of shared memory.
template <typename T, int N>
__device__ __forceinline__ T block_sum(const T (&vals)[N], T* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T s = warp_sum(vals[i]);
    if (lane == 0) red[warp * N + i] = s;
  }
  __syncthreads();
  T total = T(0);
  if (threadIdx.x < N) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w * N + threadIdx.x];
  }
  __syncthreads();  // red is reused by the next call
  return total;
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

// Shared state of a tile, common to both kernels.
template <typename T, int DXU>
struct Tile {
  T x[kTile][kMaxD];          // the state x_t
  T xu[kTile][DXU];           // [e, u], zero padded
  T es[kTile][kMaxLp][DXU];   // e il_l, zero padded
  T e2[kTile][kMaxLp];        // |e il_l|^2
  T glat[kTile][kMaxLp];      // policy latents (backward: their cotangents)
  T graw[kTile][kMaxU];       // the pre-squash action
};

// Encodes the tile's states into t.xu[:, :De] and the scaled policy
// inputs; one thread per particle.
template <typename T, int DXU>
__device__ void encode_tile(const Dims& n, const Ops<T>& o, Tile<T, DXU>& t, int np) {
  const int p = threadIdx.x;
  if (p >= kTile) return;
  T e[DXU];
  if (p < np) encode<T, DXU>(n, t.x[p], e);
  else for (int i = 0; i < DXU; ++i) e[i] = T(0);
  for (int i = 0; i < DXU; ++i) t.xu[p][i] = e[i];
  for (int l = 0; l < kMaxLp; ++l) {
    T s2 = T(0);
    for (int i = 0; i < DXU; ++i) {
      const T v = (l < n.Lp && i < n.De) ? e[i] * o.ilp[l * n.De + i] : T(0);
      t.es[p][l][i] = v;
      s2 = fm(v, v, s2);
    }
    t.e2[p][l] = s2;
  }
}

// The policy's latents at the encoded states (all threads), then the
// squashed action into t.xu[:, De:] (one thread per particle).
template <typename T, int DXU>
__device__ void policy_tile(const Dims& n, const Ops<T>& o, Tile<T, DXU>& t, T* red, int np) {
  for (int l = 0; l < n.Lp; ++l) {
    T acc[kTile];
#pragma unroll
    for (int p = 0; p < kTile; ++p) acc[p] = T(0);
    for (int m = threadIdx.x; m < n.Mp; m += kThreads) {
      T zr[DXU];
      load_row(zr, o.zp + ((size_t)l * n.Mp + m) * n.De, n.De);
      const T z2 = o.zp2[l * n.Mp + m], al = o.alpha[l * n.Mp + m];
#pragma unroll
      for (int p = 0; p < kTile; ++p) {
        if (p < np) {
          T esr[DXU];
#pragma unroll
          for (int i = 0; i < DXU; ++i) esr[i] = t.es[p][l][i];
          const T d2 = mx(t.e2[p][l] + z2 - T(2) * dot(esr, zr), T(0));
          acc[p] = fm(ex(T(-0.5) * d2), al, acc[p]);
        }
      }
    }
    const T total = block_sum(acc, red);
    if (threadIdx.x < np) t.glat[threadIdx.x][l] = total;
  }
  __syncthreads();
  const int p = threadIdx.x;
  if (p < np) {
    for (int u = 0; u < n.U; ++u) {
      T g = o.mcp[u];
      for (int l = 0; l < n.Lp; ++l) g = fm(o.wp[u * n.Lp + l], t.glat[p][l], g);
      t.graw[p][u] = g;
      t.xu[p][n.De + u] = T(n.squash) * (ncdf(g) - T(0.5));
    }
  }
  __syncthreads();
}

template <typename T, int DXU>
__device__ __forceinline__ void load_xu(const Tile<T, DXU>& t, T (&xr)[kTile][DXU]) {
#pragma unroll
  for (int p = 0; p < kTile; ++p)
#pragma unroll
    for (int i = 0; i < DXU; ++i) xr[p][i] = t.xu[p][i];
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

template <typename T, int DXU>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Ops<T> o, Dims n, T* __restrict__ loss,
                                                       T* __restrict__ traj) {
  __shared__ Tile<T, DXU> t;
  __shared__ T flat[kTile][kMaxLd];
  __shared__ T acc_loss[kTile];
  __shared__ T red[kWarps * kTile];
  const int k = blockIdx.x / n.tiles;
  const int p0 = (blockIdx.x % n.tiles) * kTile;
  const int np = min(kTile, n.per - p0);
  const size_t s0 = (size_t)k * n.per + p0;
  const int tid = threadIdx.x;

  if (tid < kTile) {
    for (int d = 0; d < kMaxD; ++d) {
      const T xv = (tid < np && d < n.D) ? o.x0[(s0 + tid) * n.D + d] : T(0);
      t.x[tid][d] = xv;
      if (tid < np && d < n.D) traj[(s0 + tid) * n.D + d] = xv;
    }
    acc_loss[tid] = T(0);
  }
  __syncthreads();

  for (int step = 0; step < n.T; ++step) {
    encode_tile(n, o, t, np);
    __syncthreads();
    policy_tile(n, o, t, red, np);

    // the drift latents at xu
    T xr[kTile][DXU];
    load_xu(t, xr);
    for (int l = 0; l < n.Ld; ++l) {
      const size_t kl = (size_t)k * n.Ld + l;
      T acc[kTile];
#pragma unroll
      for (int p = 0; p < kTile; ++p) acc[p] = T(0);
      const T* om = o.omega + kl * n.B * n.Dxu;
      for (int b = tid; b < n.B; b += kThreads) {
        T orow[DXU];
        load_row(orow, om + (size_t)b * n.Dxu, n.Dxu);
        const T ph = o.phase[kl * n.B + b];
#pragma unroll
        for (int p = 0; p < kTile; ++p)
          if (p < np)
            acc[p] = fm(cs(dot(xr[p], orow) + ph), o.w[((s0 + p) * n.Ld + l) * n.B + b], acc[p]);
      }
      T il[DXU];
      load_row(il, o.ild + kl * n.Dxu, n.Dxu);
      T x2[kTile];
#pragma unroll
      for (int p = 0; p < kTile; ++p) {
        T s2 = T(0);
#pragma unroll
        for (int i = 0; i < DXU; ++i) s2 = fm(xr[p][i] * il[i], xr[p][i] * il[i], s2);
        x2[p] = s2;
      }
      for (int m = tid; m < n.M; m += kThreads) {
        T zr[DXU];
        load_row(zr, o.zd + (kl * n.M + m) * n.Dxu, n.Dxu);
        const T zz = o.zd2[kl * n.M + m];
#pragma unroll
        for (int p = 0; p < kTile; ++p) {
          if (p < np) {
            T xz = T(0);
#pragma unroll
            for (int i = 0; i < DXU; ++i) xz = fm(xr[p][i] * il[i], zr[i], xz);
            const T d2 = mx(x2[p] + zz - T(2) * xz, T(0));
            acc[p] = fm(ex(T(-0.5) * d2), o.v[((s0 + p) * n.Ld + l) * n.M + m], acc[p]);
          }
        }
      }
      const T total = block_sum(acc, red);
      if (tid < np) flat[tid][l] = total;
    }
    __syncthreads();

    // Euler step and the cost, one thread per particle
    if (tid < np) {
      for (int d = 0; d < n.D; ++d) {
        T f = o.mcd[k * n.D + d];
        for (int l = 0; l < n.Ld; ++l) f = fm(o.wd[d * n.Ld + l], flat[tid][l], f);
        const T xn = t.x[tid][d] + T(n.dt) * f;
        t.x[tid][d] = xn;
        traj[((size_t)(step + 1) * n.S + s0 + tid) * n.D + d] = xn;
      }
      acc_loss[tid] += cost<T, DXU>(n, o, t.x[tid], nullptr, T(0));
    }
    __syncthreads();
  }
  if (tid < np) loss[s0 + tid] = acc_loss[tid];
}

// ---------------------------------------------------------------- backward
// Every heavy term of a backward step is linear in the carried adjoint, with
// coefficients fixed by the stored trajectory, so the backward runs as four
// launches: bwd_jac (every step's drift Jacobians at once), bwd_maps (every
// step's linear maps and cost term), bwd_adjoint (the small recurrence, a
// thread per particle) and bwd_grads (the policy gradients over all rows).
// A row is a (step t, particle s) pair. Scratch (ops/rollout_cuda.py sizes
// it from the shapes): jac (T, S, Ld, Dxu), maps (T, NM, S), glat (T, Lp, S).

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

// graw_u = mc_p + Wp g
template <typename T>
__device__ __forceinline__ T graw_of(const Dims& n, const Ops<T>& o, const T (&g)[kMaxLp], int u) {
  T a = o.mcp[u];
#pragma unroll
  for (int l = 0; l < kMaxLp; ++l)
    if (l < n.Lp) a = fm(o.wp[u * n.Lp + l], g[l], a);
  return a;
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

template <typename T>
int launch_fwd(const Ops<T>& o, Dims n, T* loss, T* traj, void* stream) {
  if (bad_dims(n)) return (int)cudaErrorInvalidValue;
  n.tiles = (n.per + kTile - 1) / kTile;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = n.K * n.tiles;
  if (n.Dxu <= 8)
    fwd_kernel<T, 8><<<blocks, kThreads, 0, st>>>(o, n, loss, traj);
  else
    fwd_kernel<T, 16><<<blocks, kThreads, 0, st>>>(o, n, loss, traj);
  return (int)cudaGetLastError();
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
  extern "C" int rollout_fwd_##SFX(const T* x0, ROLLOUT_OPERANDS(T), T* loss, T* traj,        \
                                   ROLLOUT_SCALARS, void* stream) {                           \
    return launch_fwd<T>(ROLLOUT_OPS(T, x0), ROLLOUT_DIMS, loss, traj, stream);                \
  }                                                                                            \
  extern "C" int rollout_bwd_##SFX(const T* traj, const T* gl, ROLLOUT_OPERANDS(T), T* jac,   \
                                   T* maps, T* glat, T* dzp, T* dal, T* dilp, ROLLOUT_SCALARS,  \
                                   void* stream) {                                             \
    return launch_bwd<T>(traj, gl, ROLLOUT_OPS(T, nullptr), ROLLOUT_DIMS, jac, maps, glat, dzp, \
                         dal, dilp, stream);                                                   \
  }

ROLLOUT_ENTRIES(float, f32)
ROLLOUT_ENTRIES(double, f64)
