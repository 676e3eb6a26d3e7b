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
// Backward: in reverse time from the stored trajectory, recomputing each
// step's internals, the adjoint of the state through the cost, the drift,
// the squash and the policy; each block writes its partial dzp (Lp, Mp, De),
// dalpha (Lp, Mp) and dilp (Lp, De), summed outside the kernel (no atomics).
// The cost's gradient uses sym(P) err, exact for any P.
//
// The drift operands carry a member axis K in front (1 for an SVGP drift);
// particle s rides member s / per. A block takes a tile of kTile particles
// of one member, so every omega and zd row it reads from L2 serves kTile
// particles, as in csrc/path_eval.cu.
//
// Bound on an H100 (SXM): per particle and step the forward does
// Ld (B + M) projections of Dxu terms with a cos or an exp each, about 85k
// operations at the cartpole's widths (S=1024, B=1024, M=240, Ld=4,
// Dxu=6; chip_smoke.py's rollout_bound_ms), 2.6 GFLOP over 30 steps:
// 0.039 ms in float32, 0.077 ms in float64, above the ~21 MB of unique
// bytes (w, v, the trajectory; 0.006 ms). The backward needs about 147k
// per particle and step (a sin and two Dxu-term passes per basis and
// center, no cos or weight), about 1.7x the forward.
// The kernel is bound by operations, and by its latency: the steps are
// sequential, so a block runs its 30 steps one after another.
// Design: one 256-thread block per tile; the tile's states, encoded inputs
// and per-step scalars live in shared memory across the steps; threads
// stride over the bases B, the centers M and the policy centers Mp, each
// holding the tile's xu rows in registers; per-step sums meet in a
// warp-shuffle plus shared-memory block reduction; the small serial parts
// (encoder, squash, Euler, cost) run on one thread per particle. The
// |x|^2+|z|^2-2x.z expansions are plain FMA loops in the working type (no
// fast math), as the JAX kernel pins HIGHEST precision. The normal CDF is
// normcdf, exact, where the TPU kernel approximated it.
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

template <typename T, int DXU>
__global__ void __launch_bounds__(kThreads) bwd_kernel(const T* __restrict__ traj,
                                                       const T* __restrict__ gl, Ops<T> o, Dims n,
                                                       T* __restrict__ dzp, T* __restrict__ dal,
                                                       T* __restrict__ dilp) {
  constexpr int NV = kTile * DXU;
  __shared__ Tile<T, DXU> t;
  __shared__ T g[kTile][kMaxD];       // the carried state adjoint
  __shared__ T g1[kTile][kMaxD];      // g plus the cost's gradient at x_{t+1}
  __shared__ T gf[kTile][kMaxLd];     // the drift latents' cotangents
  __shared__ T vec[kTile][DXU];       // a reduced vector per particle
  __shared__ T ge[kTile][DXU];        // the encoded state's cotangent
  __shared__ T dilp_p[kTile][kMaxLp][DXU];
  __shared__ T red[kWarps * NV];
  const int k = blockIdx.x / n.tiles;
  const int p0 = (blockIdx.x % n.tiles) * kTile;
  const int np = min(kTile, n.per - p0);
  const size_t s0 = (size_t)k * n.per + p0;
  const int tid = threadIdx.x;
  T* dzp_b = dzp + (size_t)blockIdx.x * n.Lp * n.Mp * n.De;
  T* dal_b = dal + (size_t)blockIdx.x * n.Lp * n.Mp;
  T* dilp_b = dilp + (size_t)blockIdx.x * n.Lp * n.De;

  // thread tid owns the policy centers m = tid, tid + kThreads, ...
  for (int m = tid; m < n.Mp; m += kThreads) {
    for (int l = 0; l < n.Lp; ++l) {
      dal_b[l * n.Mp + m] = T(0);
      for (int i = 0; i < n.De; ++i) dzp_b[((size_t)l * n.Mp + m) * n.De + i] = T(0);
    }
  }
  if (tid < kTile) {
    for (int d = 0; d < kMaxD; ++d) g[tid][d] = T(0);
    for (int l = 0; l < kMaxLp; ++l)
      for (int i = 0; i < DXU; ++i) dilp_p[tid][l][i] = T(0);
  }
  __syncthreads();

  for (int r = 0; r < n.T; ++r) {
    const int step = n.T - 1 - r;
    // the cost's gradient at x_{t+1} and the state x_t, one thread per particle
    if (tid < kTile) {
      for (int d = 0; d < kMaxD; ++d) t.x[tid][d] = T(0);
      if (tid < np) {
        const size_t s = s0 + tid;
        T x1[kMaxD], gg[kMaxD], ge1[DXU];
        for (int d = 0; d < n.D; ++d) {
          x1[d] = traj[((size_t)(step + 1) * n.S + s) * n.D + d];
          t.x[tid][d] = traj[((size_t)step * n.S + s) * n.D + d];
          gg[d] = g[tid][d];
        }
        cost<T, DXU>(n, o, x1, ge1, gl[s]);
        encode_bwd(n, x1, ge1, gg);
        for (int d = 0; d < n.D; ++d) g1[tid][d] = gg[d];
        for (int l = 0; l < n.Ld; ++l) {
          T a = T(0);
          for (int d = 0; d < n.D; ++d) a = fm(o.wd[d * n.Ld + l], gg[d], a);
          gf[tid][l] = T(n.dt) * a;
        }
      } else {
        for (int l = 0; l < kMaxLd; ++l) gf[tid][l] = T(0);
      }
    }
    __syncthreads();
    // the step's forward internals at x_t, recomputed
    encode_tile(n, o, t, np);
    __syncthreads();
    policy_tile(n, o, t, red, np);

    // the drift's adjoint: gxu = sum_l gf_l (-sum_b sin(proj) w omega_lb
    //                                + (sum_m kv zd_lm - sum_m kv xs_l) ild_l)
    T xr[kTile][DXU];
    load_xu(t, xr);
    T gacc[kTile][DXU];
#pragma unroll
    for (int p = 0; p < kTile; ++p)
#pragma unroll
      for (int i = 0; i < DXU; ++i) gacc[p][i] = T(0);
    for (int l = 0; l < n.Ld; ++l) {
      const size_t kl = (size_t)k * n.Ld + l;
      T gfl[kTile];
#pragma unroll
      for (int p = 0; p < kTile; ++p) gfl[p] = gf[p][l];
      const T* om = o.omega + kl * n.B * n.Dxu;
      for (int b = tid; b < n.B; b += kThreads) {
        T orow[DXU];
        load_row(orow, om + (size_t)b * n.Dxu, n.Dxu);
        const T ph = o.phase[kl * n.B + b];
#pragma unroll
        for (int p = 0; p < kTile; ++p) {
          if (p < np) {
            const T c = gfl[p] * sn(dot(xr[p], orow) + ph) * o.w[((s0 + p) * n.Ld + l) * n.B + b];
#pragma unroll
            for (int i = 0; i < DXU; ++i) gacc[p][i] = fm(-c, orow[i], gacc[p][i]);
          }
        }
      }
      T il[DXU];
      load_row(il, o.ild + kl * n.Dxu, n.Dxu);
      T x2[kTile], kvsum[kTile];
#pragma unroll
      for (int p = 0; p < kTile; ++p) {
        T s2 = T(0);
#pragma unroll
        for (int i = 0; i < DXU; ++i) s2 = fm(xr[p][i] * il[i], xr[p][i] * il[i], s2);
        x2[p] = s2;
        kvsum[p] = T(0);
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
            const T kv = gfl[p] * (ex(T(-0.5) * d2) * o.v[((s0 + p) * n.Ld + l) * n.M + m]);
            kvsum[p] += kv;
#pragma unroll
            for (int i = 0; i < DXU; ++i) gacc[p][i] = fm(kv * il[i], zr[i], gacc[p][i]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < kTile; ++p)
#pragma unroll
        for (int i = 0; i < DXU; ++i) gacc[p][i] = fm(-kvsum[p] * xr[p][i] * il[i], il[i], gacc[p][i]);
    }
    T flat_g[NV];
#pragma unroll
    for (int p = 0; p < kTile; ++p)
#pragma unroll
      for (int i = 0; i < DXU; ++i) flat_g[p * DXU + i] = gacc[p][i];
    const T gxu = block_sum(flat_g, red);
    if (tid < NV) vec[tid / DXU][tid % DXU] = gxu;
    __syncthreads();

    // the squash (du/dgraw = s pdf(graw)) and the Wp mixing
    if (tid < np) {
      const int p = tid;
      T graw_g[kMaxU];
      for (int u = 0; u < n.U; ++u) {
        const T gr = t.graw[p][u];
        graw_g[u] = vec[p][n.De + u] * T(n.squash) * T(0.3989422804014327) * ex(T(-0.5) * gr * gr);
      }
      for (int l = 0; l < n.Lp; ++l) {
        T a = T(0);
        for (int u = 0; u < n.U; ++u) a = fm(graw_g[u], o.wp[u * n.Lp + l], a);
        t.glat[p][l] = a;
      }
      for (int i = 0; i < DXU; ++i) ge[p][i] = i < n.De ? vec[p][i] : T(0);
    }
    __syncthreads();

    // the policy latents: dalpha and dzp by the thread owning center m;
    // sum_m amat zp_lm (entries < De) and row sums of amat (entry DXU - 1)
    // reduced over the block for each particle
    for (int l = 0; l < n.Lp; ++l) {
      T part[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) part[i] = T(0);
      for (int m = tid; m < n.Mp; m += kThreads) {
        T zr[DXU];
        load_row(zr, o.zp + ((size_t)l * n.Mp + m) * n.De, n.De);
        const T z2 = o.zp2[l * n.Mp + m], al = o.alpha[l * n.Mp + m];
        T dal_m = T(0), dz[DXU];
#pragma unroll
        for (int i = 0; i < DXU; ++i) dz[i] = T(0);
#pragma unroll
        for (int p = 0; p < kTile; ++p) {
          if (p < np) {
            T esr[DXU];
#pragma unroll
            for (int i = 0; i < DXU; ++i) esr[i] = t.es[p][l][i];
            const T d2 = mx(t.e2[p][l] + z2 - T(2) * dot(esr, zr), T(0));
            const T kp = ex(T(-0.5) * d2);
            const T gcol = t.glat[p][l];
            dal_m = fm(kp, gcol, dal_m);
            const T amat = kp * gcol * al;
            part[p * DXU + DXU - 1] += amat;
#pragma unroll
            for (int i = 0; i < DXU - 1; ++i) {
              part[p * DXU + i] = fm(amat, zr[i], part[p * DXU + i]);
              dz[i] = fm(amat, esr[i] - zr[i], dz[i]);
            }
          }
        }
        dal_b[l * n.Mp + m] += dal_m;
        for (int i = 0; i < n.De; ++i) dzp_b[((size_t)l * n.Mp + m) * n.De + i] += dz[i];
      }
      const T total = block_sum(part, red);
      if (tid < NV) vec[tid / DXU][tid % DXU] = total;
      __syncthreads();
      if (tid < np) {
        const int p = tid;
        const T row_a = vec[p][DXU - 1];
        for (int i = 0; i < n.De; ++i) {
          const T ges = vec[p][i] - t.es[p][l][i] * row_a;  // dL / d(e il_l)
          ge[p][i] = fm(ges, o.ilp[l * n.De + i], ge[p][i]);
          dilp_p[p][l][i] = fm(ges, t.xu[p][i], dilp_p[p][l][i]);
        }
      }
      __syncthreads();
    }

    // the carried adjoint through the encoder at x_t
    if (tid < np) {
      T gg[kMaxD];
      for (int d = 0; d < n.D; ++d) gg[d] = g1[tid][d];
      encode_bwd(n, t.x[tid], ge[tid], gg);
      for (int d = 0; d < n.D; ++d) g[tid][d] = gg[d];
    }
    __syncthreads();
  }

  // the block's dilp, its particles summed in a fixed order
  for (int i = tid; i < n.Lp * n.De; i += kThreads) {
    const int l = i / n.De, j = i % n.De;
    T a = T(0);
    for (int p = 0; p < np; ++p) a += dilp_p[p][l][j];
    dilp_b[i] = a;
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

template <typename T>
int launch_bwd(const T* traj, const T* gl, const Ops<T>& o, Dims n, T* dzp, T* dal, T* dilp,
               void* stream) {
  if (bad_dims(n)) return (int)cudaErrorInvalidValue;
  n.tiles = (n.per + kTile - 1) / kTile;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = n.K * n.tiles;
  if (n.Dxu <= 8)
    bwd_kernel<T, 8><<<blocks, kThreads, 0, st>>>(traj, gl, o, n, dzp, dal, dilp);
  else
    bwd_kernel<T, 16><<<blocks, kThreads, 0, st>>>(traj, gl, o, n, dzp, dal, dilp);
  return (int)cudaGetLastError();
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
  extern "C" int rollout_bwd_##SFX(const T* traj, const T* gl, ROLLOUT_OPERANDS(T), T* dzp,   \
                                   T* dal, T* dilp, ROLLOUT_SCALARS, void* stream) {          \
    return launch_bwd<T>(traj, gl, ROLLOUT_OPS(T, nullptr), ROLLOUT_DIMS, dzp, dal, dilp,      \
                         stream);                                                              \
  }

ROLLOUT_ENTRIES(float, f32)
ROLLOUT_ENTRIES(double, f64)
