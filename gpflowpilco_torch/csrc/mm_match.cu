// Whole SVGP moment match for Hopper (sm_90a), float32 and float64.
//
// Replaces the TPU kernels of gpflowpilco_tpu/ops/mm_match_pallas.py:
//   svgp_match_fwd_{f32,f64}        <- _fwd_kernel (:624), launched by _fwd_call (:736)
//   svgp_match_bwd_frozen_{f32,f64} <- _bwd_kernel_frozen (:637), launched at :762
//   svgp_match_bwd_{f32,f64}        <- _bwd_kernel_full (:657), launched at :794
//
// Per batch entry n, with K = L + P groups (L latents, P = L(L+1)/2 latent
// pairs) and A_k = S + diag(kdiag_k) = ch_k ch_k^T:
//   latent l: y = ch^{-1}(z_m - mx), e_m = var_l exp(hll_l - hls_l - |y|^2/2),
//             iv = ch^{-T} y; f1_l = sum_m alpha_m e_m, cross[:, l] = sum_m iv alpha_m e_m
//   pair p:   up = ch^{-1}(u_m) - ch^{-1}mx/2, wp likewise, a_u = g11 + |up|^2, ...,
//             E(i,j) = exp(cexp_p - M_p(i,j)), M_p = -g1_i.g2_j + up_i.wp_j + a_u/2 + a_w/2,
//             f2_p = alpha_u^T E alpha_w, ecov_l = sum Q_l o E (diagonal pairs)
//   sff = f2 - f1 f1^T + diag(var - ecov)
// The backward is the hand adjoint of mm_match_pallas._bwd_core (:386-566):
// the adjoint of each recurrence is the recurrence reversed, the Cholesky's
// by chol_rev (:207). The frozen variant gives (dmx, dsxx); the full one
// also every grid tensor's cotangent, summed over the batch.
//
// Bound on an H100: at the MM drift's shape (N=1, L=4, P=10, D=6, M=240) a
// forward must read the grid, dominated by qmat (4 x 240^2 x 4 B = 0.9 MB in
// float32, 0.3 us at 3.35 TB/s), and does ~10 x 240^2 x (4D + 8) ~ 18 MFLOP
// plus 576 k exp, ~0.3 us at 67 TFLOP/s; the frozen backward ~0.5 us. Far
// below a launch: the kernels are latency-bound, and what sets their time
// is how much of the card works at once and how long each block's chain of
// dependent steps is.
//
// Forward and frozen backward (the drift's entries on the whole-match path):
// the pair grid is cut into tiles of kTI x kTJ cells (64 x 64: 4 x 4 tiles
// per pair at M=240) that ride the block grid with the batch, (L + P x tiles,
// N) blocks in the forward and (P x tiles, N) in the frozen backward: 164 and
// 160 blocks at the drift's shape, where one block per group (14) ran before.
// A tile block factors its group's D x D matrix (thread 0: a few hundred
// dependent operations at D=6), solves and stages only its tile's kTI rows
// (up, g1, a_u/2, alpha_u) and kTJ columns (wp, g2, a_w/2, alpha_w) in shared
// memory, and its 16 x 16 threads each evaluate a micro-tile of kTI/16 x
// kTJ/16 cells (rows ty + 16a, columns tx + 16b), reading each row and column
// factor once per micro-tile and not once per cell. On diagonal pairs under
// uncertainty the block issues cp.async copies of its tile of qmat into
// shared memory before it factors and waits for them only before the Q o E
// contraction, so the only sizeable bytes the kernels read arrive while the
// exps run. Ragged edges (M not a multiple of the tile) are masked: a row or
// column beyond M stages a_u/2 = +inf (so E = 0 there), zero weights and a
// zero-filled Q. The forward's tile blocks write their two partial sums
// (alpha-weighted f2, sum Q o E) to scratch, and a combine launch (one block
// per batch entry) adds each pair's tiles in a fixed order and forms sff;
// the latent blocks write f1 and cross. The frozen backward evaluates each
// cell of E once: a tile block writes per-row (sum_j e dE, sum_j e dE wp_j)
// and per-column (sum_i e dE, sum_i e dE up_i) partials, 1 + D values per
// point and tile, with dE = df2 alpha_u,i alpha_w,j + decov q_ij (rows reduced
// by shuffles within 16 lanes, columns by a shuffle and a fixed-order pass
// over the warps); a finish launch, one block per group and batch entry,
// adds each point's partials over the tiles in a fixed order and runs the
// post-sweep adjoint (the solves, the dch outer products, tmp_m and
// chol_rev), the latent groups as before; a third launch sums the groups,
// one thread per output entry. Against the one-block-per-group design this
// repairs: too few blocks (14 on 132 SMs), the serial walk of each thread
// over a whole row or column of E with a dependent global Q load per step,
// E evaluated twice in the backward (a row and a column pass), and a
// one-thread sum over the groups. The D x D factor work stays on
// thread 0: per block it is a few microseconds, overlapped by the Q copies.
// No tensor cores: the exponent's contraction is only 2D = 12 deep, the
// only float32 tensor-core path is TF32, whose 10-bit mantissa would put
// ~1e-3 relative error into exponents that feed exp (the port keeps such
// sites out of TF32), and the exps and reductions, not the products, set
// the time.
//
// Full backward (the policy's, at M=30, with the 8 members of an HMC
// ensemble as its batch): one block of 256 threads per group and batch
// entry, (K, N) blocks, 16 at the ensemble policy's shape where one block
// per group walked the batch in turn (2 blocks). Thread 0 factors the
// block's D x D matrix; each thread then owns columns m of the inducing
// points (latent groups) or rows or columns of the M x M exp grid (pair
// groups), staged whole in dynamic shared memory ((4D + 4) x M values), and
// sweeps E once by rows, on threads [0, 128), and at the same time once by
// columns, on threads [128, 256): the row sums (da_u, dup, dg1t, dalpha_u)
// and column sums (da_w, dwp, dg2t, dalpha_w) each belong to one thread (at
// M = 30 one pass at a time left 226 of the 256 threads idle). Each block
// writes its grid cotangents to its batch entry's slot of a scratch of N x
// the grid's size; a second launch, one thread per grid value, adds the
// slots in the order n = 0..N-1 (at N = 1 the blocks write the cotangents
// in place and that launch is skipped).
//
// Register vectors of D values loop over a capacity DM in {8, 16}, guarded
// by the runtime D, unrolled at DM = 8. Block sums go through warp shuffles
// and one fixed-order pass over the warps. No atomics: repeated runs are
// bit-identical. Full-precision exp and log (no fast math).
//
// Each entry returns cudaGetLastError() as an int; the caller raises on
// nonzero. Entries launch on the given stream and do not synchronise. The
// scratch the wrapper allocates: the forward's `scratch`, 2 values per pair,
// tile and batch entry; both backwards' `gda` and `gdmx`, the groups'
// cotangents (N x K x D x D and N x K x D); the frozen backward's row and
// column tile partials `rp` and `cq` (N x P x ceil(M / 64) x (1 + D) x M
// each); the full backward's `slots`, N x grid_elems values when N > 1
// (grid_elems: 0.30 M values at the drift's shape L=4, D=6, M=240, 1813 at
// the policy's L=1, D=5, M=30). The full backward's grid cotangents are
// one flat buffer, `dgrid`, in GRID_FIELDS order (grid_grad_at).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = kThreads / 2;  // the full backward's row and column halves
constexpr int kMaxD = 16;
constexpr int kMaxNV = kMaxD * (kMaxD + 1) / 2 + kMaxD + 2;  // most values one block sums

// The forward's and frozen backward's tile of a pair's M x M grid: kTI rows
// (i, the u side) by kTJ columns (j, the w side); a thread of the 16 x 16
// block owns kRI x kRJ cells. 64 x 64 was the fastest of 64 x 64, 32 x 64
// and 32 x 32 at the drift's shape (PERF.md); ops/mm_match_cuda.py sizes
// the scratch for it (TILE).
constexpr int kTI = 64;
constexpr int kTJ = 64;
constexpr int kRI = kTI / 16;
constexpr int kRJ = kTJ / 16;
static_assert(kThreads == 256, "a tile block is 16 x 16 threads");

// A loop of DM or fewer trips over a register capacity DM: fully unrolled at
// DM = 8, the path's capacity, so every index is a constant; a runtime loop
// at DM = 16 (D in 9..16, on no path), whose arrays live in local memory
// either way and whose full unrolling made most of the build time. The trip
// counts are constant (triangular loops carry a guard instead), so that
// "unroll (DM)" is a full unroll whatever order the compiler unrolls in.
#define UNROLL_DM _Pragma("unroll (DM <= 8 ? DM : 1)")

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float sq(float x) { return sqrtf(x); }
__device__ __forceinline__ double sq(double x) { return sqrt(x); }

__host__ __device__ constexpr int tri(int a, int b) { return a * (a + 1) / 2 + b; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__device__ __forceinline__ void set_inf(float& x) { x = __int_as_float(0x7f800000); }
__device__ __forceinline__ void set_inf(double& x) { x = __longlong_as_double(0x7ff0000000000000LL); }

// One element from global into shared memory by cp.async (no register
// holds it; the copy runs while the block computes), zero-filled where
// !valid. The #else branch is what a host compiler sees.
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
__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Grid tensors, unpadded, in GRID_FIELDS order (ops/mm_match_cuda.py).
template <typename T>
struct Grid {
  const T *kdiag, *zt, *alpha, *varr, *hll, *qmat, *ut, *wt, *g1t, *g2t, *g11, *g22, *cp,
      *alpha_u, *alpha_w;
};

template <typename T>
struct GridGrad {
  T *kdiag, *zt, *alpha, *varr, *hll, *qmat, *ut, *wt, *g1t, *g2t, *g11, *g22, *cp, *alpha_u,
      *alpha_w;
};

struct Dims {
  int N, L, P, K, D, M;
  bool unc;
};

// Pair p -> latents (i, j), i <= j, in grid order; the index of pair (i, j).
__device__ __forceinline__ void pair_of(int p, int L, int& pi, int& pj) {
  int k = 0;
  for (int i = 0; i < L; ++i)
    for (int j = i; j < L; ++j, ++k)
      if (k == p) {
        pi = i;
        pj = j;
      }
}
__device__ __forceinline__ int pair_index(int i, int j, int L) {
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  return i * L - i * (i - 1) / 2 + (j - i);
}

// The full backward's grid cotangents, one flat buffer in GRID_FIELDS
// order (ops/mm_match_cuda.py makes its tensors views of it): the fields of
// a buffer that starts at base, and its length.
inline __host__ __device__ size_t grid_elems(const Dims& z) {
  const size_t dm = (size_t)z.D * z.M, m = z.M;
  return (size_t)z.K * z.D + z.L * (dm + m + 2 + m * m) + z.P * (4 * dm + 4 * m + 1);
}
template <typename T>
inline GridGrad<T> grid_grad_at(T* base, const Dims& z) {
  const size_t dm = (size_t)z.D * z.M, m = z.M;
  GridGrad<T> g;
  g.kdiag = base;
  g.zt = g.kdiag + (size_t)z.K * z.D;
  g.alpha = g.zt + z.L * dm;
  g.varr = g.alpha + z.L * m;
  g.hll = g.varr + z.L;
  g.qmat = g.hll + z.L;
  g.ut = g.qmat + z.L * m * m;
  g.wt = g.ut + z.P * dm;
  g.g1t = g.wt + z.P * dm;
  g.g2t = g.g1t + z.P * dm;
  g.g11 = g.g2t + z.P * dm;
  g.g22 = g.g11 + z.P * m;
  g.cp = g.g22 + z.P * m;
  g.alpha_u = g.cp + z.P;
  g.alpha_w = g.alpha_u + z.P * m;
  return g;
}

// Sum NV per-thread values over the block into out[NV] (shared). Fixed
// order: shuffles within each warp, then warps in order.
template <typename T, int NV>
__device__ __forceinline__ void block_sum(const T (&v)[NV], T* red, T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    T x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp * NV + k] = x;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NV; k += kThreads) {
    T s = T(0);
    for (int w = 0; w < kWarps; ++w) s += red[w * NV + k];
    out[k] = s;
  }
  __syncthreads();
}

// Thread 0: ch (DM x DM, row-major, zero above the diagonal and beyond d) =
// chol(S + diag(kd)); returns sum log ch_ii. The recurrence of _chol_unrolled.
template <typename T, int DM>
__device__ T chol(const T* S, const T* kd, T* ch, int d) {
  for (int i = 0; i < DM * DM; ++i) ch[i] = T(0);
  for (int j = 0; j < d; ++j) {
    T s = S[j * d + j] + kd[j];
    for (int k = 0; k < j; ++k) s -= ch[j * DM + k] * ch[j * DM + k];
    ch[j * DM + j] = sq(s);
    const T inv = T(1) / ch[j * DM + j];
    for (int i = j + 1; i < d; ++i) {
      T t = S[i * d + j];
      for (int k = 0; k < j; ++k) t -= ch[i * DM + k] * ch[j * DM + k];
      ch[i * DM + j] = t * inv;
    }
  }
  T hls = T(0);
  for (int i = 0; i < d; ++i) hls += lg(ch[i * DM + i]);
  return hls;
}

// b <- ch^{-1} b
template <typename T, int DM>
__device__ __forceinline__ void lsolve(const T* ch, T (&b)[DM], int d) {
UNROLL_DM
  for (int i = 0; i < DM; ++i) {
    if (i < d) {
      T a = b[i];
UNROLL_DM
      for (int j = 0; j < DM; ++j)
        if (j < i) a -= ch[i * DM + j] * b[j];
      b[i] = a / ch[i * DM + i];
    }
  }
}

// b <- ch^{-T} b
template <typename T, int DM>
__device__ __forceinline__ void utsolve(const T* ch, T (&b)[DM], int d) {
UNROLL_DM
  for (int i = DM - 1; i >= 0; --i) {
    if (i < d) {
      T a = b[i];
UNROLL_DM
      for (int j = 0; j < DM; ++j)
        if (j > i && j < d) a -= ch[j * DM + i] * b[j];
      b[i] = a / ch[i * DM + i];
    }
  }
}

// Thread 0: the lower-triangle cotangent da of the factored matrix from the
// factor's cotangent dl (destroyed); mm_match_pallas._chol_rev.
template <typename T, int DM>
__device__ void chol_rev(const T* ch, T* dl, T* da, int d) {
  for (int i = 0; i < DM * DM; ++i) da[i] = T(0);
  for (int j = d - 1; j >= 0; --j) {
    const T inv = T(1) / ch[j * DM + j];
    for (int i = d - 1; i > j; --i) {
      const T gi = dl[i * DM + j] * inv;
      da[i * DM + j] += gi;
      dl[j * DM + j] -= gi * ch[i * DM + j];
      for (int k = 0; k < j; ++k) {
        dl[i * DM + k] -= gi * ch[j * DM + k];
        dl[j * DM + k] -= gi * ch[i * DM + k];
      }
    }
    const T s = T(0.5) * dl[j * DM + j] * inv;
    da[j * DM + j] += s;
    for (int k = 0; k < j; ++k) dl[j * DM + k] -= T(2) * s * ch[j * DM + k];
  }
}

template <typename T, int DM>
struct Shared {
  T ch[DM * DM];
  T dl[DM * DM];
  T da[DM * DM];
  T ilm[DM];
  T red[kWarps * kMaxNV];
  T out[kMaxNV];
  T hls, cexp;
};

// Thread 0: factor pair p's matrix and solve for ilm = ch^{-1} mx; cexp.
template <typename T, int DM>
__device__ void pair_factor(const Grid<T>& g, const Dims& z, int p, const T* mx, const T* S,
                            Shared<T, DM>& sh) {
  const int d = z.D;
  sh.hls = chol<T, DM>(S, g.kdiag + (size_t)(z.L + p) * d, sh.ch, d);
  T b[DM];
  for (int i = 0; i < DM; ++i) b[i] = i < d ? mx[i] : T(0);
  lsolve<T, DM>(sh.ch, b, d);
  for (int i = 0; i < DM; ++i) sh.ilm[i] = b[i];
  sh.cexp = g.cp[p] - sh.hls;
}

// Full-backward pair block: thread 0 factors and solves for ilm; then every
// thread stages its columns of up, wp, g1, g2, a_u, a_w, alpha_u, alpha_w.
template <typename T, int DM>
__device__ void pair_setup(const Grid<T>& g, const Dims& z, int p, const T* mx, const T* S,
                           Shared<T, DM>& sh, T* dyn) {
  const int d = z.D, M = z.M;
  if (threadIdx.x == 0) pair_factor<T, DM>(g, z, p, mx, S, sh);
  __syncthreads();
  T* up = dyn;
  T* wp = up + d * M;
  T* g1 = wp + d * M;
  T* g2 = g1 + d * M;
  T* au = g2 + d * M;
  T* aw = au + M;
  T* alu = aw + M;
  T* alw = alu + M;
  const size_t pdm = (size_t)p * d * M;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    T u[DM], w[DM];
UNROLL_DM
    for (int i = 0; i < DM; ++i) {
      u[i] = i < d ? g.ut[pdm + i * M + m] : T(0);
      w[i] = i < d ? g.wt[pdm + i * M + m] : T(0);
    }
    lsolve<T, DM>(sh.ch, u, d);
    lsolve<T, DM>(sh.ch, w, d);
    T a = g.g11[(size_t)p * M + m], b = g.g22[(size_t)p * M + m];
UNROLL_DM
    for (int i = 0; i < DM; ++i) {
      if (i < d) {
        const T ui = u[i] - T(0.5) * sh.ilm[i], wi = w[i] - T(0.5) * sh.ilm[i];
        a += ui * ui;
        b += wi * wi;
        up[i * M + m] = ui;
        wp[i * M + m] = wi;
        g1[i * M + m] = g.g1t[pdm + i * M + m];
        g2[i * M + m] = g.g2t[pdm + i * M + m];
      }
    }
    au[m] = a;
    aw[m] = b;
    alu[m] = g.alpha_u[(size_t)p * M + m];
    alw[m] = g.alpha_w[(size_t)p * M + m];
  }
  __syncthreads();
}

// E(i, j) of the staged pair, with row i's factors in registers.
template <typename T, int DM>
__device__ __forceinline__ T pair_e(const T (&g1i)[DM], const T (&upi)[DM], T aui, const T* g2,
                                    const T* wp, const T* aw, int j, int d, int M, T cexp) {
  T dot = T(0), uw = T(0);
UNROLL_DM
  for (int k = 0; k < DM; ++k)
    if (k < d) {
      dot += g1i[k] * g2[k * M + j];
      uw += upi[k] * wp[k * M + j];
    }
  const T mp = -dot + uw + T(0.5) * aui + T(0.5) * aw[j];
  return ex(cexp - mp);
}

// ---------------------------------------------------------------- pair tiles
// A tile block's dynamic shared memory, laid out from its start: Q's tile
// (kTI x kTJ), the rows' g1 and up (d x kTI each), a_u/2 and alpha_u (kTI
// each), the columns' g2 and wp (d x kTJ), a_w/2 and alpha_w (kTJ); the
// frozen backward adds its column partials per warp ((1 + d) x kWarps x kTJ).
template <typename T>
struct TileSmem {
  T *q, *g1, *up, *hu, *alu, *g2, *wp, *hw, *alw, *cred;
  __device__ TileSmem(T* base, int d) {
    q = base;
    g1 = q + kTI * kTJ;
    up = g1 + d * kTI;
    hu = up + d * kTI;
    alu = hu + kTI;
    g2 = alu + kTI;
    wp = g2 + d * kTJ;
    hw = wp + d * kTJ;
    alw = hw + kTJ;
    cred = alw + kTJ;
  }
};

inline size_t tile_smem_elems(int d, bool bwd) {
  return (size_t)kTI * kTJ + (size_t)(2 * d + 2) * (kTI + kTJ) +
         (bwd ? (size_t)(d + 1) * kWarps * kTJ : 0);
}

// Tile setup for pair p, rows [i0, i0 + kTI) and columns [j0, j0 + kTJ):
// start the cp.async copies of Q's tile (diagonal pairs under uncertainty),
// factor on thread 0, then solve and stage the tile's rows and columns. A
// row or column beyond M stages zeros and a_u/2 (a_w/2) = +inf, so that its
// cells of E are exp(-inf) = 0. Ends with a barrier; the Q copies may still
// be in flight (tile_wait_q).
template <typename T, int DM>
__device__ __forceinline__ void tile_setup(const Grid<T>& g, const Dims& z, int p, int i0, int j0, bool qd,
                           const T* mx, const T* S, Shared<T, DM>& sh, const TileSmem<T>& ts) {
  const int d = z.D, M = z.M;
  if (qd) {
    int pi = 0, pj = 0;
    pair_of(p, z.L, pi, pj);
    const T* q = g.qmat + (size_t)pi * M * M;
    for (int c = threadIdx.x; c < kTI * kTJ; c += kThreads) {
      const int i = i0 + c / kTJ, j = j0 + c % kTJ;
      const bool valid = i < M && j < M;
      cp_async_elem(ts.q + c, valid ? q + (size_t)i * M + j : q, valid);
    }
    cp_async_commit();
  }
  if (threadIdx.x == 0) pair_factor<T, DM>(g, z, p, mx, S, sh);
  __syncthreads();
  const size_t pdm = (size_t)p * d * M;
  for (int r = threadIdx.x; r < kTI + kTJ; r += kThreads) {
    const bool row = r < kTI;
    const int c = row ? r : r - kTI, m = row ? i0 + c : j0 + c, stride = row ? kTI : kTJ;
    const T* src = row ? g.ut : g.wt;
    const T* gsrc = row ? g.g1t : g.g2t;
    T* dst_g = row ? ts.g1 : ts.g2;
    T* dst_u = row ? ts.up : ts.wp;
    if (m < M) {
      T u[DM];
UNROLL_DM
      for (int i = 0; i < DM; ++i) u[i] = i < d ? src[pdm + i * M + m] : T(0);
      lsolve<T, DM>(sh.ch, u, d);
      T a = (row ? g.g11 : g.g22)[(size_t)p * M + m];
UNROLL_DM
      for (int i = 0; i < DM; ++i) {
        if (i < d) {
          const T ui = u[i] - T(0.5) * sh.ilm[i];
          a += ui * ui;
          dst_u[i * stride + c] = ui;
          dst_g[i * stride + c] = gsrc[pdm + i * M + m];
        }
      }
      (row ? ts.hu : ts.hw)[c] = T(0.5) * a;
      (row ? ts.alu : ts.alw)[c] = (row ? g.alpha_u : g.alpha_w)[(size_t)p * M + m];
    } else {
      for (int i = 0; i < d; ++i) dst_u[i * stride + c] = dst_g[i * stride + c] = T(0);
      set_inf((row ? ts.hu : ts.hw)[c]);
      (row ? ts.alu : ts.alw)[c] = T(0);
    }
  }
  __syncthreads();
}

// Every thread's kRI x kRJ cells of E: rows ty + 16a, columns tx + 16b.
template <typename T>
__device__ __forceinline__ void tile_cells(const TileSmem<T>& ts, int d, T cexp, T (&e)[kRI][kRJ]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < kRI; ++a)
#pragma unroll
    for (int b = 0; b < kRJ; ++b) e[a][b] = T(0);
  for (int k = 0; k < d; ++k) {
    T r1[kRI], ru[kRI], c2[kRJ], cw[kRJ];
#pragma unroll
    for (int a = 0; a < kRI; ++a) {
      r1[a] = ts.g1[k * kTI + ty + 16 * a];
      ru[a] = ts.up[k * kTI + ty + 16 * a];
    }
#pragma unroll
    for (int b = 0; b < kRJ; ++b) {
      c2[b] = ts.g2[k * kTJ + tx + 16 * b];
      cw[b] = ts.wp[k * kTJ + tx + 16 * b];
    }
#pragma unroll
    for (int a = 0; a < kRI; ++a)
#pragma unroll
      for (int b = 0; b < kRJ; ++b) e[a][b] += ru[a] * cw[b] - r1[a] * c2[b];
  }
#pragma unroll
  for (int a = 0; a < kRI; ++a)
#pragma unroll
    for (int b = 0; b < kRJ; ++b)
      e[a][b] = ex(cexp - (e[a][b] + ts.hu[ty + 16 * a] + ts.hw[tx + 16 * b]));
}

// Wait for this block's Q copies and make every thread's visible.
__device__ __forceinline__ void tile_wait_q() {
  cp_async_wait_all();
  __syncthreads();
}

// ---------------------------------------------------------------- forward
// Latent block l of batch entry n: eKfu and the premultiplied cross.
template <typename T, int DM>
__device__ void latent_fwd(const Grid<T>& g, const Dims& z, int l, int n, const T* mx,
                           const T* S, Shared<T, DM>& sh, T* f1, T* cross) {
  const int d = z.D, M = z.M;
  if (threadIdx.x == 0) sh.hls = chol<T, DM>(S, g.kdiag + (size_t)l * d, sh.ch, d);
  __syncthreads();
  const T lead = g.hll[l] - sh.hls, var = g.varr[l];
  T v[DM + 1];
#pragma unroll
  for (int i = 0; i <= DM; ++i) v[i] = T(0);
  for (int m = threadIdx.x; m < M; m += kThreads) {
    T y[DM];
UNROLL_DM
    for (int i = 0; i < DM; ++i) y[i] = i < d ? g.zt[((size_t)l * d + i) * M + m] - mx[i] : T(0);
    lsolve<T, DM>(sh.ch, y, d);
    T quad = y[0] * y[0];
UNROLL_DM
    for (int i = 1; i < DM; ++i)
      if (i < d) quad += y[i] * y[i];
    const T e = var * ex(lead - T(0.5) * quad);
    utsolve<T, DM>(sh.ch, y, d);  // y is now iv
    const T ae = g.alpha[(size_t)l * M + m] * e;
    v[0] += ae;
UNROLL_DM
    for (int i = 0; i < DM; ++i) v[1 + i] += y[i] * ae;
  }
  block_sum<T, DM + 1>(v, sh.red, sh.out);
  if (threadIdx.x == 0) {
    f1[(size_t)n * z.L + l] = sh.out[0];
    for (int i = 0; i < d; ++i) cross[((size_t)n * d + i) * z.L + l] = sh.out[1 + i];
  }
}

// Blocks (L + P x tiles, N): the latent blocks first, then pair p's tile t
// (row tile t / ntj, column tile t % ntj), which writes its (sum alpha_u E
// alpha_w, sum Q o E) to scratch[n][p][t].
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) svgp_fwd_tiles(Grid<T> g, Dims z, const T* __restrict__ mx_,
                                                            const T* __restrict__ sxx, T* __restrict__ f1,
                                                            T* __restrict__ cross, T* __restrict__ scratch) {
  __shared__ Shared<T, DM> sh;
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  const int n = blockIdx.y, d = z.D, M = z.M;
  const T* mx = mx_ + (size_t)n * d;
  const T* S = sxx + (size_t)n * d * d;
  if ((int)blockIdx.x < z.L) {
    latent_fwd<T, DM>(g, z, blockIdx.x, n, mx, S, sh, f1, cross);
    return;
  }
  const int ntj = cdiv(M, kTJ), nt = cdiv(M, kTI) * ntj;
  const int p = (blockIdx.x - z.L) / nt, t = (blockIdx.x - z.L) % nt;
  int pi = 0, pj = 0;
  pair_of(p, z.L, pi, pj);
  const bool qd = z.unc && pi == pj;
  const TileSmem<T> ts(reinterpret_cast<T*>(dyn_raw), d);
  tile_setup<T, DM>(g, z, p, (t / ntj) * kTI, (t % ntj) * kTJ, qd, mx, S, sh, ts);
  T e[kRI][kRJ];
  tile_cells<T>(ts, d, sh.cexp, e);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  T v[2] = {T(0), T(0)};
#pragma unroll
  for (int a = 0; a < kRI; ++a) {
    T r = T(0);
#pragma unroll
    for (int b = 0; b < kRJ; ++b) r += e[a][b] * ts.alw[tx + 16 * b];
    v[0] += ts.alu[ty + 16 * a] * r;
  }
  if (qd) {
    tile_wait_q();
#pragma unroll
    for (int a = 0; a < kRI; ++a)
#pragma unroll
      for (int b = 0; b < kRJ; ++b) v[1] += ts.q[(ty + 16 * a) * kTJ + tx + 16 * b] * e[a][b];
  }
  block_sum<T, 2>(v, sh.red, sh.out);
  if (threadIdx.x == 0) {
    T* sc = scratch + (((size_t)n * z.P + p) * nt + t) * 2;
    sc[0] = sh.out[0];
    sc[1] = sh.out[1];
  }
}

// One block per batch entry: each pair's tiles added in order, then sff.
// Entries (a, b) and (b, a) add the same values in the same order, so sff
// is exactly symmetric.
template <typename T>
__global__ void svgp_fwd_combine(const T* __restrict__ varr, const T* __restrict__ f1,
                                 const T* __restrict__ scratch, T* __restrict__ sff, Dims z) {
  const int n = blockIdx.x, L = z.L;
  const int nt = cdiv(z.M, kTI) * cdiv(z.M, kTJ);
  const T* f = f1 + (size_t)n * L;
  const T* sc = scratch + (size_t)n * z.P * nt * 2;
  for (int ab = threadIdx.x; ab < L * L; ab += blockDim.x) {
    const int a = ab / L, b = ab % L;
    const T* s2 = sc + (size_t)pair_index(a, b, L) * nt * 2;
    T f2 = T(0);
    for (int t = 0; t < nt; ++t) f2 += s2[2 * t];
    T s = f2 - f[a] * f[b];
    if (z.unc && a == b) {
      T ecov = T(0);
      for (int t = 0; t < nt; ++t) ecov += s2[2 * t + 1];
      s += varr[a] - ecov;
    }
    sff[((size_t)n * L + a) * L + b] = s;
  }
}

// ---------------------------------------------------------------- backward
// Thread 0, after a group's block sums: finish dch (diagonal term), run the
// Cholesky adjoint and write the group's da (lower) to gda.
template <typename T, int DM>
__device__ void finish_group(Shared<T, DM>& sh, const T* pc_sum, T dhls, T* gda_nk, int d) {
  for (int i = 0; i < DM * DM; ++i) sh.dl[i] = T(0);
  for (int a = 0; a < d; ++a)
    for (int b = 0; b <= a; ++b) sh.dl[a * DM + b] = pc_sum[tri(a, b)];
  for (int i = 0; i < d; ++i) sh.dl[i * DM + i] += dhls / sh.ch[i * DM + i];
  chol_rev<T, DM>(sh.ch, sh.dl, sh.da, d);
  for (int a = 0; a < d; ++a)
    for (int b = 0; b < d; ++b) gda_nk[a * d + b] = b <= a ? sh.da[a * DM + b] : T(0);
}

// Latent block l of batch entry n: the group's da and dmx share (and, FULL,
// entry n's latent grid cotangents, written to dg at offset o).
template <typename T, int DM, bool FULL>
__device__ void latent_bwd(const Grid<T>& g, const GridGrad<T>& dg, size_t o, const Dims& z, int l, int n,
                           const T* mx, const T* S, const T* dsff, const T* f1_, const T* df1_,
                           const T* dcross_, T* gda_nk, T* gdmx_nk, Shared<T, DM>& sh) {
  constexpr int NT = DM * (DM + 1) / 2;
  constexpr int NV = NT + DM + 2;
  const int k = l, d = z.D, M = z.M, L = z.L;
  T v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = T(0);
  if (threadIdx.x == 0) sh.hls = chol<T, DM>(S, g.kdiag + (size_t)l * d, sh.ch, d);
  __syncthreads();
  const T lead = g.hll[l] - sh.hls, var = g.varr[l];
  const T* f1 = f1_ + (size_t)n * L;
  T df1 = df1_[(size_t)n * L + l];
  T corr = T(0);
  for (int j = 0; j < L; ++j) corr += (dsff[l * L + j] + dsff[j * L + l]) * f1[j];
  df1 -= corr;
  T dcr[DM];
UNROLL_DM
  for (int i = 0; i < DM; ++i) dcr[i] = i < d ? dcross_[((size_t)n * d + i) * L + l] : T(0);
  // v: [0, NT) dch partials, [NT, NT + DM) dmx, NT + DM: sum ede, NT + DM + 1: dvarr_lat
  for (int m = threadIdx.x; m < M; m += kThreads) {
    T y[DM], iv[DM];
UNROLL_DM
    for (int i = 0; i < DM; ++i) y[i] = i < d ? g.zt[((size_t)l * d + i) * M + m] - mx[i] : T(0);
    lsolve<T, DM>(sh.ch, y, d);
    T quad = y[0] * y[0];
UNROLL_DM
    for (int i = 1; i < DM; ++i)
      if (i < d) quad += y[i] * y[i];
    const T e = var * ex(lead - T(0.5) * quad);
UNROLL_DM
    for (int i = 0; i < DM; ++i) iv[i] = y[i];
    utsolve<T, DM>(sh.ch, iv, d);
    const T al = g.alpha[(size_t)l * M + m];
    const T ae = al * e;
    T dae = df1;
UNROLL_DM
    for (int i = 0; i < DM; ++i) dae += dcr[i] * iv[i];
    const T de = al * dae;
    const T ede = e * de;
    const T dquad = T(-0.5) * ede;
    v[NT + DM] += ede;
    if (FULL) {
      v[NT + DM + 1] += de * (e / var);
      dg.alpha[o + (size_t)l * M + m] = dae * e;
    }
    T t[DM];
UNROLL_DM
    for (int i = 0; i < DM; ++i) t[i] = dcr[i] * ae;
    lsolve<T, DM>(sh.ch, t, d);
    T dz[DM];
UNROLL_DM
    for (int i = 0; i < DM; ++i) dz[i] = T(2) * y[i] * dquad + t[i];
UNROLL_DM
    for (int a = 0; a < DM; ++a)
UNROLL_DM
      for (int b = 0; b < DM; ++b)
        if (b <= a) v[tri(a, b)] -= t[b] * iv[a];
    utsolve<T, DM>(sh.ch, dz, d);
UNROLL_DM
    for (int a = 0; a < DM; ++a) {
UNROLL_DM
      for (int b = 0; b < DM; ++b)
        if (b <= a) v[tri(a, b)] -= dz[a] * y[b];
      v[NT + a] -= dz[a];
      if (FULL && a < d) dg.zt[o + ((size_t)l * d + a) * M + m] = dz[a];
    }
  }
  block_sum<T, NV>(v, sh.red, sh.out);
  if (threadIdx.x == 0) {
    const T s_ede = sh.out[NT + DM];
    finish_group<T, DM>(sh, sh.out, -s_ede, gda_nk, d);
    for (int i = 0; i < d; ++i) gdmx_nk[i] = sh.out[NT + i];
    if (FULL) {
      for (int a = 0; a < d; ++a) dg.kdiag[o + (size_t)k * d + a] = sh.da[a * DM + a];
      dg.hll[o + l] = s_ede;
      dg.varr[o + l] = sh.out[NT + DM + 1] + (z.unc ? dsff[l * L + l] : T(0));
    }
  }
  __syncthreads();
}

// Pair p's cotangent weights: df2 on alpha_u E alpha_w, decov on Q o E.
template <typename T>
__device__ __forceinline__ void pair_cots(const Dims& z, int pi, int pj, const T* dsff, T& df2,
                                          T& decov) {
  const int L = z.L;
  const bool diag = pi == pj;
  df2 = dsff[pi * L + pj] + (diag ? T(0) : dsff[pj * L + pi]);
  decov = z.unc && diag ? -dsff[pi * L + pi] : T(0);
}

// Frozen backward, stage 1. Blocks (P x tiles, N): pair p's tile t writes,
// for each of its rows i, rp[n][p][t % ntj][c][i] and, for each of its
// columns j, cq[n][p][t / ntj][c][j], c in [0, d]: with ede = E dE,
//   rp: c = 0 sum_j ede, c >= 1 sum_j ede wp_j[c - 1];
//   cq: c = 0 sum_i ede, c >= 1 sum_i ede up_i[c - 1].
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) svgp_bwd_tiles(Grid<T> g, Dims z, const T* __restrict__ mx_,
                                                            const T* __restrict__ sxx,
                                                            const T* __restrict__ dsff_, T* __restrict__ rp,
                                                            T* __restrict__ cq) {
  __shared__ Shared<T, DM> sh;
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  const int n = blockIdx.y, d = z.D, M = z.M;
  const int nti = cdiv(M, kTI), ntj = cdiv(M, kTJ), nt = nti * ntj;
  const int p = blockIdx.x / nt, t = blockIdx.x % nt, ti = t / ntj, tj = t % ntj;
  const int i0 = ti * kTI, j0 = tj * kTJ;
  const T* mx = mx_ + (size_t)n * d;
  const T* S = sxx + (size_t)n * d * d;
  int pi = 0, pj = 0;
  pair_of(p, z.L, pi, pj);
  const bool qd = z.unc && pi == pj;
  const TileSmem<T> ts(reinterpret_cast<T*>(dyn_raw), d);
  tile_setup<T, DM>(g, z, p, i0, j0, qd, mx, S, sh, ts);
  T e[kRI][kRJ];
  tile_cells<T>(ts, d, sh.cexp, e);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5;
  T df2, decov;
  pair_cots<T>(z, pi, pj, dsff_ + (size_t)n * z.L * z.L, df2, decov);
  if (qd) tile_wait_q();
#pragma unroll
  for (int a = 0; a < kRI; ++a)
#pragma unroll
    for (int b = 0; b < kRJ; ++b) {
      T de = df2 * (ts.alu[ty + 16 * a] * ts.alw[tx + 16 * b]);
      if (qd) de += decov * ts.q[(ty + 16 * a) * kTJ + tx + 16 * b];
      e[a][b] *= de;  // e dE from here on
    }
  const size_t np = (size_t)n * z.P + p;
  T* rpt = rp + ((np * ntj + tj) * (d + 1)) * M;
  for (int c = 0; c <= d; ++c) {
    // rows: this thread's columns, then the 16 lanes of its row (xor
    // shuffles stay within a half-warp); lane tx = 0 writes
    T w[kRJ];
#pragma unroll
    for (int b = 0; b < kRJ; ++b) w[b] = c == 0 ? T(1) : ts.wp[(c - 1) * kTJ + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < kRI; ++a) {
      T s = T(0);
#pragma unroll
      for (int b = 0; b < kRJ; ++b) s += e[a][b] * w[b];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const int i = i0 + ty + 16 * a;
      if (tx == 0 && i < M) rpt[(size_t)c * M + i] = s;
    }
    // columns: this thread's rows, then the warp's two rows of threads
    T u[kRI];
#pragma unroll
    for (int a = 0; a < kRI; ++a) u[a] = c == 0 ? T(1) : ts.up[(c - 1) * kTI + ty + 16 * a];
#pragma unroll
    for (int b = 0; b < kRJ; ++b) {
      T s = T(0);
#pragma unroll
      for (int a = 0; a < kRI; ++a) s += e[a][b] * u[a];
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 16) ts.cred[((size_t)c * kWarps + warp) * kTJ + tx + 16 * b] = s;
    }
  }
  __syncthreads();
  // columns: the warps in order
  T* cqt = cq + ((np * nti + ti) * (d + 1)) * M;
  for (int r = threadIdx.x; r < (d + 1) * kTJ; r += kThreads) {
    const int c = r / kTJ, col = r % kTJ;
    T s = T(0);
    for (int w = 0; w < kWarps; ++w) s += ts.cred[((size_t)c * kWarps + w) * kTJ + col];
    if (j0 + col < M) cqt[(size_t)c * M + j0 + col] = s;
  }
}

// Frozen backward, stage 2. Blocks (K, N): a latent group runs latent_bwd;
// pair p adds each point's tile partials in order and runs the adjoint
// that follows the sweep in _bwd_core (dup -> tmp_u, the dch outer
// products, the column twin, tmp_m), then finish_group.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) svgp_bwd_finish(
    Grid<T> g, Dims z, const T* __restrict__ mx_, const T* __restrict__ sxx, const T* __restrict__ f1_,
    const T* __restrict__ df1_, const T* __restrict__ dsff_, const T* __restrict__ dcross_,
    const T* __restrict__ rp, const T* __restrict__ cq, T* __restrict__ gda, T* __restrict__ gdmx) {
  __shared__ Shared<T, DM> sh;
  constexpr int NT = DM * (DM + 1) / 2;
  constexpr int NV = NT + DM + 2;
  const int k = blockIdx.x, n = blockIdx.y, d = z.D, M = z.M, L = z.L;
  const T* mx = mx_ + (size_t)n * d;
  const T* S = sxx + (size_t)n * d * d;
  const T* dsff = dsff_ + (size_t)n * L * L;
  T* gda_nk = gda + ((size_t)n * z.K + k) * d * d;
  T* gdmx_nk = gdmx + ((size_t)n * z.K + k) * d;
  if (k < L) {
    const GridGrad<T> none = {};
    latent_bwd<T, DM, false>(g, none, 0, z, k, n, mx, S, dsff, f1_, df1_, dcross_, gda_nk, gdmx_nk, sh);
    return;
  }
  const int p = k - L;
  const int nti = cdiv(M, kTI), ntj = cdiv(M, kTJ);
  if (threadIdx.x == 0) pair_factor<T, DM>(g, z, p, mx, S, sh);
  __syncthreads();
  T v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = T(0);
  // v: [0, NT) dch partials, [NT, NT + DM) dup + dwp sums, NT + DM: sum ede
  const size_t pdm = (size_t)p * d * M;
  const size_t np = (size_t)n * z.P + p;
  for (int r = threadIdx.x; r < 2 * M; r += kThreads) {
    const bool row = r < M;  // row i: da_u, dup; column j: da_w, dwp
    const int m = row ? r : r - M, ntl = row ? ntj : nti;
    const T* part = (row ? rp : cq) + np * ntl * (d + 1) * M + m;
    T il[DM], upm[DM], sum[DM + 1];
UNROLL_DM
    for (int c = 0; c < DM; ++c) il[c] = c < d ? (row ? g.ut : g.wt)[pdm + c * M + m] : T(0);
    lsolve<T, DM>(sh.ch, il, d);
UNROLL_DM
    for (int c = 0; c < DM; ++c) upm[c] = c < d ? il[c] - T(0.5) * sh.ilm[c] : T(0);
#pragma unroll
    for (int c = 0; c <= DM; ++c) sum[c] = T(0);
    for (int t = 0; t < ntl; ++t) {
#pragma unroll
      for (int c = 0; c <= DM; ++c)
        if (c <= d) sum[c] += part[((size_t)t * (d + 1) + c) * M];
    }
    const T da = T(-0.5) * sum[0];
    T dup[DM];
UNROLL_DM
    for (int c = 0; c < DM; ++c) dup[c] = c < d ? -sum[1 + c] + T(2) * upm[c] * da : T(0);
    if (row) v[NT + DM] += sum[0];
UNROLL_DM
    for (int c = 0; c < DM; ++c) v[NT + c] += dup[c];
    utsolve<T, DM>(sh.ch, dup, d);  // tmp_u (tmp_w)
UNROLL_DM
    for (int a = 0; a < DM; ++a)
UNROLL_DM
      for (int b = 0; b < DM; ++b)
        if (b <= a) v[tri(a, b)] -= dup[a] * il[b];
  }
  block_sum<T, NV>(v, sh.red, sh.out);
  if (threadIdx.x == 0) {
    T tm[DM];
    for (int i = 0; i < DM; ++i) tm[i] = i < d ? T(-0.5) * sh.out[NT + i] : T(0);
    utsolve<T, DM>(sh.ch, tm, d);  // tmp_m
    for (int a = 0; a < d; ++a)
      for (int b = 0; b <= a; ++b) sh.out[tri(a, b)] -= tm[a] * sh.ilm[b];
    finish_group<T, DM>(sh, sh.out, -sh.out[NT + DM], gda_nk, d);
    for (int i = 0; i < d; ++i) gdmx_nk[i] = tm[i];
  }
}

// Both backwards' last stage: one block per batch entry and one thread per
// entry of dmx and of dsxx's lower triangle, each adding the groups in
// order.
template <typename T>
__global__ void svgp_bwd_combine(const T* __restrict__ gda, const T* __restrict__ gdmx,
                                 T* __restrict__ dmx, T* __restrict__ dsxx, Dims z) {
  const int n = blockIdx.x, d = z.D;
  for (int r = threadIdx.x; r < d + d * (d + 1) / 2; r += blockDim.x) {
    T s = T(0);
    if (r < d) {
      for (int k = 0; k < z.K; ++k) s += gdmx[((size_t)n * z.K + k) * d + r];
      dmx[(size_t)n * d + r] = s;
      continue;
    }
    int a = 0, b = r - d;  // the (r - d)-th entry (a, b) of the lower triangle, by rows
    while (b > a) b -= ++a;
    for (int k = 0; k < z.K; ++k) s += gda[(((size_t)n * z.K + k) * d + a) * d + b];
    T* out = dsxx + (size_t)n * d * d;
    if (a == b) {
      out[a * d + a] = s;
    } else {
      out[a * d + b] = T(0.5) * s;
      out[b * d + a] = T(0.5) * s;
    }
  }
}

// Full backward, stage 1. Blocks (K, N): group k of batch entry n writes its
// da and dmx share to gda and gdmx and its grid cotangents to dg at offset
// n x slot: the entries' slots of a scratch of N x grid_elems values, or, at
// N = 1 (slot = 0), the cotangents themselves.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) bwd_groups(
    Grid<T> g, GridGrad<T> dg, size_t slot, Dims z, const T* __restrict__ mx_, const T* __restrict__ sxx,
    const T* __restrict__ f1_, const T* __restrict__ df1_, const T* __restrict__ dsff_,
    const T* __restrict__ dcross_, T* __restrict__ gda, T* __restrict__ gdmx) {
  __shared__ Shared<T, DM> sh;
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  T* dyn = reinterpret_cast<T*>(dyn_raw);
  constexpr int NT = DM * (DM + 1) / 2;
  constexpr int NV = NT + DM + 2;
  const int k = blockIdx.x, n = blockIdx.y, d = z.D, M = z.M, L = z.L;
  const size_t o = n * slot;
  const T* mx = mx_ + (size_t)n * d;
  const T* S = sxx + (size_t)n * d * d;
  const T* dsff = dsff_ + (size_t)n * L * L;
  T* gda_nk = gda + ((size_t)n * z.K + k) * d * d;
  T* gdmx_nk = gdmx + ((size_t)n * z.K + k) * d;

  if (k < L) {
    latent_bwd<T, DM, true>(g, dg, o, z, k, n, mx, S, dsff, f1_, df1_, dcross_, gda_nk, gdmx_nk, sh);
    return;
  }

  T v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = T(0);
  // pair p
  const int p = k - L;
  int pi = 0, pj = 0;
  pair_of(p, L, pi, pj);
  pair_setup<T, DM>(g, z, p, mx, S, sh, dyn);
  const T* up = dyn;
  const T* wp = up + d * M;
  const T* g1 = wp + d * M;
  const T* g2 = g1 + d * M;
  const T* au = g2 + d * M;
  const T* aw = au + M;
  const T* alu = aw + M;
  const T* alw = alu + M;
  const bool diag = pi == pj;
  const bool qd = z.unc && diag;
  const T* q = g.qmat + (size_t)pi * M * M;
  T df2, decov;
  pair_cots<T>(z, pi, pj, dsff, df2, decov);
  const T cexp = sh.cexp;
  const size_t pdm = (size_t)p * d * M;
  // v: [0, NT) dch partials, [NT, NT + DM) dup + dwp sums, NT + DM: sum ede

  // the row pass on threads [0, kHalf) and the column pass on [kHalf,
  // kThreads), at the same time; each thread's v holds its own pass's sums
  if (threadIdx.x < kHalf) {
    // row pass: thread i owns da_u[i], dup[:, i], dg1t[:, i], dalpha_u[i]
    for (int i = threadIdx.x; i < M; i += kHalf) {
      T g1i[DM], upi[DM], ilu[DM];
UNROLL_DM
      for (int c = 0; c < DM; ++c) {
        g1i[c] = c < d ? g1[c * M + i] : T(0);
        upi[c] = c < d ? up[c * M + i] : T(0);
        ilu[c] = c < d ? g.ut[pdm + c * M + i] : T(0);
      }
      const T aui = au[i], alui = alu[i];
      T rs = T(0), ea = T(0), accw[DM], accg[DM];
UNROLL_DM
      for (int c = 0; c < DM; ++c) accw[c] = accg[c] = T(0);
      for (int j = 0; j < M; ++j) {
        const T e = pair_e<T, DM>(g1i, upi, aui, g2, wp, aw, j, d, M, cexp);
        T de = df2 * (alui * alw[j]);
        if (qd) de += decov * q[(size_t)i * M + j];
        const T ede = e * de;
        rs += ede;
UNROLL_DM
        for (int c = 0; c < DM; ++c)
          if (c < d) {
            accw[c] += ede * wp[c * M + j];
            accg[c] += ede * g2[c * M + j];
          }
        ea += e * alw[j];
      }
      const T da_u = T(-0.5) * rs;
      T dup[DM];
UNROLL_DM
      for (int c = 0; c < DM; ++c) dup[c] = c < d ? -accw[c] + T(2) * upi[c] * da_u : T(0);
      v[NT + DM] += rs;
UNROLL_DM
      for (int c = 0; c < DM; ++c) v[NT + c] += dup[c];
      utsolve<T, DM>(sh.ch, dup, d);  // tmp_u
      lsolve<T, DM>(sh.ch, ilu, d);
UNROLL_DM
      for (int a = 0; a < DM; ++a)
UNROLL_DM
        for (int b = 0; b < DM; ++b)
          if (b <= a) v[tri(a, b)] -= dup[a] * ilu[b];
      for (int c = 0; c < d; ++c) {
        dg.ut[o + pdm + c * M + i] = dup[c];
        dg.g1t[o + pdm + c * M + i] = accg[c];
      }
      dg.g11[o + (size_t)p * M + i] = da_u;
      dg.alpha_u[o + (size_t)p * M + i] = df2 * ea;
    }
  } else {
    // column pass: thread j owns da_w[j], dwp[:, j], dg2t[:, j], dalpha_w[j]
    // and column j of dqmat
    for (int j = threadIdx.x - kHalf; j < M; j += kHalf) {
      T wpj[DM], ilw[DM];
UNROLL_DM
      for (int c = 0; c < DM; ++c) {
        wpj[c] = c < d ? wp[c * M + j] : T(0);
        ilw[c] = c < d ? g.wt[pdm + c * M + j] : T(0);
      }
      const T alwj = alw[j];
      T cs = T(0), ea = T(0), accu[DM], accg[DM];
UNROLL_DM
      for (int c = 0; c < DM; ++c) accu[c] = accg[c] = T(0);
      for (int i = 0; i < M; ++i) {
        T g1i[DM], upi[DM];
UNROLL_DM
        for (int c = 0; c < DM; ++c) {
          g1i[c] = c < d ? g1[c * M + i] : T(0);
          upi[c] = c < d ? up[c * M + i] : T(0);
        }
        const T e = pair_e<T, DM>(g1i, upi, au[i], g2, wp, aw, j, d, M, cexp);
        T de = df2 * (alu[i] * alwj);
        if (qd) de += decov * q[(size_t)i * M + j];
        const T ede = e * de;
        cs += ede;
UNROLL_DM
        for (int c = 0; c < DM; ++c) {
          accu[c] += ede * upi[c];
          accg[c] += ede * g1i[c];
        }
        ea += alu[i] * e;
        if (diag) dg.qmat[o + ((size_t)pi * M + i) * M + j] = decov * e;
      }
      const T da_w = T(-0.5) * cs;
      T dwp[DM];
UNROLL_DM
      for (int c = 0; c < DM; ++c) dwp[c] = c < d ? -accu[c] + T(2) * wpj[c] * da_w : T(0);
UNROLL_DM
      for (int c = 0; c < DM; ++c) v[NT + c] += dwp[c];
      utsolve<T, DM>(sh.ch, dwp, d);  // tmp_w
      lsolve<T, DM>(sh.ch, ilw, d);
UNROLL_DM
      for (int a = 0; a < DM; ++a)
UNROLL_DM
        for (int b = 0; b < DM; ++b)
          if (b <= a) v[tri(a, b)] -= dwp[a] * ilw[b];
      for (int c = 0; c < d; ++c) {
        dg.wt[o + pdm + c * M + j] = dwp[c];
        dg.g2t[o + pdm + c * M + j] = accg[c];
      }
      dg.g22[o + (size_t)p * M + j] = da_w;
      dg.alpha_w[o + (size_t)p * M + j] = df2 * ea;
    }
  }

  block_sum<T, NV>(v, sh.red, sh.out);
  if (threadIdx.x == 0) {
    T tm[DM];
    for (int i = 0; i < DM; ++i) tm[i] = i < d ? T(-0.5) * sh.out[NT + i] : T(0);
    utsolve<T, DM>(sh.ch, tm, d);  // tmp_m
    for (int a = 0; a < d; ++a)
      for (int b = 0; b <= a; ++b) sh.out[tri(a, b)] -= tm[a] * sh.ilm[b];
    const T s = sh.out[NT + DM];
    finish_group<T, DM>(sh, sh.out, -s, gda_nk, d);
    for (int i = 0; i < d; ++i) gdmx_nk[i] = tm[i];
    for (int a = 0; a < d; ++a) dg.kdiag[o + (size_t)k * d + a] = sh.da[a * DM + a];
    dg.cp[o + p] = s;
  }
}

// Full backward, stage 2 (N > 1): one thread per grid cotangent adds the
// entries' slots in order n = 0..N-1.
template <typename T>
__global__ void svgp_bwd_slots(const T* __restrict__ slots, T* __restrict__ dgrid, Dims z) {
  const size_t total = grid_elems(z);
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  T s = slots[e];
  for (int n = 1; n < z.N; ++n) s += slots[n * total + e];
  dgrid[e] = s;
}

// ---------------------------------------------------------------- launchers
inline bool make_dims(int N, int L, int D, int M, int unc, Dims& z) {
  z.N = N;
  z.L = L;
  z.P = L * (L + 1) / 2;
  z.K = z.L + z.P;
  z.D = D;
  z.M = M;
  z.unc = unc != 0;
  return N > 0 && L > 0 && D > 0 && D <= kMaxD && M > 0;
}

template <typename K>
inline cudaError_t allow_shared(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DM>
int fwd_dm(const Grid<T>& g, const Dims& z, const T* mx, const T* sxx, T* f1, T* sff, T* cross,
           T* scratch, cudaStream_t st) {
  const int nt = cdiv(z.M, kTI) * cdiv(z.M, kTJ);
  const size_t bytes = tile_smem_elems(z.D, false) * sizeof(T);
  cudaError_t err = allow_shared(svgp_fwd_tiles<T, DM>, bytes);
  if (err != cudaSuccess) return (int)err;
  svgp_fwd_tiles<T, DM><<<dim3(z.L + z.P * nt, z.N), kThreads, bytes, st>>>(g, z, mx, sxx, f1, cross,
                                                                            scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  svgp_fwd_combine<T><<<z.N, 32, 0, st>>>(g.varr, f1, scratch, sff, z);
  return (int)cudaGetLastError();
}

template <typename T, int DM>
int bwd_frozen_dm(const Grid<T>& g, const Dims& z, const T* mx, const T* sxx, const T* f1,
                  const T* df1, const T* dsff, const T* dcross, T* dmx, T* dsxx, T* gda, T* gdmx,
                  T* rp, T* cq, cudaStream_t st) {
  const int nti = cdiv(z.M, kTI), ntj = cdiv(z.M, kTJ);
  const size_t bytes = tile_smem_elems(z.D, true) * sizeof(T);
  cudaError_t err = allow_shared(svgp_bwd_tiles<T, DM>, bytes);
  if (err != cudaSuccess) return (int)err;
  svgp_bwd_tiles<T, DM><<<dim3(z.P * nti * ntj, z.N), kThreads, bytes, st>>>(g, z, mx, sxx, dsff, rp,
                                                                             cq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  svgp_bwd_finish<T, DM><<<dim3(z.K, z.N), kThreads, 0, st>>>(g, z, mx, sxx, f1, df1, dsff, dcross,
                                                               rp, cq, gda, gdmx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  svgp_bwd_combine<T><<<z.N, 64, 0, st>>>(gda, gdmx, dmx, dsxx, z);
  return (int)cudaGetLastError();
}

template <typename T, int DM>
int bwd_full_dm(const Grid<T>& g, const Dims& z, const T* mx, const T* sxx, const T* f1, const T* df1,
                const T* dsff, const T* dcross, T* dmx, T* dsxx, T* gda, T* gdmx, T* dgrid, T* slots,
                cudaStream_t st) {
  const size_t bytes = (size_t)(4 * z.D + 4) * z.M * sizeof(T);
  cudaError_t err = allow_shared(bwd_groups<T, DM>, bytes);
  if (err != cudaSuccess) return (int)err;
  const GridGrad<T> dg = grid_grad_at(z.N == 1 ? dgrid : slots, z);
  const size_t slot = z.N == 1 ? 0 : grid_elems(z);
  bwd_groups<T, DM><<<dim3(z.K, z.N), kThreads, bytes, st>>>(g, dg, slot, z, mx, sxx, f1, df1, dsff, dcross,
                                                             gda, gdmx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (z.N > 1) {
    svgp_bwd_slots<T><<<(unsigned)cdiv((int)grid_elems(z), 256), 256, 0, st>>>(slots, dgrid, z);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  svgp_bwd_combine<T><<<z.N, 64, 0, st>>>(gda, gdmx, dmx, dsxx, z);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const Grid<T>& g, const T* mx, const T* sxx, T* f1, T* sff, T* cross, T* scratch,
               int N, int L, int D, int M, int unc, void* stream) {
  Dims z;
  if (!make_dims(N, L, D, M, unc, z)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 8) return fwd_dm<T, 8>(g, z, mx, sxx, f1, sff, cross, scratch, st);
  return fwd_dm<T, 16>(g, z, mx, sxx, f1, sff, cross, scratch, st);
}

template <typename T>
int launch_bwd_frozen(const Grid<T>& g, const T* mx, const T* sxx, const T* f1, const T* df1,
                      const T* dsff, const T* dcross, T* dmx, T* dsxx, T* gda, T* gdmx, T* rp,
                      T* cq, int N, int L, int D, int M, int unc, void* stream) {
  Dims z;
  if (!make_dims(N, L, D, M, unc, z)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 8)
    return bwd_frozen_dm<T, 8>(g, z, mx, sxx, f1, df1, dsff, dcross, dmx, dsxx, gda, gdmx, rp, cq, st);
  return bwd_frozen_dm<T, 16>(g, z, mx, sxx, f1, df1, dsff, dcross, dmx, dsxx, gda, gdmx, rp, cq, st);
}

template <typename T>
int launch_bwd_full(const Grid<T>& g, const T* mx, const T* sxx, const T* f1, const T* df1,
                    const T* dsff, const T* dcross, T* dmx, T* dsxx, T* gda, T* gdmx, T* dgrid,
                    T* slots, int N, int L, int D, int M, int unc, void* stream) {
  Dims z;
  if (!make_dims(N, L, D, M, unc, z)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 8)
    return bwd_full_dm<T, 8>(g, z, mx, sxx, f1, df1, dsff, dcross, dmx, dsxx, gda, gdmx, dgrid, slots,
                             st);
  return bwd_full_dm<T, 16>(g, z, mx, sxx, f1, df1, dsff, dcross, dmx, dsxx, gda, gdmx, dgrid, slots,
                            st);
}

}  // namespace

#define GRID_ARGS(T)                                                                         \
  const T *kdiag, const T *zt, const T *alpha, const T *varr, const T *hll, const T *qmat, \
      const T *ut, const T *wt, const T *g1t, const T *g2t, const T *g11, const T *g22,    \
      const T *cp, const T *alpha_u, const T *alpha_w
#define GRID_INIT {kdiag, zt, alpha, varr, hll, qmat, ut, wt, g1t, g2t, g11, g22, cp, alpha_u, alpha_w}

#define MM_MATCH_ENTRIES(T, SFX)                                                                 \
  extern "C" int svgp_match_fwd_##SFX(const T* mx, const T* sxx, GRID_ARGS(T), T* f1, T* sff,   \
                                      T* cross, T* scratch, int N, int L, int D, int M, int unc, \
                                      void* stream) {                                            \
    const Grid<T> g = GRID_INIT;                                                                 \
    return launch_fwd<T>(g, mx, sxx, f1, sff, cross, scratch, N, L, D, M, unc, stream);         \
  }                                                                                              \
  extern "C" int svgp_match_bwd_frozen_##SFX(                                                    \
      const T* mx, const T* sxx, GRID_ARGS(T), const T* f1, const T* df1, const T* dsff,         \
      const T* dcross, T* dmx, T* dsxx, T* gda, T* gdmx, T* rp, T* cq, int N, int L, int D,      \
      int M, int unc, void* stream) {                                                            \
    const Grid<T> g = GRID_INIT;                                                                 \
    return launch_bwd_frozen<T>(g, mx, sxx, f1, df1, dsff, dcross, dmx, dsxx, gda, gdmx, rp, cq, \
                                N, L, D, M, unc, stream);                                        \
  }                                                                                              \
  extern "C" int svgp_match_bwd_##SFX(                                                           \
      const T* mx, const T* sxx, GRID_ARGS(T), const T* f1, const T* df1, const T* dsff,         \
      const T* dcross, T* dmx, T* dsxx, T* gda, T* gdmx, T* dgrid, T* slots, int N, int L,       \
      int D, int M, int unc, void* stream) {                                                     \
    const Grid<T> g = GRID_INIT;                                                                 \
    return launch_bwd_full<T>(g, mx, sxx, f1, df1, dsff, dcross, dmx, dsxx, gda, gdmx, dgrid,    \
                              slots, N, L, D, M, unc, stream);                                   \
  }

MM_MATCH_ENTRIES(float, f32)
MM_MATCH_ENTRIES(double, f64)
