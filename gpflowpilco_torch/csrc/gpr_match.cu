// Whole GPR moment match for Hopper (sm_90a), float32 and float64.
//
// Replaces the TPU kernels of gpflowpilco_tpu/ops/mm_match_pallas.py:
//   gpr_match_fwd_{f32,f64}        <- _gpr_fwd_kernel (:1120), launched by _gpr_fwd_call (:1156)
//   gpr_match_bwd_frozen_{f32,f64} <- _gpr_bwd_kernel (:1133), launched by _gpr_vjp_bwd (:1181)
//
// A GPR drift (every member of an HMC ensemble) is matched with its training
// inputs x_1..x_N as the inducing points and one kernel shared by the R
// output columns. For batch entry b and member k, with the state moments
// (mx, S) of entry (b, k) and A_0 = S + diag(lam) = ch0 ch0^T,
// A_1 = S + diag(vdiag) = ch1 ch1^T:
//   eKfu:  y_i = ch0^{-1}(x_i - mx), e_i = var exp(hll - hls0 - |y_i|^2/2), iv_i = ch0^{-T} y_i
//          f1_r = sum_i alpha_ir e_i,  cross[d, r] = sum_i iv_id alpha_ir e_i
//   pair:  up_i = ch1^{-1} u_i - ch1^{-1} mx / 2, a_i = g11_i + |up_i|^2,
//          E_ij = exp(cexp + g1_i.g1_j - up_i.up_j - a_i/2 - a_j/2)  (symmetric, never stored)
//          f2 = alpha^T E alpha,  ecov = sum_ij Kyy^{-1}_ij E_ij
//   sff = f2 - f1 f1^T + I (var - ecov)   (the uncertainty term when asked)
// The backward is frozen (moments only), the hand adjoint of
// mm_match_pallas._gpr_bwd_core (:1027). Because E is symmetric, row i's
// sums over j cover what the TPU kernel took from a row pass and a column
// pass: with s_ij = de(i,j) + de(j,i) = (vL_i + vR_i).alpha_j + 2 decov
// Kyy^{-1}_ij (vL = dsff^T alpha_i, vR = dsff alpha_i), da_u_i = -sum_j E s / 2
// and dup_i = -sum_j E s up_j + 2 up_i da_u_i.
//
// Bound on an H100: at the ensemble's shape (K=8 members, N=240, D=6, R=4) a
// forward must read Kyy^{-1} (8 x 240^2 x 4 B = 1.8 MB in float32), ~0.55 us
// at 3.35 TB/s, and does ~8 x 240^2 x 35 ~ 16 MFLOP plus 0.46 M exp, ~0.25 us:
// both far below a launch, so the kernels are latency-bound, and what sets
// their time is how many blocks work at once and how long each block's
// chain of dependent steps is.
//
// Both directions cut each member's N x N grid into 64 x 64 tiles on the
// block grid ((ceil(N/64)^2, K, B) blocks: 128 at the ensemble's shape, one
// wave on 132 SMs). A tile block's thread 0 factors S + diag(vdiag) and
// solves for ch^{-1} mx in registers (chol_r); the block stages its 64 rows'
// and 64 columns' pair factors (up, g1, a/2, and weights) in shared memory,
// one thread per point, and Kyy^-1's tile arrives by cp.async, issued before
// the factor and awaited before its first use. Each of the 16 x 16 threads
// evaluates a 4 x 4 micro-tile of E once. A ragged edge is masked: a point
// beyond N stages a/2 = +inf (so E = 0), zero weights, and a zero-filled
// Kyy^{-1}. The serial factor work of every launch (chol_r, chol_rev_r)
// runs in registers. Every sum has a fixed order and there are no atomics:
// repeated runs are bit-identical. Full-precision exp and log (no fast math).
//
// Forward, two launches. gpr_fwd_tiles: each tile block sums its rows'
// t_ir = sum_j E_ij alpha_jr, forms its share of f2 (alpha_i^T t_i) and of
// ecov (sum Kyy^-1 o E), and block-sums them in a fixed order into its
// tile's slot of the scratch. The eKfu part (f1 and cross, per point)
// runs in blocks of its own in the same launch, the first ceil(N/256)
// values of blockIdx.x: thread 0 factors S + diag(lam), a thread per point
// solves, and the block sums into its slot. fwd_combine, a warp per (entry,
// member), adds the eKfu slots and then the tile slots in order and forms
// sff.
//
// Frozen backward, three launches. gpr_bwd_tiles: the tile's rows stage
// vl = dsff^T alpha_i and vs = (dsff^T + dsff) alpha_i, and each row's sums
// of E sl, E s2 and E s2 up_j over its columns (the 16 lanes that share a
// row add theirs by shuffles) go to rp[b][k][column tile], D + 2 per row.
// gpr_bwd_finish (a thread per point, 128 per block; threads 0 and 32
// factor the two matrices at once) runs the eKfu adjoint of its point,
// adds its row partials over the column tiles in order and runs the
// post-sweep adjoint (dup -> tmp_u, the outer products with ch^{-1} u_i),
// and block-sums both into the scratch that bwd_combine, one thread per
// (entry, member), adds over the row tiles in a fixed order before the
// Cholesky adjoints, dmx and dsxx = sym(da0 + da1).
//
// Each entry returns cudaGetLastError() as an int; the caller raises on
// nonzero. Entries launch on the given stream and do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // points per block of the backward's finish
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 4;    // output columns (cartpole and the double pendulum: 4)
constexpr int kMaxD = 16;
// A tile of a member's N x N grid: kT x kT cells on 16 x 16 threads, kR x
// kR cells each; ops/gpr_match_cuda.py sizes the scratch for it (TILE). The
// forward's eKfu blocks take kTileThreads points each (_LATENT).
constexpr int kT = 64;
constexpr int kR = kT / 16;
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;

// A tile block's dynamic shared memory, laid out from its start: Kyy^-1's
// tile (kT x kT), the rows' up and g1 (d x kT each), a/2, and two kMaxR x kT
// arrays of row weights (the forward's alpha in rvl; the backward's vl and
// vs), then the columns' up and g1, a/2 and alpha.
template <typename T>
struct TileSmem {
  T *q, *rup, *rg1, *rh, *rvl, *rvs, *cup, *cg1, *chh, *cal;
  __device__ TileSmem(T* base, int d) {
    q = base;
    rup = q + kT * kT;
    rg1 = rup + d * kT;
    rh = rg1 + d * kT;
    rvl = rh + kT;
    rvs = rvl + kMaxR * kT;
    cup = rvs + kMaxR * kT;
    cg1 = cup + d * kT;
    chh = cg1 + d * kT;
    cal = chh + kT;
  }
};

inline size_t tile_smem_elems(int d) {
  return (size_t)kT * kT + (size_t)(4 * d + 2) * kT + (size_t)3 * kMaxR * kT;
}

#define UNROLL_DM _Pragma("unroll (DM <= 8 ? DM : 1)")
#define UNROLL_DM2 _Pragma("unroll (DM <= 8 ? DM * DM : 1)")

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float sq(float x) { return sqrtf(x); }
__device__ __forceinline__ double sq(double x) { return sqrt(x); }

__host__ __device__ constexpr int tri(int a, int b) { return a * (a + 1) / 2 + b; }
__host__ __device__ constexpr int ntri(int dm) { return dm * (dm + 1) / 2; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__device__ __forceinline__ void set_inf(float& x) { x = __int_as_float(0x7f800000); }
__device__ __forceinline__ void set_inf(double& x) { x = __longlong_as_double(0x7ff0000000000000LL); }

// One element from global into shared memory by cp.async, zero-filled where
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
// partial sums per slot: forward eKfu (f1, cross) and pair (f2, ecov);
// backward latent (dch0, dzc, dhls0) then pair (dch1, dilm, dhls1)
__host__ __device__ constexpr int nv_fwd_lat(int dm) { return kMaxR + dm * kMaxR; }
__host__ __device__ constexpr int nv_fwd_pair() { return kMaxR * kMaxR + 1; }
__host__ __device__ constexpr int nv_bwd(int dm) { return ntri(dm) + dm + 1; }

// Grid tensors in GPR_GRID_FIELDS order (ops/gpr_match_cuda.py), unpadded.
template <typename T>
struct Grid {
  const T *kdiag;    // (K, 2, D): lam, vdiag
  const T *xt;       // (D, N) training inputs, transposed
  const T *alpha;    // (K, N, R)
  const T *varr;     // (K,)
  const T *hll;      // (K,) 0.5 sum log lam
  const T *kyy_inv;  // (K, N, N)
  const T *ut;       // (K, D, N)
  const T *g1t;      // (K, D, N)
  const T *g11;      // (K, N)
  const T *cp;       // (K,)
};

struct Dims {
  int B, K, D, N, R, tiles;
  bool unc;
};

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

// Sum NV per-thread values over a block of NTHR threads into dst[NV]:
// shuffles within each warp, then the warps in order. `red` holds
// NTHR / 32 * NV values.
template <typename T, int NV, int NTHR>
__device__ __forceinline__ void block_sum(const T (&v)[NV], T* red, T* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    T x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp * NV + k] = x;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NV; k += NTHR) {
    T s = T(0);
    for (int w = 0; w < NTHR / 32; ++w) s += red[w * NV + k];
    dst[k] = s;
  }
  __syncthreads();
}

// The serial factor work, in registers: the Cholesky factor ch (DM x DM,
// row-major, zero above the diagonal and beyond d) of S + diag(kd), which
// returns sum log ch_ii, and its adjoint, the lower-triangle cotangent da
// of the factored matrix from the factor's cotangent dl (destroyed;
// mm_match_pallas._chol_rev). Their loops run over the capacity DM with
// guards (constant trip counts), unrolled at DM = 8, so that a matrix in a
// local array stays in registers.
template <typename T, int DM>
__device__ __forceinline__ T chol_r(const T* S, const T* kd, T* ch, int d) {
UNROLL_DM2
  for (int i = 0; i < DM * DM; ++i) ch[i] = T(0);
UNROLL_DM
  for (int j = 0; j < DM; ++j) {
    if (j < d) {
      T s = S[j * d + j] + kd[j];
UNROLL_DM
      for (int k = 0; k < DM; ++k)
        if (k < j) s -= ch[j * DM + k] * ch[j * DM + k];
      ch[j * DM + j] = sq(s);
      const T inv = T(1) / ch[j * DM + j];
UNROLL_DM
      for (int i = 0; i < DM; ++i) {
        if (i > j && i < d) {
          T t = S[i * d + j];
UNROLL_DM
          for (int k = 0; k < DM; ++k)
            if (k < j) t -= ch[i * DM + k] * ch[j * DM + k];
          ch[i * DM + j] = t * inv;
        }
      }
    }
  }
  T hls = T(0);
UNROLL_DM
  for (int i = 0; i < DM; ++i)
    if (i < d) hls += lg(ch[i * DM + i]);
  return hls;
}

template <typename T, int DM>
__device__ __forceinline__ void chol_rev_r(const T* ch, T* dl, T* da, int d) {
UNROLL_DM2
  for (int i = 0; i < DM * DM; ++i) da[i] = T(0);
UNROLL_DM
  for (int jj = 0; jj < DM; ++jj) {
    const int j = DM - 1 - jj;
    if (j < d) {
      const T inv = T(1) / ch[j * DM + j];
UNROLL_DM
      for (int ii = 0; ii < DM; ++ii) {
        const int i = DM - 1 - ii;
        if (i > j && i < d) {
          const T gi = dl[i * DM + j] * inv;
          da[i * DM + j] += gi;
          dl[j * DM + j] -= gi * ch[i * DM + j];
UNROLL_DM
          for (int k = 0; k < DM; ++k)
            if (k < j) {
              dl[i * DM + k] -= gi * ch[j * DM + k];
              dl[j * DM + k] -= gi * ch[i * DM + k];
            }
        }
      }
      const T s = T(0.5) * dl[j * DM + j] * inv;
      da[j * DM + j] += s;
UNROLL_DM
      for (int k = 0; k < DM; ++k)
        if (k < j) dl[j * DM + k] -= T(2) * s * ch[j * DM + k];
    }
  }
}

// Factor S + diag(vdiag_k) into ch (shared) and solve ilm = ch^{-1} mx on
// the calling thread; returns sum log ch_ii.
template <typename T, int DM>
__device__ __forceinline__ T pair_factor(const Grid<T>& g, const Dims& z, int k, const T* mx, const T* S,
                                         T* ch, T* ilm) {
  const int d = z.D;
  T c[DM * DM], m[DM];
  const T hls = chol_r<T, DM>(S, g.kdiag + ((size_t)k * 2 + 1) * d, c, d);
UNROLL_DM
  for (int q = 0; q < DM; ++q) m[q] = q < d ? mx[q] : T(0);
  lsolve<T, DM>(c, m, d);
UNROLL_DM2
  for (int q = 0; q < DM * DM; ++q) ch[q] = c[q];
UNROLL_DM
  for (int q = 0; q < DM; ++q) ilm[q] = m[q];
  return hls;
}

// Factor S + diag(lam_k) into ch (shared) on the calling thread; returns
// sum log ch_ii.
template <typename T, int DM>
__device__ __forceinline__ T latent_factor(const Grid<T>& g, const Dims& z, int k, const T* S, T* ch) {
  T c[DM * DM];
  const T hls = chol_r<T, DM>(S, g.kdiag + (size_t)k * 2 * z.D, c, z.D);
UNROLL_DM2
  for (int q = 0; q < DM * DM; ++q) ch[q] = c[q];
  return hls;
}

// Row i's pair factors: up_i (and ilu_i = ch1^{-1} u_i), g1_i, a_i.
template <typename T, int DM>
__device__ __forceinline__ void pair_row(const Grid<T>& g, const Dims& z, int k, int i, const T* ch1,
                                         const T* ilm, T (&ilu)[DM], T (&up)[DM], T (&g1)[DM], T& a) {
  const int d = z.D, N = z.N;
  const size_t kdn = (size_t)k * d * N;
UNROLL_DM
  for (int c = 0; c < DM; ++c) {
    ilu[c] = c < d ? g.ut[kdn + (size_t)c * N + i] : T(0);
    g1[c] = c < d ? g.g1t[kdn + (size_t)c * N + i] : T(0);
  }
  lsolve<T, DM>(ch1, ilu, d);
  a = g.g11[(size_t)k * N + i];
UNROLL_DM
  for (int c = 0; c < DM; ++c) {
    up[c] = c < d ? ilu[c] - T(0.5) * ilm[c] : T(0);
    a += up[c] * up[c];
  }
}

// Row i's eKfu factors: y = ch0^{-1}(x_i - mx) becomes iv = ch0^{-T} y; returns e_i.
template <typename T, int DM>
__device__ __forceinline__ T latent_row(const Grid<T>& g, const Dims& z, int k, int i, const T* mx,
                                        const T* ch0, T hls0, T (&y)[DM], T (&iv)[DM]) {
  const int d = z.D;
UNROLL_DM
  for (int q = 0; q < DM; ++q) y[q] = q < d ? g.xt[(size_t)q * z.N + i] - mx[q] : T(0);
  lsolve<T, DM>(ch0, y, d);
  T quad = T(0);
UNROLL_DM
  for (int q = 0; q < DM; ++q) quad += y[q] * y[q];
UNROLL_DM
  for (int q = 0; q < DM; ++q) iv[q] = y[q];
  utsolve<T, DM>(ch0, iv, d);
  return g.varr[k] * ex(g.hll[k] - hls0 - T(0.5) * quad);
}

// Stage point m of member k into slot c (stride kT) of a tile's row or
// column arrays: up_m = ch1^{-1} u_m - ilm / 2 and g1_m (q < d) and a_m / 2,
// and return alpha_m in al. A point beyond N stages zeros and a/2 = +inf,
// so that its cells of E are 0, and returns zero weights.
template <typename T, int DM>
__device__ __forceinline__ bool stage_point(const Grid<T>& g, const Dims& z, int k, int m, int c,
                                            const T* ch1, const T* ilm, T* sup, T* sg1, T* sh,
                                            T (&al)[kMaxR]) {
  const int d = z.D, N = z.N, R = z.R;
  if (m < N) {
    const size_t kdn = (size_t)k * d * N;
    T u[DM];
UNROLL_DM
    for (int q = 0; q < DM; ++q) u[q] = q < d ? g.ut[kdn + (size_t)q * N + m] : T(0);
    lsolve<T, DM>(ch1, u, d);
    T a = g.g11[(size_t)k * N + m];
UNROLL_DM
    for (int q = 0; q < DM; ++q)
      if (q < d) {
        const T uq = u[q] - T(0.5) * ilm[q];
        a += uq * uq;
        sup[q * kT + c] = uq;
        sg1[q * kT + c] = g.g1t[kdn + (size_t)q * N + m];
      }
    sh[c] = T(0.5) * a;
#pragma unroll
    for (int q = 0; q < kMaxR; ++q) al[q] = q < R ? g.alpha[((size_t)k * N + m) * R + q] : T(0);
    return true;
  }
  for (int q = 0; q < d; ++q) sup[q * kT + c] = sg1[q * kT + c] = T(0);
  set_inf(sh[c]);
#pragma unroll
  for (int q = 0; q < kMaxR; ++q) al[q] = T(0);
  return false;
}

// Issue the cp.async copy of Kyy^-1's tile (rows i0.., columns j0..) of
// member k into q, zero-filled beyond N, and commit it.
template <typename T>
__device__ __forceinline__ void kyy_tile_async(const Grid<T>& g, const Dims& z, int k, int i0, int j0, T* q) {
  const int N = z.N;
  const T* kinv = g.kyy_inv + (size_t)k * N * N;
  for (int c = threadIdx.x; c < kT * kT; c += kTileThreads) {
    const int i = i0 + c / kT, j = j0 + c % kT;
    const bool valid = i < N && j < N;
    cp_async_elem(q + c, valid ? kinv + (size_t)i * N + j : kinv, valid);
  }
  cp_async_commit();
}

// This thread's kR x kR exponents of the tile (rows ty + 16a, columns tx +
// 16b), without cexp and the a/2 terms: el = up_i.up_j - g1_i.g1_j.
template <typename T>
__device__ __forceinline__ void tile_exponents(const TileSmem<T>& ts, int d, int tx, int ty, T (&el)[kR][kR]) {
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int bb = 0; bb < kR; ++bb) el[a][bb] = T(0);
  for (int q = 0; q < d; ++q) {
    T ru[kR], r1[kR], cu[kR], c1[kR];
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      ru[a] = ts.rup[q * kT + ty + 16 * a];
      r1[a] = ts.rg1[q * kT + ty + 16 * a];
    }
#pragma unroll
    for (int bb = 0; bb < kR; ++bb) {
      cu[bb] = ts.cup[q * kT + tx + 16 * bb];
      c1[bb] = ts.cg1[q * kT + tx + 16 * bb];
    }
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int bb = 0; bb < kR; ++bb) el[a][bb] += ru[a] * cu[bb] - r1[a] * c1[bb];
  }
}

// ---------------------------------------------------------------- forward
// Blocks (ceil(N / 256) + tiles^2, K, B), 256 threads, two resident per SM
// (at most 128 registers a thread), so that the ensemble's 136 blocks run in
// one wave on 132 SMs in float64 too. Scratch per (b, k):
// ceil(N / 256) eKfu slots of nv_fwd_lat values ([0, R) f1, [kMaxR + q kMaxR
// + r] cross), then tiles^2 pair slots of nv_fwd_pair values (f2 by [p kMaxR
// + r], then ecov), tile (ti, tj) at ti tiles + tj.
template <typename T, int DM>
__global__ void __launch_bounds__(kTileThreads, 2) gpr_fwd_tiles(Grid<T> g, Dims z, const T* __restrict__ mx_,
                                                               const T* __restrict__ sxx,
                                                               T* __restrict__ scratch) {
  constexpr int NL = nv_fwd_lat(DM), NP = nv_fwd_pair();
  static_assert(NL >= NP, "red holds the larger of the two sums");
  __shared__ T ch[DM * DM];
  __shared__ T ilm[DM];
  __shared__ T cst;  // hls0 (eKfu blocks) or cexp (tile blocks)
  __shared__ T red[kTileWarps * NL];
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  const int d = z.D, N = z.N, R = z.R, nt = cdiv(N, kT), nlat = cdiv(N, kTileThreads);
  const int k = blockIdx.y, b = blockIdx.z;
  const size_t bk = (size_t)b * z.K + k;
  const T* mx = mx_ + bk * d;
  const T* S = sxx + bk * d * d;
  T* slots = scratch + bk * ((size_t)nlat * NL + (size_t)nt * nt * NP);

  if ((int)blockIdx.x < nlat) {  // eKfu: a thread per point
    if (threadIdx.x == 0) cst = latent_factor<T, DM>(g, z, k, S, ch);
    __syncthreads();
    const int i = blockIdx.x * kTileThreads + threadIdx.x;
    T v[NL];
#pragma unroll
    for (int q = 0; q < NL; ++q) v[q] = T(0);
    if (i < N) {
      T y[DM], iv[DM];
      const T e = latent_row<T, DM>(g, z, k, i, mx, ch, cst, y, iv);
      for (int r = 0; r < R; ++r) {
        const T ae = g.alpha[((size_t)k * N + i) * R + r] * e;
        v[r] = ae;
UNROLL_DM
        for (int q = 0; q < DM; ++q) v[kMaxR + q * kMaxR + r] = iv[q] * ae;
      }
    }
    block_sum<T, NL, kTileThreads>(v, red, slots + (size_t)blockIdx.x * NL);
    return;
  }

  // a tile (ti, tj) of the (X, X) pair
  const int tile = blockIdx.x - nlat, ti = tile / nt, tj = tile % nt;
  const int i0 = ti * kT, j0 = tj * kT;
  const TileSmem<T> ts(reinterpret_cast<T*>(dyn_raw), d);
  if (z.unc) kyy_tile_async(g, z, k, i0, j0, ts.q);  // in flight through the factor and the staging
  if (threadIdx.x == 0) cst = g.cp[k] - pair_factor<T, DM>(g, z, k, mx, S, ch, ilm);
  __syncthreads();
  for (int r = threadIdx.x; r < 2 * kT; r += kTileThreads) {
    const bool row = r < kT;
    const int c = row ? r : r - kT;
    T al[kMaxR];
    stage_point<T, DM>(g, z, k, (row ? i0 : j0) + c, c, ch, ilm, row ? ts.rup : ts.cup,
                       row ? ts.rg1 : ts.cg1, row ? ts.rh : ts.chh, al);
#pragma unroll
    for (int q = 0; q < kMaxR; ++q) (row ? ts.rvl : ts.cal)[q * kT + c] = al[q];
  }
  __syncthreads();

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  T el[kR][kR];
  tile_exponents(ts, d, tx, ty, el);
  if (z.unc) cp_async_wait_all();
  __syncthreads();
  // t[a][r] = sum over this thread's columns of E alpha_jr, qs = sum Kyy^-1 o E
  T t[kR][kMaxR], qs = T(0);
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int ri = ty + 16 * a;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) t[a][r] = T(0);
#pragma unroll
    for (int bb = 0; bb < kR; ++bb) {
      const int cj = tx + 16 * bb;
      const T e = ex(cst - (el[a][bb] + ts.rh[ri] + ts.chh[cj]));
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) t[a][r] += e * ts.cal[r * kT + cj];
      if (z.unc) qs += ts.q[ri * kT + cj] * e;
    }
  }
  T v[NP];
#pragma unroll
  for (int p = 0; p < kMaxR; ++p)
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      T s = T(0);
#pragma unroll
      for (int a = 0; a < kR; ++a) s += ts.rvl[p * kT + ty + 16 * a] * t[a][r];
      v[p * kMaxR + r] = s;
    }
  v[NP - 1] = qs;
  block_sum<T, NP, kTileThreads>(v, red, slots + (size_t)nlat * NL + (size_t)tile * NP);
}

// A warp per (entry, member): the eKfu slots, then the tile slots, added in
// order, then f1, cross and sff.
template <typename T, int DM>
__global__ void __launch_bounds__(32) fwd_combine(const T* __restrict__ varr, const T* __restrict__ scratch,
                                                  T* __restrict__ f1, T* __restrict__ sff,
                                                  T* __restrict__ cross, Dims z) {
  constexpr int NL = nv_fwd_lat(DM), NP = nv_fwd_pair(), NV = NL + NP;
  __shared__ T s[NV];
  const int bk = blockIdx.x, lane = threadIdx.x;
  const int k = bk % z.K, R = z.R, d = z.D, nt = cdiv(z.N, kT), nlat = cdiv(z.N, kTileThreads);
  const T* slots = scratch + (size_t)bk * ((size_t)nlat * NL + (size_t)nt * nt * NP);
  for (int q = lane; q < NV; q += 32) {
    T acc = T(0);
    if (q < NL) {
      for (int t = 0; t < nlat; ++t) acc += slots[(size_t)t * NL + q];
    } else {
      const T* p = slots + (size_t)nlat * NL + (q - NL);
      for (int t = 0; t < nt * nt; ++t) acc += p[(size_t)t * NP];
    }
    s[q] = acc;
  }
  __syncwarp();
  for (int q = lane; q < R; q += 32) f1[(size_t)bk * R + q] = s[q];
  for (int q = lane; q < d * R; q += 32) cross[(size_t)bk * d * R + q] = s[kMaxR + (q / R) * kMaxR + q % R];
  for (int q = lane; q < R * R; q += 32) {
    const int p = q / R, r = q % R;
    T v = s[NL + p * kMaxR + r] - s[p] * s[r];
    if (z.unc && p == r) v += varr[k] - s[NV - 1];
    sff[(size_t)bk * R * R + q] = v;
  }
}

// ---------------------------------------------------------------- backward
// Stage 1. Blocks (tiles^2, K, B): tile (ti, tj) of member k's N x N grid,
// rows i in [64 ti, 64 ti + 64) and columns j in [64 tj, 64 tj + 64), for
// batch entry b. With sl_ij = vl_i.alpha_j + decov Kyy^-1_ij and s2_ij =
// vs_i.alpha_j + 2 decov Kyy^-1_ij, each row i of the tile gets
//   rp[b][k][tj][0][i] = sum_j E sl,  rp[..][1][i] = sum_j E s2,
//   rp[..][2 + q][i] = sum_j E s2 up_j[q]   (q < d).
template <typename T, int DM>
__global__ void __launch_bounds__(kTileThreads) gpr_bwd_tiles(Grid<T> g, Dims z, const T* __restrict__ mx_,
                                                               const T* __restrict__ sxx,
                                                               const T* __restrict__ dsff_,
                                                               T* __restrict__ rp) {
  __shared__ T ch1[DM * DM];
  __shared__ T ilm[DM];
  __shared__ T cexp;
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  const int d = z.D, N = z.N, R = z.R, nt = cdiv(N, kT);
  const int ti = blockIdx.x / nt, tj = blockIdx.x % nt, k = blockIdx.y, b = blockIdx.z;
  const int i0 = ti * kT, j0 = tj * kT;
  const size_t bk = (size_t)b * z.K + k;
  const T* mx = mx_ + bk * d;
  const T* dsff = dsff_ + bk * R * R;
  const TileSmem<T> ts(reinterpret_cast<T*>(dyn_raw), d);
  if (z.unc) kyy_tile_async(g, z, k, i0, j0, ts.q);  // in flight through the factor and the staging
  if (threadIdx.x == 0) cexp = g.cp[k] - pair_factor<T, DM>(g, z, k, mx, sxx + bk * d * d, ch1, ilm);
  __syncthreads();
  // staging, one thread per point: up, g1, a/2, and alpha (columns) or
  // vl = dsff^T alpha_i and vs = (dsff^T + dsff) alpha_i (rows)
  for (int r = threadIdx.x; r < 2 * kT; r += kTileThreads) {
    const bool row = r < kT;
    const int c = row ? r : r - kT;
    T al[kMaxR];
    const bool inside = stage_point<T, DM>(g, z, k, (row ? i0 : j0) + c, c, ch1, ilm, row ? ts.rup : ts.cup,
                                           row ? ts.rg1 : ts.cg1, row ? ts.rh : ts.chh, al);
#pragma unroll
    for (int q = 0; q < kMaxR; ++q) {
      if (row) {
        T l = T(0), rr = T(0);
        if (inside && q < R)
          for (int w = 0; w < R; ++w) {
            l += al[w] * dsff[w * R + q];
            rr += dsff[q * R + w] * al[w];
          }
        ts.rvl[q * kT + c] = l;
        ts.rvs[q * kT + c] = l + rr;
      } else {
        ts.cal[q * kT + c] = al[q];
      }
    }
  }
  __syncthreads();

  // this thread's kR x kR cells: rows ty + 16a, columns tx + 16b
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  T el[kR][kR], e2[kR][kR];
  tile_exponents(ts, d, tx, ty, el);
  T decov = T(0);
  if (z.unc)
    for (int q = 0; q < R; ++q) decov -= dsff[q * R + q];
  if (z.unc) cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int ri = ty + 16 * a;
    T vl[kMaxR], vs[kMaxR];
#pragma unroll
    for (int q = 0; q < kMaxR; ++q) {
      vl[q] = ts.rvl[q * kT + ri];
      vs[q] = ts.rvs[q * kT + ri];
    }
#pragma unroll
    for (int bb = 0; bb < kR; ++bb) {
      const int cj = tx + 16 * bb;
      const T e = ex(cexp - (el[a][bb] + ts.rh[ri] + ts.chh[cj]));
      T sl = T(0), s2 = T(0);
#pragma unroll
      for (int q = 0; q < kMaxR; ++q) {
        sl += vl[q] * ts.cal[q * kT + cj];
        s2 += vs[q] * ts.cal[q * kT + cj];
      }
      if (z.unc) {
        const T kq = decov * ts.q[ri * kT + cj];
        sl += kq;
        s2 += T(2) * kq;
      }
      el[a][bb] = e * sl;
      e2[a][bb] = e * s2;
    }
  }
  // the row sums: this thread's columns, then the 16 lanes of its row (xor
  // shuffles stay within a half-warp); lane tx = 0 writes
  T* rpt = rp + (bk * nt + tj) * (d + 2) * N;
  for (int c = 0; c < d + 2; ++c) {
    T w[kR];
#pragma unroll
    for (int bb = 0; bb < kR; ++bb) w[bb] = c < 2 ? T(1) : ts.cup[(c - 2) * kT + tx + 16 * bb];
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      T v = T(0);
#pragma unroll
      for (int bb = 0; bb < kR; ++bb) v += (c == 0 ? el[a][bb] : e2[a][bb]) * w[bb];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int i = i0 + ty + 16 * a;
      if (tx == 0 && i < N) rpt[(size_t)c * N + i] = v;
    }
  }
}

// Stage 2. Blocks (ceil(N / 128), K, B), a thread per point i: the eKfu
// adjoint of row i, and the pair adjoint after the sweep, from row i's
// partials added over the column tiles in order; each block sums both and
// writes them to scratch[b][k][tile] (bwd_combine adds the tiles).
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) gpr_bwd_finish(
    Grid<T> g, Dims z, const T* __restrict__ mx_, const T* __restrict__ sxx,
    const T* __restrict__ f1_, const T* __restrict__ df1_, const T* __restrict__ dsff_,
    const T* __restrict__ dcross_, const T* __restrict__ rp, T* __restrict__ scratch) {
  constexpr int NT = ntri(DM), NB = nv_bwd(DM);
  __shared__ T ch0[DM * DM];
  __shared__ T ch1[DM * DM];
  __shared__ T ilm[DM];
  __shared__ T hls0;
  __shared__ T red[kWarps * NB];
  const int tile = blockIdx.x, k = blockIdx.y, b = blockIdx.z, d = z.D, N = z.N, R = z.R;
  const int nt = cdiv(N, kT);
  const size_t bk = (size_t)b * z.K + k;
  const T* mx = mx_ + bk * d;
  const T* S = sxx + bk * d * d;
  // the two factors at once, on threads 0 and 32 (two warps)
  if (threadIdx.x == 0) {
    hls0 = latent_factor<T, DM>(g, z, k, S, ch0);
  } else if (threadIdx.x == 32) {
    pair_factor<T, DM>(g, z, k, mx, S, ch1, ilm);
  }
  __syncthreads();
  const int i = tile * kThreads + threadIdx.x;
  const bool row = i < N;
  T* out = scratch + (bk * z.tiles + tile) * 2 * NB;

  // the output cotangents, as the eKfu part needs them
  const T* f1 = f1_ + bk * R;
  const T* dsff = dsff_ + bk * R * R;
  T df1[kMaxR], al[kMaxR];
  for (int r = 0; r < kMaxR; ++r) {
    df1[r] = T(0);
    al[r] = (row && r < R) ? g.alpha[((size_t)k * N + i) * R + r] : T(0);
    if (r < R) {
      T c = df1_[bk * R + r];
      for (int q = 0; q < R; ++q) c -= (dsff[r * R + q] + dsff[q * R + r]) * f1[q];
      df1[r] = c;
    }
  }

  {  // eKfu part: [0, NT) dch0, [NT, NT + DM) sum dzc, NT + DM: dhls0
    T v[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) v[q] = T(0);
    if (row) {
      T y[DM], iv[DM], adc[DM];
      const T e = latent_row<T, DM>(g, z, k, i, mx, ch0, hls0, y, iv);
      T de = T(0);
      for (int r = 0; r < R; ++r) de += al[r] * df1[r];
UNROLL_DM
      for (int q = 0; q < DM; ++q) {
        T s = T(0);
        if (q < d)
          for (int r = 0; r < R; ++r) s += al[r] * dcross_[(bk * d + q) * R + r];
        adc[q] = s;
        de += iv[q] * s;
      }
      const T ede = e * de;
      v[NT + DM] = -ede;
      T t[DM], dz[DM];
UNROLL_DM
      for (int q = 0; q < DM; ++q) t[q] = e * adc[q];
      lsolve<T, DM>(ch0, t, d);
UNROLL_DM
      for (int q = 0; q < DM; ++q) dz[q] = T(-1) * y[q] * ede + t[q];
UNROLL_DM
      for (int a = 0; a < DM; ++a)
UNROLL_DM
        for (int c = 0; c < DM; ++c)
          if (c <= a) v[tri(a, c)] -= t[c] * iv[a];
      utsolve<T, DM>(ch0, dz, d);
UNROLL_DM
      for (int a = 0; a < DM; ++a) {
UNROLL_DM
        for (int c = 0; c < DM; ++c)
          if (c <= a) v[tri(a, c)] -= dz[a] * y[c];
        v[NT + a] = dz[a];
      }
    }
    block_sum<T, NB, kThreads>(v, red, out);
  }

  // pair part: [0, NT) dch1, [NT, NT + DM) dilm, NT + DM: dhls1
  T v[NB];
#pragma unroll
  for (int q = 0; q < NB; ++q) v[q] = T(0);
  if (row) {
    T ilu[DM], up[DM], g1[DM], a = T(0);
    pair_row<T, DM>(g, z, k, i, ch1, ilm, ilu, up, g1, a);
    // row i's sums over all N columns, the column tiles added in order
    T dsum = T(0), ssum = T(0), acc[DM];
UNROLL_DM
    for (int q = 0; q < DM; ++q) acc[q] = T(0);
    for (int t = 0; t < nt; ++t) {
      const T* part = rp + (bk * nt + t) * (d + 2) * N + i;
      dsum += part[0];
      ssum += part[N];
UNROLL_DM
      for (int q = 0; q < DM; ++q)
        if (q < d) acc[q] += part[(size_t)(2 + q) * N];
    }
    const T da_u = T(-0.5) * ssum;
    T dup[DM];
UNROLL_DM
    for (int q = 0; q < DM; ++q) {
      dup[q] = q < d ? -acc[q] + T(2) * up[q] * da_u : T(0);
      v[NT + q] = T(-0.5) * dup[q];
    }
    v[NT + DM] = -dsum;
    utsolve<T, DM>(ch1, dup, d);  // tmp_u
UNROLL_DM
    for (int q = 0; q < DM; ++q)
UNROLL_DM
      for (int c = 0; c < DM; ++c)
        if (c <= q) v[tri(q, c)] -= dup[q] * ilu[c];
  }
  block_sum<T, NB, kThreads>(v, red, out + NB);
}

// Stage 3. A thread per (entry, member): the row tiles' sums added in order,
// then both Cholesky adjoints, dmx and dsxx = sym(da0 + da1), in registers.
template <typename T, int DM>
__global__ void bwd_combine(Grid<T> g, Dims z, const T* __restrict__ mx_, const T* __restrict__ sxx,
                            const T* __restrict__ scratch, T* __restrict__ dmx,
                            T* __restrict__ dsxx) {
  constexpr int NT = ntri(DM), NB = nv_bwd(DM);
  const int bk = blockIdx.x * blockDim.x + threadIdx.x;
  if (bk >= z.B * z.K) return;
  const int k = bk % z.K, d = z.D;
  const T* mx = mx_ + (size_t)bk * d;
  const T* S = sxx + (size_t)bk * d * d;
  T s[2 * NB];
#pragma unroll
  for (int q = 0; q < 2 * NB; ++q) s[q] = T(0);
  for (int tile = 0; tile < z.tiles; ++tile) {
    const T* p = scratch + ((size_t)bk * z.tiles + tile) * 2 * NB;
#pragma unroll
    for (int q = 0; q < 2 * NB; ++q) s[q] += p[q];
  }
  T ch[DM * DM], dl[DM * DM], da[DM * DM], low[DM * DM];
  // eKfu factor
  chol_r<T, DM>(S, g.kdiag + (size_t)k * 2 * d, ch, d);
UNROLL_DM
  for (int a = 0; a < DM; ++a)
UNROLL_DM
    for (int c = 0; c < DM; ++c) dl[a * DM + c] = a < d && c <= a ? s[tri(a, c)] : T(0);
UNROLL_DM
  for (int a = 0; a < DM; ++a)
    if (a < d) dl[a * DM + a] += s[NT + DM] / ch[a * DM + a];
  chol_rev_r<T, DM>(ch, dl, da, d);
UNROLL_DM2
  for (int q = 0; q < DM * DM; ++q) low[q] = da[q];
  // pair factor, with the mean's solve ilm = ch1^{-1} mx
  T ilm[DM], tm[DM];
  chol_r<T, DM>(S, g.kdiag + ((size_t)k * 2 + 1) * d, ch, d);
UNROLL_DM
  for (int q = 0; q < DM; ++q) {
    ilm[q] = q < d ? mx[q] : T(0);
    tm[q] = q < d ? s[NB + NT + q] : T(0);
  }
  lsolve<T, DM>(ch, ilm, d);
  utsolve<T, DM>(ch, tm, d);  // tmp_m
UNROLL_DM
  for (int a = 0; a < DM; ++a)
UNROLL_DM
    for (int c = 0; c < DM; ++c) dl[a * DM + c] = a < d && c <= a ? s[NB + tri(a, c)] - tm[a] * ilm[c] : T(0);
UNROLL_DM
  for (int a = 0; a < DM; ++a)
    if (a < d) dl[a * DM + a] += s[NB + NT + DM] / ch[a * DM + a];
  chol_rev_r<T, DM>(ch, dl, da, d);
  for (int q = 0; q < d; ++q) dmx[(size_t)bk * d + q] = -s[NT + q] + tm[q];
  T* o = dsxx + (size_t)bk * d * d;
UNROLL_DM
  for (int a = 0; a < DM; ++a)
UNROLL_DM
    for (int c = 0; c < DM; ++c) {
      if (a < d && c <= a) {
        const T v = low[a * DM + c] + da[a * DM + c];
        if (a == c) {
          o[a * d + a] = v;
        } else {
          o[a * d + c] = T(0.5) * v;
          o[c * d + a] = T(0.5) * v;
        }
      }
    }
}

// ---------------------------------------------------------------- launchers
inline bool make_dims(int B, int K, int D, int N, int R, int unc, Dims& z) {
  z.B = B;
  z.K = K;
  z.D = D;
  z.N = N;
  z.R = R;
  z.tiles = (N + kThreads - 1) / kThreads;
  z.unc = unc != 0;
  return B > 0 && K > 0 && D > 0 && D <= kMaxD && N > 0 && R > 0 && R <= kMaxR;
}

// Allow kernel `fn` the dynamic shared memory of a tile block at this D.
template <typename T, typename F>
cudaError_t tile_smem(F fn, int d, size_t& bytes) {
  bytes = tile_smem_elems(d) * sizeof(T);
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DM>
int fwd_dm(const Grid<T>& g, const Dims& z, const T* mx, const T* sxx, T* f1, T* sff, T* cross,
           T* scratch, cudaStream_t st) {
  const int nt = cdiv(z.N, kT), nlat = cdiv(z.N, kTileThreads);
  size_t bytes;
  cudaError_t err = tile_smem<T>(gpr_fwd_tiles<T, DM>, z.D, bytes);
  if (err != cudaSuccess) return (int)err;
  gpr_fwd_tiles<T, DM><<<dim3(nlat + nt * nt, z.K, z.B), kTileThreads, bytes, st>>>(g, z, mx, sxx, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fwd_combine<T, DM><<<z.B * z.K, 32, 0, st>>>(g.varr, scratch, f1, sff, cross, z);
  return (int)cudaGetLastError();
}

template <typename T, int DM>
int bwd_dm(const Grid<T>& g, const Dims& z, const T* mx, const T* sxx, const T* f1, const T* df1,
           const T* dsff, const T* dcross, T* dmx, T* dsxx, T* scratch, T* rp, cudaStream_t st) {
  const int nt = cdiv(z.N, kT);
  size_t bytes;
  cudaError_t err = tile_smem<T>(gpr_bwd_tiles<T, DM>, z.D, bytes);
  if (err != cudaSuccess) return (int)err;
  gpr_bwd_tiles<T, DM><<<dim3(nt * nt, z.K, z.B), kTileThreads, bytes, st>>>(g, z, mx, sxx, dsff, rp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gpr_bwd_finish<T, DM><<<dim3(z.tiles, z.K, z.B), kThreads, 0, st>>>(g, z, mx, sxx, f1, df1, dsff,
                                                                      dcross, rp, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = z.B * z.K;
  bwd_combine<T, DM><<<(n + 127) / 128, 128, 0, st>>>(g, z, mx, sxx, scratch, dmx, dsxx);
  return (int)cudaGetLastError();
}

}  // namespace

#define GPR_GRID_ARGS(T)                                                                        \
  const T *kdiag, const T *xt, const T *alpha, const T *varr, const T *hll, const T *kyy_inv, \
      const T *ut, const T *g1t, const T *g11, const T *cp
#define GPR_GRID_INIT {kdiag, xt, alpha, varr, hll, kyy_inv, ut, g1t, g11, cp}

// Scratch, per (entry, member): the forward's ceil(N / 256) eKfu slots and
// ceil(N / 64)^2 tile slots, the backward's ceil(N / 128) x 2 nv_bwd values
// (ops/gpr_match_cuda.py:scratch_values); the backward's row partials rp:
// (B, K, ceil(N / 64), D + 2, N).
#define GPR_MATCH_ENTRIES(T, SFX)                                                                \
  extern "C" int gpr_match_fwd_##SFX(const T* mx, const T* sxx, GPR_GRID_ARGS(T), T* f1, T* sff, \
                                     T* cross, T* scratch, int B, int K, int D, int N, int R,    \
                                     int unc, void* stream) {                                    \
    const Grid<T> g = GPR_GRID_INIT;                                                             \
    Dims z;                                                                                      \
    if (!make_dims(B, K, D, N, R, unc, z)) return (int)cudaErrorInvalidValue;                    \
    cudaStream_t st = (cudaStream_t)stream;                                                      \
    if (D <= 8) return fwd_dm<T, 8>(g, z, mx, sxx, f1, sff, cross, scratch, st);                 \
    return fwd_dm<T, 16>(g, z, mx, sxx, f1, sff, cross, scratch, st);                            \
  }                                                                                              \
  extern "C" int gpr_match_bwd_frozen_##SFX(                                                     \
      const T* mx, const T* sxx, GPR_GRID_ARGS(T), const T* f1, const T* df1, const T* dsff,     \
      const T* dcross, T* dmx, T* dsxx, T* scratch, T* rp, int B, int K, int D, int N, int R,    \
      int unc, void* stream) {                                                                   \
    const Grid<T> g = GPR_GRID_INIT;                                                             \
    Dims z;                                                                                      \
    if (!make_dims(B, K, D, N, R, unc, z)) return (int)cudaErrorInvalidValue;                    \
    cudaStream_t st = (cudaStream_t)stream;                                                      \
    if (D <= 8)                                                                                  \
      return bwd_dm<T, 8>(g, z, mx, sxx, f1, df1, dsff, dcross, dmx, dsxx, scratch, rp, st);    \
    return bwd_dm<T, 16>(g, z, mx, sxx, f1, df1, dsff, dcross, dmx, dsxx, scratch, rp, st);     \
  }

GPR_MATCH_ENTRIES(float, f32)
GPR_MATCH_ENTRIES(double, f64)
