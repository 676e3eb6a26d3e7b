// Fused eKuffu pair-grid contraction for Hopper (sm_90a), float32 and float64.
//
// Replaces the TPU kernels of gpflowpilco_tpu/ops/kexp_pallas.py:
//   pair_contract_fwd_{f32,f64}        <- _fwd_kernel (:47), launched by _fwd_impl (:116)
//   pair_contract_bwd_{f32,f64}        <- _bwd_kernel (:62), launched by _vjp_bwd (:139)
//   pair_contract_bwd_frozen_{f32,f64} <- the same, with dalu and dqm skipped
//
// For batch entry n and latent pair p, with E = exp(-su^T sw) (M x M, never
// stored; every exponent is <= 0 by construction of su and sw, so neither
// type can overflow):
//   evc[n,p,r,j] = sum_i alu[p,r,i] E[i,j]          qcol[n,p,j] = sum_i qm[p,i,j] E[i,j]
// The backward recomputes E. With g = -E o (alu^T devc + qm o dqcol):
//   dsu[n,p,d,i] = sum_j sw[d,j] g[i,j]             dsw[n,p,d,j] = sum_i su[d,i] g[i,j]
//   dalu[p,r,i]  = sum_n sum_j devc[r,j] E[i,j]     dqm[p,i,j]   = sum_n E[i,j] dqcol[j]
// alu and qm are shared across the batch, so their gradients are summed over
// n here rather than through a broadcast copy. The frozen variant (alu and qm
// need no gradient: the drift inside a policy optimization) writes neither.
//
// Bound on an H100 (SXM, 3.35 TB/s; 34 TFLOP/s FP64, 67 TFLOP/s FP32 outside
// the tensor cores): at the drift's shapes (N=1, P=10 pairs, M=240, D2=14,
// float64) a forward must read qm (10 x 240 x 240 x 8 B = 4.6 MB) once, about
// 1.4 us, and does 10 x 240^2 x (2 x 14 + 4) ~ 18 MFLOP plus 576 k exp, about
// 0.6 us. A launch costs more than either, so the kernel is expected to sit
// well above its bound at these sizes.
//
// Full backward: E is recomputed per (i, j) in registers and reduced on the
// fly, in two passes. A block is 32 lanes x 4 warps. The column pass gives
// each lane a column j (so qm, dqm and every output row are read and
// written coalesced) and splits the rows i among the 4 warps; su (and alu)
// are staged in shared memory 32 rows at a time and broadcast to the warp.
// The row pass gives each lane a row i and splits the columns among the
// warps, staging sw, devc, dqcol and a transposed tile of qm. The warps'
// partial sums meet in shared memory in a fixed order. Grids are (column or
// row tiles of 32) x pairs: 80 blocks at the drift's shapes.
//
// Forward: each (n, p) grid is cut into kFT x kFT = 32 x 32 tiles on the
// block grid, (ceil(M/32)^2, P, N) blocks of 256 threads: 640 at the
// drift's shape, enough to fill the card. A block copies its tile's su rows, sw columns, alu rows and qm's tile into
// shared memory by cp.async, forms the exponents S = su_tile^T sw_tile as
// the frozen backward does (float64 on the tensor cores), evaluates E once
// per cell, and takes the column partials sum_i alu[r][i] E[i][j] and
// sum_i qm[i][j] E[i][j] over its 32 rows, a thread per (output row,
// column), rows in order. The partials go to scratch per (n, p, row tile)
// and a finish launch adds them over the row tiles in order; with one tile
// the block writes evc and qcol itself and there is no finish.
//
// Frozen backward: each (n, p) grid is cut into kFT x kFT = 32 x 32 tiles
// on the block grid, (ceil(M/32)^2, P, N) blocks of 256 threads: 640 at the
// drift's shape (64 x 64 tiles, 160 blocks, measured slower there and at
// the policy's shape, and no faster on the GPR route). A block copies its
// tile's su rows, sw columns (D2 x 32 each), alu rows, devc and dqcol
// columns and qm's tile (row order) into shared memory by cp.async, forms
// the exponents S = su_tile^T sw_tile (depth D2), evaluates E once per cell
// into g = -E o (alu^T devc + qm o dqcol), kept in shared memory over qm's
// tile, and takes the row partial dsu_part = g sw_tile^T (32 x D2) and the
// column partial dsw_part = su_tile g (D2 x 32) from that one tile. In
// float64 the three products run on the tensor cores (DMMA, mma.sync m8n8k4,
// IEEE float64 products and sums); in float32 on the CUDA cores in full
// precision (not TF32: the exponent carries the |x|^2 + |z|^2 - 2 x.z
// cancellation). The partials go to scratch per (n, p, other tile), and a
// finish launch adds them over the tiles in a fixed order; with one tile the
// block writes dsu and dsw itself and there is no finish.
//
// M is not padded: the ragged tile is masked (zero-filled operands give
// g = 0). No atomics: results are bit-identical from run to run.
// Full-precision expf/exp (no fast math). Each entry returns
// cudaGetLastError() as an int; the caller raises on nonzero. Entries launch
// on the given stream and do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;   // columns (column pass) or rows (row pass) per block
constexpr int kGroups = 4;   // warps per block
constexpr int kThreads = kLanes * kGroups;
constexpr int kChunk = 32;   // rows or columns staged in shared memory at a time
constexpr int kMaxR = 4;     // alu rows (R=1 for the SVGP pair grid)
constexpr int kMaxD2 = 32;
constexpr int kTileThreads = 256;  // the forward's and the frozen backward's tile blocks
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kFT = 32;  // their tile side; ops/kexp_cuda.py's TILE

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float fm(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fm(double a, double b, double c) { return fma(a, b, c); }

// Sum v over the block's 4 warps for lane tx; the total is valid in warp 0.
// `red` holds kGroups * kLanes values. Synchronises before and after.
template <typename T>
__device__ __forceinline__ T group_sum(T v, T* red) {
  __syncthreads();
  red[threadIdx.y * kLanes + threadIdx.x] = v;
  __syncthreads();
  T total = T(0);
  if (threadIdx.y == 0) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) total += red[g * kLanes + threadIdx.x];
  }
  return total;
}

// Stage rows [i0, i0 + kChunk) of a (rows, M) slab, zero beyond `rows` and M.
template <typename T, int ROWS>
__device__ __forceinline__ void stage(T (*dst)[kChunk], const T* src, int rows, int M, int i0) {
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int k = tid; k < ROWS * kChunk; k += kThreads) {
    const int d = k / kChunk, ii = k % kChunk;
    dst[d][ii] = (d < rows && i0 + ii < M) ? src[(size_t)d * M + i0 + ii] : T(0);
  }
}

// Column pass of the full backward: dsw, and dqm summed over the batch.
// Each (i, j) belongs to one thread for every n, so dqm accumulates by a
// plain read-modify-write in a fixed order.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) bwd_cols_kernel(
    const T* __restrict__ su, const T* __restrict__ sw, const T* __restrict__ alu,
    const T* __restrict__ qm, const T* __restrict__ devc, const T* __restrict__ dqcol,
    T* __restrict__ dsw, T* __restrict__ dqm, int N, int P, int D2, int M, int R) {
  __shared__ T su_s[DM][kChunk];
  __shared__ T alu_s[kMaxR][kChunk];
  __shared__ T red[kGroups * kLanes];
  const int p = blockIdx.y;
  const int j = blockIdx.x * kLanes + threadIdx.x;
  const bool col = j < M;
  const T* qm_p = qm + (size_t)p * M * M;
  T* dqm_p = dqm + (size_t)p * M * M;

  for (int n = 0; n < N; ++n) {
    const size_t np = (size_t)n * P + p;
    const T* su_np = su + np * D2 * M;
    const T* sw_np = sw + np * D2 * M;
    T swj[DM], acc[DM], dv[kMaxR];
#pragma unroll
    for (int d = 0; d < DM; ++d) {
      swj[d] = (col && d < D2) ? sw_np[(size_t)d * M + j] : T(0);
      acc[d] = T(0);
    }
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) dv[r] = (col && r < R) ? devc[(np * R + r) * M + j] : T(0);
    const T dq = col ? dqcol[np * M + j] : T(0);

    for (int i0 = 0; i0 < M; i0 += kChunk) {
      __syncthreads();
      stage<T, DM>(su_s, su_np, D2, M, i0);
      stage<T, kMaxR>(alu_s, alu + (size_t)p * R * M, R, M, i0);
      __syncthreads();
      if (col) {
        const int ni = min(kChunk, M - i0);
        for (int ii = threadIdx.y; ii < ni; ii += kGroups) {
          T s = T(0);
#pragma unroll
          for (int d = 0; d < DM; ++d) s = fm(su_s[d][ii], swj[d], s);
          const T e = ex(-s);
          const size_t ij = (size_t)(i0 + ii) * M + j;
          T de = qm_p[ij] * dq;
#pragma unroll
          for (int r = 0; r < kMaxR; ++r) de = fm(alu_s[r][ii], dv[r], de);
          const T g = -e * de;
#pragma unroll
          for (int d = 0; d < DM; ++d) acc[d] = fm(su_s[d][ii], g, acc[d]);
          dqm_p[ij] = n == 0 ? e * dq : fm(e, dq, dqm_p[ij]);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < DM; ++d) {
      if (d < D2) {
        const T total = group_sum(acc[d], red);
        if (threadIdx.y == 0 && col) dsw[(np * D2 + d) * M + j] = total;
      }
    }
  }
}

// Row pass of the full backward: dsu, and dalu summed over the batch.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) bwd_rows_kernel(
    const T* __restrict__ su, const T* __restrict__ sw, const T* __restrict__ alu,
    const T* __restrict__ qm, const T* __restrict__ devc, const T* __restrict__ dqcol,
    T* __restrict__ dsu, T* __restrict__ dalu, int N, int P, int D2, int M, int R) {
  __shared__ T sw_s[DM][kChunk];
  __shared__ T dv_s[kMaxR][kChunk];
  __shared__ T dq_s[1][kChunk];
  __shared__ T qm_s[kLanes][kChunk + 1];  // rows of this block x staged columns
  __shared__ T red[kGroups * kLanes];
  const int p = blockIdx.y;
  const int i0 = blockIdx.x * kLanes;
  const int i = i0 + threadIdx.x;
  const bool row = i < M;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const T* qm_p = qm + (size_t)p * M * M;

  T al[kMaxR], da[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    al[r] = (row && r < R) ? alu[((size_t)p * R + r) * M + i] : T(0);
    da[r] = T(0);
  }
  for (int n = 0; n < N; ++n) {
    const size_t np = (size_t)n * P + p;
    const T* sw_np = sw + np * D2 * M;
    T sui[DM], acc[DM];
#pragma unroll
    for (int d = 0; d < DM; ++d) {
      sui[d] = (row && d < D2) ? su[(np * D2 + d) * M + i] : T(0);
      acc[d] = T(0);
    }
    for (int j0 = 0; j0 < M; j0 += kChunk) {
      __syncthreads();
      stage<T, DM>(sw_s, sw_np, D2, M, j0);
      stage<T, kMaxR>(dv_s, devc + np * R * M, R, M, j0);
      stage<T, 1>(dq_s, dqcol + np * M, 1, M, j0);
      for (int k = tid; k < kLanes * kChunk; k += kThreads) {
        const int a = k / kChunk, b = k % kChunk;
        qm_s[a][b] = (i0 + a < M && j0 + b < M) ? qm_p[(size_t)(i0 + a) * M + j0 + b] : T(0);
      }
      __syncthreads();
      if (row) {
        const int nj = min(kChunk, M - j0);
        for (int jj = threadIdx.y; jj < nj; jj += kGroups) {
          T s = T(0);
#pragma unroll
          for (int d = 0; d < DM; ++d) s = fm(sui[d], sw_s[d][jj], s);
          const T e = ex(-s);
          T de = qm_s[threadIdx.x][jj] * dq_s[0][jj];
#pragma unroll
          for (int r = 0; r < kMaxR; ++r) de = fm(al[r], dv_s[r][jj], de);
          const T g = -e * de;
#pragma unroll
          for (int d = 0; d < DM; ++d) acc[d] = fm(sw_s[d][jj], g, acc[d]);
#pragma unroll
          for (int r = 0; r < kMaxR; ++r) da[r] = fm(dv_s[r][jj], e, da[r]);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < DM; ++d) {
      if (d < D2) {
        const T total = group_sum(acc[d], red);
        if (threadIdx.y == 0 && row) dsu[(np * D2 + d) * M + i] = total;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r < R) {
      const T total = group_sum(da[r], red);
      if (threadIdx.y == 0 && row) dalu[((size_t)p * R + r) * M + i] = total;
    }
  }
}

// ------------------------------------------- tiles: forward and frozen backward
// One element from global into shared memory by cp.async, zero-filled where
// !valid (src is then not read). The #else branch is what a host compiler
// sees.
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
__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// c (8 x 8) += a (8 x 4, row-major) b (4 x 8, column-major) in float64 on
// the tensor cores (DMMA, PTX mma.sync.aligned.m8n8k4.row.col.f64): lane l
// holds a[l / 4][l % 4], b[l % 4][l / 4] and c[l / 4][2 (l % 4) + {0, 1}].
// The #else branch (what a host compiler sees) computes the same by
// shuffles, summing k in order.
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
#ifdef __CUDA_ARCH__
  double d0, d1;
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%4, %5};\n"
               : "=d"(d0), "=d"(d1)
               : "d"(a), "d"(b), "d"(c[0]), "d"(c[1]));
  c[0] = d0;
  c[1] = d1;
#else
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  double x = c[0], y = c[1];
  for (int k = 0; k < 4; ++k) {
    const double ak = __shfl_sync(0xffffffffu, a, gid * 4 + k);
    const double b0 = __shfl_sync(0xffffffffu, b, 2 * tig * 4 + k);
    const double b1 = __shfl_sync(0xffffffffu, b, (2 * tig + 1) * 4 + k);
    x = fma(ak, b0, x);
    y = fma(ak, b1, y);
  }
  c[0] = x;
  c[1] = y;
#endif
}

// Row stride of a tile's shared arrays: padded so that the tensor-core
// fragment loads of float64 and the float32 row sweeps spread over banks.
template <typename T>
constexpr int kLD = kFT + (sizeof(T) == 8 ? 4 : 1);

// A frozen-backward tile block's dynamic shared memory: g (kFT x LD; qm's
// tile until g overwrites it), the rows' su and the columns' sw (DM x LD
// each, zero beyond D2), the rows' alu and the columns' devc (kMaxR x kFT
// each, zero beyond R) and the columns' dqcol.
template <typename T, int DM>
struct FrozenSmem {
  static constexpr int LD = kLD<T>;
  T *g, *su, *sw, *al, *dv, *dq;
  __device__ explicit FrozenSmem(T* base)
      : g(base), su(g + kFT * LD), sw(su + DM * LD), al(sw + DM * LD), dv(al + kMaxR * kFT),
        dq(dv + kMaxR * kFT) {}
  static constexpr size_t elems() { return (size_t)(kFT + 2 * DM) * LD + (2 * kMaxR + 1) * kFT; }
};

// A forward tile block's: qm's tile (kFT x LD; qm o E once E is formed), E
// (kFT x LD), the rows' su and the columns' sw (DM x LD each, zero beyond
// D2) and the rows' alu (kMaxR x kFT, zero beyond R).
template <typename T, int DM>
struct FwdSmem {
  static constexpr int LD = kLD<T>;
  T *q, *e, *su, *sw, *al;
  __device__ explicit FwdSmem(T* base)
      : q(base), e(q + kFT * LD), su(e + kFT * LD), sw(su + DM * LD), al(sw + DM * LD) {}
  static constexpr size_t elems() { return (size_t)(2 * kFT + 2 * DM) * LD + kMaxR * kFT; }
};

// The exponents S = su_tile^T sw_tile (depth D2; su and sw staged DM x LD,
// zero beyond D2) over the tile, then f(i, j, S[i][j]) for every cell.
// float32: 16 x 16 threads, each a (kFT/16) x (kFT/16) micro-tile (rows ty +
// 16a, columns tx + 16b), FMAs over d in order.
template <typename F>
__device__ __forceinline__ void exponent_tile(const float* su, const float* sw, int D2, F&& f) {
  constexpr int U = kFT / 16, LD = kLD<float>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[U][U];
#pragma unroll
  for (int a = 0; a < U; ++a)
#pragma unroll
    for (int b = 0; b < U; ++b) acc[a][b] = 0.0f;
  for (int d = 0; d < D2; ++d) {
    float ru[U], cw[U];
#pragma unroll
    for (int a = 0; a < U; ++a) ru[a] = su[d * LD + ty + 16 * a];
#pragma unroll
    for (int b = 0; b < U; ++b) cw[b] = sw[d * LD + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < U; ++a)
#pragma unroll
      for (int b = 0; b < U; ++b) acc[a][b] = fmaf(ru[a], cw[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < U; ++a)
#pragma unroll
    for (int b = 0; b < U; ++b) f(ty + 16 * a, tx + 16 * b, acc[a][b]);
}

// float64: by DMMA, (kFT/8)^2 output tiles of 8 x 8 shared out among the 8
// warps, depth D2 in steps of 4 (the rows beyond D2 are 0).
template <typename F>
__device__ __forceinline__ void exponent_tile(const double* su, const double* sw, int D2, F&& f) {
  constexpr int NT8 = kFT / 8, PER = NT8 * NT8 / kTileWarps, LD = kLD<double>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  double acc[PER][2];
#pragma unroll
  for (int q = 0; q < PER; ++q) acc[q][0] = acc[q][1] = 0.0;
  for (int k0 = 0; k0 < D2; k0 += 4) {
    const int d = k0 + tig;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int lin = warp * PER + q, mi = lin / NT8, ni = lin % NT8;
      dmma(acc[q], su[d * LD + mi * 8 + gid], sw[d * LD + ni * 8 + gid]);
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int lin = warp * PER + q, mi = lin / NT8, ni = lin % NT8;
#pragma unroll
    for (int c = 0; c < 2; ++c) f(mi * 8 + gid, ni * 8 + 2 * tig + c, acc[q][c]);
  }
}

// g = -E o (alu^T devc + qm o dqcol) over the tile, in place of qm's tile.
template <typename T, int DM>
__device__ __forceinline__ void grad_tile(const FrozenSmem<T, DM>& s, int D2) {
  constexpr int LD = FrozenSmem<T, DM>::LD;
  exponent_tile(s.su, s.sw, D2, [&](int i, int j, T x) {
    T de = s.g[i * LD + j] * s.dq[j];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) de = fm(s.al[r * kFT + i], s.dv[r * kFT + j], de);
    s.g[i * LD + j] = -ex(-x) * de;
  });
}

// The tile's partials: dsu_part[d][i] = sum_j g[i][j] sw[d][j] into
// dsu_p[d * M + i0 + i] and dsw_part[d][j] = sum_i su[d][i] g[i][j] into
// dsw_p[d * M + j0 + j], for d < D2 and points below M.
// float32: thread tid takes point tid % kFT and rows d = tid / kFT + q (256/kFT).
template <int DM>
__device__ __forceinline__ void partials(const FrozenSmem<float, DM>& s, int D2, int M, int i0, int j0,
                                         float* dsu_p, float* dsw_p) {
  constexpr int LD = FrozenSmem<float, DM>::LD, STEP = kTileThreads / kFT, NQ = DM / STEP;
  const int c = threadIdx.x % kFT, d0 = threadIdx.x / kFT;
  float a[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) a[q] = 0.0f;
#pragma unroll 8
  for (int j = 0; j < kFT; ++j) {
    const float gij = s.g[c * LD + j];
#pragma unroll
    for (int q = 0; q < NQ; ++q) a[q] = fmaf(gij, s.sw[(d0 + q * STEP) * LD + j], a[q]);
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int d = d0 + q * STEP;
    if (d < D2 && i0 + c < M) dsu_p[(size_t)d * M + i0 + c] = a[q];
    a[q] = 0.0f;
  }
#pragma unroll 8
  for (int i = 0; i < kFT; ++i) {
    const float gij = s.g[i * LD + c];
#pragma unroll
    for (int q = 0; q < NQ; ++q) a[q] = fmaf(s.su[(d0 + q * STEP) * LD + i], gij, a[q]);
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int d = d0 + q * STEP;
    if (d < D2 && j0 + c < M) dsw_p[(size_t)d * M + j0 + c] = a[q];
  }
}

// float64: both products by DMMA, (kFT/8) x (DM/8) output tiles of 8 x 8
// each, shared out among the 8 warps (tiles wholly beyond D2 skipped), depth
// kFT in steps of 4.
template <int DM>
__device__ __forceinline__ void partials(const FrozenSmem<double, DM>& s, int D2, int M, int i0, int j0,
                                         double* dsu_p, double* dsw_p) {
  constexpr int NT8 = kFT / 8, ND8 = DM / 8, PER = NT8 * ND8 / kTileWarps;
  constexpr int LD = FrozenSmem<double, DM>::LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  double acc[PER][2];
  // dsu_part (kFT x DM): tile (mi over points, ni over d)
#pragma unroll
  for (int q = 0; q < PER; ++q) acc[q][0] = acc[q][1] = 0.0;
  for (int k0 = 0; k0 < kFT; k0 += 4) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int lin = warp * PER + q, mi = lin / ND8, ni = lin % ND8;
      if (ni * 8 < D2) dmma(acc[q], s.g[(mi * 8 + gid) * LD + k0 + tig], s.sw[(ni * 8 + gid) * LD + k0 + tig]);
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int lin = warp * PER + q, mi = lin / ND8, ni = lin % ND8;
    const int i = i0 + mi * 8 + gid;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d = ni * 8 + 2 * tig + c;
      if (d < D2 && i < M) dsu_p[(size_t)d * M + i] = acc[q][c];
    }
  }
  // dsw_part (DM x kFT): tile (mi over d, ni over points)
#pragma unroll
  for (int q = 0; q < PER; ++q) acc[q][0] = acc[q][1] = 0.0;
  for (int k0 = 0; k0 < kFT; k0 += 4) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int lin = warp * PER + q, mi = lin / NT8, ni = lin % NT8;
      if (mi * 8 < D2) dmma(acc[q], s.su[(mi * 8 + gid) * LD + k0 + tig], s.g[(k0 + tig) * LD + ni * 8 + gid]);
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int lin = warp * PER + q, mi = lin / NT8, ni = lin % NT8;
    const int d = mi * 8 + gid;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + ni * 8 + 2 * tig + c;
      if (d < D2 && j < M) dsw_p[(size_t)d * M + j] = acc[q][c];
    }
  }
}

// Blocks (nt^2, P, N), nt = ceil(M / kFT): block (ti nt + tj, p, n) takes
// tile (ti, tj) of grid (n, p), rows i in [kFT ti, kFT ti + kFT), columns j
// in [kFT tj, kFT tj + kFT).
struct TileAt {
  int nt, ti, tj, i0, j0, p;
  size_t np;
  __device__ TileAt(int P, int M)
      : nt(cdiv(M, kFT)), ti(blockIdx.x / nt), tj(blockIdx.x % nt), i0(ti * kFT), j0(tj * kFT),
        p(blockIdx.y), np((size_t)blockIdx.z * P + blockIdx.y) {}
};

// Issue the cp.async copies (not waited for) of a tile's operands: qm's
// tile in row order into q (row stride LD), the rows' su and the columns'
// sw into su_s and sw_s (DM x LD, zero beyond D2), the rows' alu into al_s
// (kMaxR x kFT, zero beyond R). Out-of-range cells are zero-filled.
template <typename T, int DM>
__device__ __forceinline__ void stage_tile(const TileAt& t, const T* su, const T* sw, const T* alu,
                                           const T* qm, T* q, T* su_s, T* sw_s, T* al_s, int D2, int M,
                                           int R) {
  constexpr int LD = kLD<T>;
  const int tid = threadIdx.x;
  const T* qm_p = qm + (size_t)t.p * M * M;
  const T* su_np = su + t.np * D2 * M;
  const T* sw_np = sw + t.np * D2 * M;
  for (int c = tid; c < kFT * kFT; c += kTileThreads) {
    const int a = c / kFT, b = c % kFT;
    const bool ok = t.i0 + a < M && t.j0 + b < M;
    cp_async_elem(q + a * LD + b, ok ? qm_p + (size_t)(t.i0 + a) * M + t.j0 + b : qm_p, ok);
  }
  for (int c = tid; c < DM * kFT; c += kTileThreads) {
    const int d = c / kFT, b = c % kFT;
    const bool row = d < D2 && t.i0 + b < M, col = d < D2 && t.j0 + b < M;
    cp_async_elem(su_s + d * LD + b, row ? su_np + (size_t)d * M + t.i0 + b : su_np, row);
    cp_async_elem(sw_s + d * LD + b, col ? sw_np + (size_t)d * M + t.j0 + b : sw_np, col);
  }
  for (int c = tid; c < kMaxR * kFT; c += kTileThreads) {
    const int r = c / kFT, b = c % kFT;
    const bool row = r < R && t.i0 + b < M;
    cp_async_elem(al_s + c, row ? alu + ((size_t)t.p * R + r) * M + t.i0 + b : alu, row);
  }
}

// The forward's tiles. Thread (r, c) = (tid / kFT, tid % kFT), r <= R, sums
// over the tile's rows in order alu[r][i] E[i][c] (r < R) or qm[i][c]
// E[i][c] (r = R) into row r of its column slab: part[n][p][ti] ((R + 1) x
// M: evc's rows, then qcol's), or evc and qcol themselves when nt = 1.
template <typename T, int DM>
__global__ void __launch_bounds__(kTileThreads) fwd_tiles(
    const T* __restrict__ su, const T* __restrict__ sw, const T* __restrict__ alu,
    const T* __restrict__ qm, T* __restrict__ evc, T* __restrict__ qcol, T* __restrict__ part,
    int P, int D2, int M, int R) {
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  using Smem = FwdSmem<T, DM>;
  constexpr int LD = Smem::LD;
  const Smem s(reinterpret_cast<T*>(dyn_raw));
  const TileAt t(P, M);
  stage_tile<T, DM>(t, su, sw, alu, qm, s.q, s.su, s.sw, s.al, D2, M, R);
  cp_async_wait_all();
  __syncthreads();
  exponent_tile(s.su, s.sw, D2, [&](int i, int j, T x) {
    const T e = ex(-x);
    s.e[i * LD + j] = e;
    s.q[i * LD + j] *= e;
  });
  __syncthreads();
  const int c = threadIdx.x % kFT, r = threadIdx.x / kFT, j = t.j0 + c;
  if (r > R || j >= M) return;
  T acc = T(0);
  if (r < R) {
#pragma unroll 8
    for (int i = 0; i < kFT; ++i) acc = fm(s.al[r * kFT + i], s.e[i * LD + c], acc);
  } else {
#pragma unroll 8
    for (int i = 0; i < kFT; ++i) acc += s.q[i * LD + c];
  }
  if (t.nt > 1)
    part[((t.np * t.nt + t.ti) * (R + 1) + r) * M + j] = acc;
  else if (r < R)
    evc[(t.np * R + r) * M + j] = acc;
  else
    qcol[t.np * M + j] = acc;
}

// A thread per output value: evc and qcol from their partials (part:
// (N P, nt, R + 1, M)), the row tiles added in order.
template <typename T>
__global__ void __launch_bounds__(256) fwd_finish(const T* __restrict__ part, T* __restrict__ evc,
                                                   T* __restrict__ qcol, int NP, int M, int R, int nt) {
  const size_t slab = (size_t)(R + 1) * M;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)NP * slab) return;
  const size_t np = idx / slab, rj = idx % slab;
  const T* a = part + np * nt * slab + rj;
  T x = T(0);
  for (int k = 0; k < nt; ++k) x += a[k * slab];
  if (rj < (size_t)R * M)
    evc[np * R * M + rj] = x;
  else
    qcol[np * M + rj - (size_t)R * M] = x;
}

// The frozen backward's tiles. A tile's row partial goes to
// dsu_p[n][p][tj] and its column partial to dsw_p[n][p][ti] (each D2 x M;
// with nt = 1 these are dsu and dsw themselves).
template <typename T, int DM>
__global__ void __launch_bounds__(kTileThreads) bwd_frozen_tiles(
    const T* __restrict__ su, const T* __restrict__ sw, const T* __restrict__ alu,
    const T* __restrict__ qm, const T* __restrict__ devc, const T* __restrict__ dqcol,
    T* __restrict__ dsu_p, T* __restrict__ dsw_p, int P, int D2, int M, int R) {
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  const FrozenSmem<T, DM> s(reinterpret_cast<T*>(dyn_raw));
  const TileAt t(P, M);
  const int tid = threadIdx.x;
  stage_tile<T, DM>(t, su, sw, alu, qm, s.g, s.su, s.sw, s.al, D2, M, R);
  for (int c = tid; c < kMaxR * kFT; c += kTileThreads) {
    const int r = c / kFT, b = c % kFT;
    const bool col = r < R && t.j0 + b < M;
    cp_async_elem(s.dv + c, col ? devc + (t.np * R + r) * M + t.j0 + b : devc, col);
  }
  for (int c = tid; c < kFT; c += kTileThreads) {
    const bool col = t.j0 + c < M;
    cp_async_elem(s.dq + c, col ? dqcol + t.np * M + t.j0 + c : dqcol, col);
  }
  cp_async_wait_all();
  __syncthreads();
  grad_tile(s, D2);
  __syncthreads();
  const size_t slab = (size_t)D2 * M;
  partials(s, D2, M, t.i0, t.j0, dsu_p + (t.np * t.nt + t.tj) * slab, dsw_p + (t.np * t.nt + t.ti) * slab);
}

// A thread per output value: dsu and dsw from their partials (part holds
// dsu's (N P, nt, D2, M) and then dsw's), the tiles added in order.
template <typename T>
__global__ void __launch_bounds__(256) bwd_frozen_finish(const T* __restrict__ part, T* __restrict__ dsu,
                                                          T* __restrict__ dsw, int NP, int D2, int M, int nt) {
  const size_t slab = (size_t)D2 * M, total = (size_t)NP * slab;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t np = idx / slab, r = idx % slab;
  const T* a = part + np * nt * slab + r;
  const T* b = a + total * nt;
  T x = T(0), y = T(0);
  for (int t = 0; t < nt; ++t) {
    x += a[t * slab];
    y += b[t * slab];
  }
  dsu[idx] = x;
  dsw[idx] = y;
}

inline bool bad_shape(int N, int P, int D2, int M, int R) {
  return N <= 0 || P <= 0 || D2 <= 0 || D2 > kMaxD2 || M <= 0 || R <= 0 || R > kMaxR;
}

inline int tiles(int M) { return (M + kLanes - 1) / kLanes; }

// The tile blocks' dynamic shared memory, set as the kernel's limit first.
template <typename K>
int smem_limit(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DM>
int fwd_tiled(const T* su, const T* sw, const T* alu, const T* qm, T* evc, T* qcol, T* part,
              int N, int P, int D2, int M, int R, cudaStream_t st) {
  const int nt = cdiv(M, kFT);
  const size_t bytes = FwdSmem<T, DM>::elems() * sizeof(T);
  int err = smem_limit(fwd_tiles<T, DM>, bytes);
  if (err) return err;
  fwd_tiles<T, DM><<<dim3(nt * nt, P, N), kTileThreads, bytes, st>>>(su, sw, alu, qm, evc, qcol, part,
                                                                      P, D2, M, R);
  err = (int)cudaGetLastError();
  if (err || nt == 1) return err;
  const size_t total = (size_t)N * P * (R + 1) * M;
  fwd_finish<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, evc, qcol, N * P, M, R, nt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const T* su, const T* sw, const T* alu, const T* qm, T* evc, T* qcol, T* part,
               int N, int P, int D2, int M, int R, void* stream) {
  if (bad_shape(N, P, D2, M, R)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D2 <= 16) return fwd_tiled<T, 16>(su, sw, alu, qm, evc, qcol, part, N, P, D2, M, R, st);
  return fwd_tiled<T, 32>(su, sw, alu, qm, evc, qcol, part, N, P, D2, M, R, st);
}

template <typename T, int DM>
void bwd_pair(const T* su, const T* sw, const T* alu, const T* qm, const T* devc,
              const T* dqcol, T* dsu, T* dsw, T* dalu, T* dqm,
              int N, int P, int D2, int M, int R, cudaStream_t st) {
  const dim3 grid(tiles(M), P), block(kLanes, kGroups);
  bwd_cols_kernel<T, DM><<<grid, block, 0, st>>>(su, sw, alu, qm, devc, dqcol, dsw, dqm, N, P, D2, M, R);
  bwd_rows_kernel<T, DM><<<grid, block, 0, st>>>(su, sw, alu, qm, devc, dqcol, dsu, dalu, N, P, D2, M, R);
}

template <typename T>
int launch_bwd(const T* su, const T* sw, const T* alu, const T* qm, const T* devc,
               const T* dqcol, T* dsu, T* dsw, T* dalu, T* dqm,
               int N, int P, int D2, int M, int R, void* stream) {
  if (bad_shape(N, P, D2, M, R)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D2 <= 16)
    bwd_pair<T, 16>(su, sw, alu, qm, devc, dqcol, dsu, dsw, dalu, dqm, N, P, D2, M, R, st);
  else
    bwd_pair<T, 32>(su, sw, alu, qm, devc, dqcol, dsu, dsw, dalu, dqm, N, P, D2, M, R, st);
  return (int)cudaGetLastError();
}

template <typename T, int DM>
int frozen_tiles(const T* su, const T* sw, const T* alu, const T* qm, const T* devc, const T* dqcol,
                 T* dsu, T* dsw, T* part, int N, int P, int D2, int M, int R, cudaStream_t st) {
  const int nt = cdiv(M, kFT);
  const size_t bytes = FrozenSmem<T, DM>::elems() * sizeof(T);
  int err = smem_limit(bwd_frozen_tiles<T, DM>, bytes);
  if (err) return err;
  T* dsu_p = nt == 1 ? dsu : part;
  T* dsw_p = nt == 1 ? dsw : part + (size_t)N * P * nt * D2 * M;
  bwd_frozen_tiles<T, DM><<<dim3(nt * nt, P, N), kTileThreads, bytes, st>>>(
      su, sw, alu, qm, devc, dqcol, dsu_p, dsw_p, P, D2, M, R);
  err = (int)cudaGetLastError();
  if (err || nt == 1) return err;
  const size_t total = (size_t)N * P * D2 * M;
  bwd_frozen_finish<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, dsu, dsw, N * P, D2, M, nt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_frozen(const T* su, const T* sw, const T* alu, const T* qm, const T* devc,
                      const T* dqcol, T* dsu, T* dsw, T* part, int N, int P, int D2, int M, int R,
                      void* stream) {
  if (bad_shape(N, P, D2, M, R)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D2 <= 16) return frozen_tiles<T, 16>(su, sw, alu, qm, devc, dqcol, dsu, dsw, part, N, P, D2, M, R, st);
  return frozen_tiles<T, 32>(su, sw, alu, qm, devc, dqcol, dsu, dsw, part, N, P, D2, M, R, st);
}

}  // namespace

// The forward's `part` is its partials' scratch, N x P x ceil(M / 32) x
// (R + 1) x M values (ops/kexp_cuda.py:forward_partials), the frozen
// entry's 2 x N x P x ceil(M / 32) x D2 x M values (frozen_partials); each
// is unused when one tile covers M.
#define PAIR_CONTRACT_ENTRIES(T, SFX)                                                        \
  extern "C" int pair_contract_fwd_##SFX(const T* su, const T* sw, const T* alu,          \
                                         const T* qm, T* evc, T* qcol, T* part, int N,    \
                                         int P, int D2, int M, int R, void* stream) {     \
    return launch_fwd<T>(su, sw, alu, qm, evc, qcol, part, N, P, D2, M, R, stream);       \
  }                                                                                        \
  extern "C" int pair_contract_bwd_##SFX(const T* su, const T* sw, const T* alu,          \
                                         const T* qm, const T* devc, const T* dqcol,      \
                                         T* dsu, T* dsw, T* dalu, T* dqm, int N, int P,   \
                                         int D2, int M, int R, void* stream) {            \
    return launch_bwd<T>(su, sw, alu, qm, devc, dqcol, dsu, dsw, dalu, dqm,               \
                         N, P, D2, M, R, stream);                                          \
  }                                                                                        \
  extern "C" int pair_contract_bwd_frozen_##SFX(const T* su, const T* sw, const T* alu,   \
                                                const T* qm, const T* devc,               \
                                                const T* dqcol, T* dsu, T* dsw, T* part,  \
                                                int N, int P, int D2, int M, int R,       \
                                                void* stream) {                           \
    return launch_bwd_frozen<T>(su, sw, alu, qm, devc, dqcol, dsu, dsw, part, N, P, D2,   \
                                M, R, stream);                                             \
  }

PAIR_CONTRACT_ENTRIES(float, f32)
PAIR_CONTRACT_ENTRIES(double, f64)
