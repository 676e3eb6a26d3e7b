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
// Backward, frozen and full: one kernel (bwd_tiles, FULL = whether dalu and
// dqm are wanted) cuts each (n, p) grid into kFT x kFT = 32 x 32 tiles on
// the block grid, blocks of 256 threads: (ceil(M/32)^2, P, N) for the frozen
// backward, 640 at the drift's shape (64 x 64 tiles, 160 blocks, measured
// slower there and at the policy's shape, and no faster on the GPR route);
// (ceil(M/32)^2, P) for the full one, whose blocks take the batch entries in
// order, since dalu and dqm sum over them. A block copies its tile's su
// rows, sw columns (D2 x 32 each), alu rows, devc and dqcol columns and qm's
// tile (row order) into shared memory by cp.async (the full backward copies
// qm and alu once, su, sw and the cotangents per entry), forms the
// exponents S = su_tile^T sw_tile (depth D2), evaluates E once per cell into
// g = -E o (alu^T devc + qm o dqcol), and takes the row partial dsu_part =
// g sw_tile^T (32 x D2) and the column partial dsw_part = su_tile g (D2 x
// 32) from that one tile. The full backward also keeps E's tile, adds
// E o dqcol into dqm's tile in shared memory (each cell of dqm is one
// tile's, so it is written once) and takes dalu's row partial
// sum_j devc[r][j] E[i][j], each summed over n in order. In float64 the
// three products run on the tensor cores (DMMA, mma.sync m8n8k4, IEEE
// float64 products and sums); in float32 on the CUDA cores in full
// precision (not TF32: the exponent carries the |x|^2 + |z|^2 - 2 x.z
// cancellation). The partials go to scratch per (n, p, other tile), dalu's
// per (p, column tile), and a finish launch adds them over the tiles in a
// fixed order; with one tile (the policy's M = 30) the block writes every
// output itself and there is no finish: one launch.
//
// M is not padded: the ragged tile is masked (zero-filled operands give
// g = 0). No atomics: results are bit-identical from run to run.
// Full-precision expf/exp (no fast math). Each entry returns
// cudaGetLastError() as an int; the caller raises on nonzero. Entries launch
// on the given stream and do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxR = 4;     // alu rows (R=1 for the SVGP pair grid)
constexpr int kMaxD2 = 32;
constexpr int kTileThreads = 256;  // the tile blocks of every entry
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kFT = 32;  // their tile side; ops/kexp_cuda.py's TILE

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float fm(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fm(double a, double b, double c) { return fma(a, b, c); }

// ----------------------------------------------------------------------- tiles
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

// A backward tile block's dynamic shared memory: g (kFT x LD), the rows'
// su and the columns' sw (DM x LD each, zero beyond D2), the rows' alu and
// the columns' devc (kMaxR x kFT each, zero beyond R) and the columns'
// dqcol. The frozen backward (FULL = false) stages qm's tile in g, which g
// then overwrites; the full one keeps qm's tile (q) for every batch entry
// and adds E's tile (e) and dqm's tile summed over the batch (dqm).
template <typename T, int DM, bool FULL>
struct BwdSmem {
  static constexpr int LD = kLD<T>;
  T *g, *su, *sw, *al, *dv, *dq, *q, *e, *dqm;
  __device__ explicit BwdSmem(T* base)
      : g(base), su(g + kFT * LD), sw(su + DM * LD), al(sw + DM * LD), dv(al + kMaxR * kFT),
        dq(dv + kMaxR * kFT), q(FULL ? dq + kFT : g), e(q + kFT * LD), dqm(e + kFT * LD) {}
  static constexpr size_t elems() {
    return (size_t)(kFT + 2 * DM + (FULL ? 3 * kFT : 0)) * LD + (2 * kMaxR + 1) * kFT;
  }
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

// g = -E o (alu^T devc + qm o dqcol) over the tile (frozen: in place of
// qm's tile). The full backward also keeps E and adds E o dqcol to dqm's
// tile.
template <typename T, int DM, bool FULL>
__device__ __forceinline__ void grad_tile(const BwdSmem<T, DM, FULL>& s, int D2) {
  constexpr int LD = BwdSmem<T, DM, FULL>::LD;
  exponent_tile(s.su, s.sw, D2, [&](int i, int j, T x) {
    const int c = i * LD + j;
    T de = s.q[c] * s.dq[j];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) de = fm(s.al[r * kFT + i], s.dv[r * kFT + j], de);
    const T e = ex(-x);
    s.g[c] = -e * de;
    if constexpr (FULL) {
      s.e[c] = e;
      s.dqm[c] = fm(e, s.dq[j], s.dqm[c]);
    }
  });
}

// The tile's partials: dsu_part[d][i] = sum_j g[i][j] sw[d][j] into
// dsu_p[d * M + i0 + i] and dsw_part[d][j] = sum_i su[d][i] g[i][j] into
// dsw_p[d * M + j0 + j], for d < D2 and points below M.
// float32: thread tid takes point tid % kFT and rows d = tid / kFT + q (256/kFT).
template <int DM, bool FULL>
__device__ __forceinline__ void partials(const BwdSmem<float, DM, FULL>& s, int D2, int M, int i0, int j0,
                                         float* dsu_p, float* dsw_p) {
  constexpr int LD = kLD<float>, STEP = kTileThreads / kFT, NQ = DM / STEP;
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
template <int DM, bool FULL>
__device__ __forceinline__ void partials(const BwdSmem<double, DM, FULL>& s, int D2, int M, int i0, int j0,
                                         double* dsu_p, double* dsw_p) {
  constexpr int NT8 = kFT / 8, ND8 = DM / 8, PER = NT8 * ND8 / kTileWarps;
  constexpr int LD = kLD<double>;
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
// in [kFT tj, kFT tj + kFT). The full backward's grid has no batch axis
// (its blocks loop over n), so there np is entry 0's.
struct TileAt {
  int nt, ti, tj, i0, j0, p;
  size_t np;
  __device__ TileAt(int P, int M)
      : nt(cdiv(M, kFT)), ti(blockIdx.x / nt), tj(blockIdx.x % nt), i0(ti * kFT), j0(tj * kFT),
        p(blockIdx.y), np((size_t)blockIdx.z * P + blockIdx.y) {}
};

// The cp.async copies (not waited for) of a tile's operands, out-of-range
// cells zero-filled. The model's: qm's tile in row order into q (row stride
// LD), the rows' alu into al_s (kMaxR x kFT, zero beyond R).
template <typename T>
__device__ __forceinline__ void stage_model(const TileAt& t, const T* alu, const T* qm, T* q, T* al_s,
                                            int M, int R) {
  constexpr int LD = kLD<T>;
  const int tid = threadIdx.x;
  const T* qm_p = qm + (size_t)t.p * M * M;
  for (int c = tid; c < kFT * kFT; c += kTileThreads) {
    const int a = c / kFT, b = c % kFT;
    const bool ok = t.i0 + a < M && t.j0 + b < M;
    cp_async_elem(q + a * LD + b, ok ? qm_p + (size_t)(t.i0 + a) * M + t.j0 + b : qm_p, ok);
  }
  for (int c = tid; c < kMaxR * kFT; c += kTileThreads) {
    const int r = c / kFT, b = c % kFT;
    const bool row = r < R && t.i0 + b < M;
    cp_async_elem(al_s + c, row ? alu + ((size_t)t.p * R + r) * M + t.i0 + b : alu, row);
  }
}

// Batch entry np's: the rows' su and the columns' sw into su_s and sw_s
// (DM x LD, zero beyond D2).
template <typename T, int DM>
__device__ __forceinline__ void stage_state(const TileAt& t, size_t np, const T* su, const T* sw, T* su_s,
                                            T* sw_s, int D2, int M) {
  constexpr int LD = kLD<T>;
  const T* su_np = su + np * D2 * M;
  const T* sw_np = sw + np * D2 * M;
  for (int c = threadIdx.x; c < DM * kFT; c += kTileThreads) {
    const int d = c / kFT, b = c % kFT;
    const bool row = d < D2 && t.i0 + b < M, col = d < D2 && t.j0 + b < M;
    cp_async_elem(su_s + d * LD + b, row ? su_np + (size_t)d * M + t.i0 + b : su_np, row);
    cp_async_elem(sw_s + d * LD + b, col ? sw_np + (size_t)d * M + t.j0 + b : sw_np, col);
  }
}

// Batch entry np's cotangents: the columns' devc into dv (kMaxR x kFT, zero
// beyond R) and the columns' dqcol into dq.
template <typename T>
__device__ __forceinline__ void stage_cots(const TileAt& t, size_t np, const T* devc, const T* dqcol, T* dv,
                                           T* dq, int M, int R) {
  const int tid = threadIdx.x;
  for (int c = tid; c < kMaxR * kFT; c += kTileThreads) {
    const int r = c / kFT, b = c % kFT;
    const bool col = r < R && t.j0 + b < M;
    cp_async_elem(dv + c, col ? devc + (np * R + r) * M + t.j0 + b : devc, col);
  }
  for (int c = tid; c < kFT; c += kTileThreads) {
    const bool col = t.j0 + c < M;
    cp_async_elem(dq + c, col ? dqcol + np * M + t.j0 + c : dqcol, col);
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
  stage_model(t, alu, qm, s.q, s.al, M, R);
  stage_state<T, DM>(t, t.np, su, sw, s.su, s.sw, D2, M);
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

// The backward's tiles: blocks (nt^2, P, N) for the frozen backward, (nt^2,
// P, 1) for the full one, whose blocks take the batch in order. A tile's
// row partial goes to dsu_p[n][p][tj] and its column partial to
// dsw_p[n][p][ti] (each D2 x M; with nt = 1 these are dsu and dsw
// themselves). The full backward also takes, thread (r, i) = (tid / kFT,
// tid % kFT) for r < R, dalu's row partial sum_n sum_j devc[r][j] E[i][j]
// over the tile's columns into dalu_p[p][tj] (R x M; dalu itself with nt =
// 1), and writes dqm's tile, sum_n E o dqcol, once.
template <typename T, int DM, bool FULL>
__global__ void __launch_bounds__(kTileThreads) bwd_tiles(
    const T* __restrict__ su, const T* __restrict__ sw, const T* __restrict__ alu,
    const T* __restrict__ qm, const T* __restrict__ devc, const T* __restrict__ dqcol,
    T* __restrict__ dsu_p, T* __restrict__ dsw_p, T* __restrict__ dalu_p, T* __restrict__ dqm,
    int N, int P, int D2, int M, int R) {
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  using Smem = BwdSmem<T, DM, FULL>;
  constexpr int LD = Smem::LD;
  const Smem s(reinterpret_cast<T*>(dyn_raw));
  const TileAt t(P, M);
  const int tid = threadIdx.x, i = tid % kFT, r = tid / kFT;
  const size_t slab = (size_t)D2 * M;
  stage_model(t, alu, qm, s.q, s.al, M, R);
  T da = T(0);
  // batch entry n's tile: g, the dsu and dsw partials, and (full) dalu's
  const auto entry = [&](int n) {
    const size_t np = (size_t)n * P + t.p;
    stage_state<T, DM>(t, np, su, sw, s.su, s.sw, D2, M);
    stage_cots(t, np, devc, dqcol, s.dv, s.dq, M, R);
    cp_async_wait_all();
    __syncthreads();
    grad_tile(s, D2);
    __syncthreads();
    partials(s, D2, M, t.i0, t.j0, dsu_p + (np * t.nt + t.tj) * slab, dsw_p + (np * t.nt + t.ti) * slab);
    if constexpr (FULL) {
      if (r < R) {
        T acc = T(0);
#pragma unroll 8
        for (int j = 0; j < kFT; ++j) acc = fm(s.dv[r * kFT + j], s.e[i * LD + j], acc);
        da += acc;
      }
    }
  };
  if constexpr (!FULL) {
    entry(blockIdx.z);
  } else {
    for (int c = tid; c < kFT * LD; c += kTileThreads) s.dqm[c] = T(0);  // an fma on it is then a product
    for (int n = 0; n < N; ++n) {
      if (n > 0) __syncthreads();  // the last entry's tile is read
      entry(n);
    }
    if (r < R && t.i0 + i < M) dalu_p[(((size_t)t.p * t.nt + t.tj) * R + r) * M + t.i0 + i] = da;
    T* dqm_p = dqm + (size_t)t.p * M * M;
    for (int c = tid; c < kFT * kFT; c += kTileThreads) {
      const int a = c / kFT, b = c % kFT;
      if (t.i0 + a < M && t.j0 + b < M) dqm_p[(size_t)(t.i0 + a) * M + t.j0 + b] = s.dqm[a * LD + b];
    }
  }
}

// A thread per output value, the tiles added in order: dsu and dsw from
// their partials (part holds dsu's (N P, nt, D2, M), then dsw's), and
// dalu, unless it is null, from its (P, nt, R, M) after them.
template <typename T>
__global__ void __launch_bounds__(256) bwd_finish(const T* __restrict__ part, T* __restrict__ dsu,
                                                   T* __restrict__ dsw, T* __restrict__ dalu, int NP, int P,
                                                   int D2, int M, int R, int nt) {
  const size_t slab = (size_t)D2 * M, total = (size_t)NP * slab;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total) {
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
    return;
  }
  const size_t rslab = (size_t)R * M, k = idx - total;
  if (dalu == nullptr || k >= (size_t)P * rslab) return;
  const T* a = part + 2 * total * nt + (k / rslab) * nt * rslab + k % rslab;
  T x = T(0);
  for (int t = 0; t < nt; ++t) x += a[t * rslab];
  dalu[k] = x;
}

inline bool bad_shape(int N, int P, int D2, int M, int R) {
  return N <= 0 || P <= 0 || D2 <= 0 || D2 > kMaxD2 || M <= 0 || R <= 0 || R > kMaxR;
}

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

template <typename T, int DM, bool FULL>
int bwd_tiled(const T* su, const T* sw, const T* alu, const T* qm, const T* devc, const T* dqcol, T* dsu,
              T* dsw, T* dalu, T* dqm, T* part, int N, int P, int D2, int M, int R, cudaStream_t st) {
  const int nt = cdiv(M, kFT);
  const size_t bytes = BwdSmem<T, DM, FULL>::elems() * sizeof(T);
  int err = smem_limit(bwd_tiles<T, DM, FULL>, bytes);
  if (err) return err;
  const size_t total = (size_t)N * P * D2 * M;
  T* dsu_p = nt == 1 ? dsu : part;
  T* dsw_p = nt == 1 ? dsw : part + total * nt;
  T* dalu_p = !FULL ? nullptr : nt == 1 ? dalu : part + 2 * total * nt;
  bwd_tiles<T, DM, FULL><<<dim3(nt * nt, P, FULL ? 1 : N), kTileThreads, bytes, st>>>(
      su, sw, alu, qm, devc, dqcol, dsu_p, dsw_p, dalu_p, dqm, N, P, D2, M, R);
  err = (int)cudaGetLastError();
  if (err || nt == 1) return err;
  const size_t threads = total + (FULL ? (size_t)P * R * M : 0);
  bwd_finish<T><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(part, dsu, dsw, FULL ? dalu : nullptr,
                                                                    N * P, P, D2, M, R, nt);
  return (int)cudaGetLastError();
}

template <typename T, bool FULL>
int launch_bwd(const T* su, const T* sw, const T* alu, const T* qm, const T* devc, const T* dqcol, T* dsu,
               T* dsw, T* dalu, T* dqm, T* part, int N, int P, int D2, int M, int R, void* stream) {
  if (bad_shape(N, P, D2, M, R)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D2 <= 16)
    return bwd_tiled<T, 16, FULL>(su, sw, alu, qm, devc, dqcol, dsu, dsw, dalu, dqm, part, N, P, D2, M, R, st);
  return bwd_tiled<T, 32, FULL>(su, sw, alu, qm, devc, dqcol, dsu, dsw, dalu, dqm, part, N, P, D2, M, R, st);
}

}  // namespace

// The forward's `part` is its partials' scratch, N x P x ceil(M / 32) x
// (R + 1) x M values (ops/kexp_cuda.py:forward_partials), the frozen
// entry's 2 x N x P x ceil(M / 32) x D2 x M values (frozen_partials), the
// full entry's those and P x ceil(M / 32) x R x M more (full_partials);
// each is unused when one tile covers M.
#define PAIR_CONTRACT_ENTRIES(T, SFX)                                                           \
  extern "C" int pair_contract_fwd_##SFX(const T* su, const T* sw, const T* alu, const T* qm,   \
                                         T* evc, T* qcol, T* part, int N, int P, int D2, int M, \
                                         int R, void* stream) {                                 \
    return launch_fwd<T>(su, sw, alu, qm, evc, qcol, part, N, P, D2, M, R, stream);             \
  }                                                                                             \
  extern "C" int pair_contract_bwd_##SFX(const T* su, const T* sw, const T* alu, const T* qm,   \
                                         const T* devc, const T* dqcol, T* dsu, T* dsw,         \
                                         T* dalu, T* dqm, T* part, int N, int P, int D2, int M, \
                                         int R, void* stream) {                                 \
    return launch_bwd<T, true>(su, sw, alu, qm, devc, dqcol, dsu, dsw, dalu, dqm, part, N, P,   \
                               D2, M, R, stream);                                               \
  }                                                                                             \
  extern "C" int pair_contract_bwd_frozen_##SFX(const T* su, const T* sw, const T* alu,        \
                                                const T* qm, const T* devc, const T* dqcol,    \
                                                T* dsu, T* dsw, T* part, int N, int P, int D2, \
                                                int M, int R, void* stream) {                  \
    return launch_bwd<T, false>(su, sw, alu, qm, devc, dqcol, dsu, dsw, nullptr, nullptr, part, \
                                N, P, D2, M, R, stream);                                        \
  }

PAIR_CONTRACT_ENTRIES(float, f32)
PAIR_CONTRACT_ENTRIES(double, f64)
