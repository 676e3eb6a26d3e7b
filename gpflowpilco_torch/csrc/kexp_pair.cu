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
// Design: E is recomputed per (i, j) in registers and reduced on the fly. A
// block is 32 lanes x 4 warps. The forward and the column pass of the
// backward give each lane a column j (so qm, dqm and every output row are
// read and written coalesced) and split the rows i among the 4 warps; su
// (and alu) are staged in shared memory 32 rows at a time and broadcast to
// the warp. The row pass gives each lane a row i and splits the columns
// among the warps, staging sw, devc, dqcol and a transposed tile of qm. The
// warps' partial sums meet in shared memory in a fixed order, so results
// are bit-identical from run to run (no atomics). Grids are (column or row
// tiles of 32) x pairs, and x batch for the forward: 80 blocks at the
// drift's shapes, where the TPU kernel ran one grid step per pair; M is not
// padded, the ragged tile is masked. Full-precision expf/exp (no fast math).
//
// Each entry returns cudaGetLastError() as an int; the caller raises on
// nonzero. Entries launch on the given stream and do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;   // columns (forward, column pass) or rows (row pass) per block
constexpr int kGroups = 4;   // warps per block
constexpr int kThreads = kLanes * kGroups;
constexpr int kChunk = 32;   // rows or columns staged in shared memory at a time
constexpr int kMaxR = 4;     // alu rows (R=1 for the SVGP pair grid)
constexpr int kMaxD2 = 32;

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

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const T* __restrict__ su, const T* __restrict__ sw, const T* __restrict__ alu,
    const T* __restrict__ qm, T* __restrict__ evc, T* __restrict__ qcol,
    int P, int D2, int M, int R) {
  __shared__ T su_s[DM][kChunk];
  __shared__ T alu_s[kMaxR][kChunk];
  __shared__ T red[kGroups * kLanes];
  const int p = blockIdx.y, n = blockIdx.z;
  const int j = blockIdx.x * kLanes + threadIdx.x;
  const bool col = j < M;
  const size_t np = (size_t)n * P + p;
  const T* su_np = su + np * D2 * M;
  const T* sw_np = sw + np * D2 * M;
  const T* qm_p = qm + (size_t)p * M * M;

  T swj[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) swj[d] = (col && d < D2) ? sw_np[(size_t)d * M + j] : T(0);
  T acc[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) acc[r] = T(0);
  T q = T(0);

  for (int i0 = 0; i0 < M; i0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
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
        q = fm(qm_p[(size_t)(i0 + ii) * M + j], e, q);
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) acc[r] = fm(alu_s[r][ii], e, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r < R) {  // uniform across the block
      const T total = group_sum(acc[r], red);
      if (threadIdx.y == 0 && col) evc[(np * R + r) * M + j] = total;
    }
  }
  const T total = group_sum(q, red);
  if (threadIdx.y == 0 && col) qcol[np * M + j] = total;
}

// Column pass of the backward: dsw, and (MODEL) dqm summed over the batch.
// Each (i, j) belongs to one thread for every n, so dqm accumulates by a
// plain read-modify-write in a fixed order.
template <typename T, int DM, bool MODEL>
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
  T* dqm_p = MODEL ? dqm + (size_t)p * M * M : nullptr;

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
          if (MODEL) dqm_p[ij] = n == 0 ? e * dq : fm(e, dq, dqm_p[ij]);
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

// Row pass of the backward: dsu, and (MODEL) dalu summed over the batch.
template <typename T, int DM, bool MODEL>
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
          if (MODEL) {
#pragma unroll
            for (int r = 0; r < kMaxR; ++r) da[r] = fm(dv_s[r][jj], e, da[r]);
          }
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
  if (MODEL) {
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < R) {
        const T total = group_sum(da[r], red);
        if (threadIdx.y == 0 && row) dalu[((size_t)p * R + r) * M + i] = total;
      }
    }
  }
}

inline bool bad_shape(int N, int P, int D2, int M, int R) {
  return N <= 0 || P <= 0 || D2 <= 0 || D2 > kMaxD2 || M <= 0 || R <= 0 || R > kMaxR;
}

inline int tiles(int M) { return (M + kLanes - 1) / kLanes; }

template <typename T>
int launch_fwd(const T* su, const T* sw, const T* alu, const T* qm, T* evc, T* qcol,
               int N, int P, int D2, int M, int R, void* stream) {
  if (bad_shape(N, P, D2, M, R)) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles(M), P, N), block(kLanes, kGroups);
  cudaStream_t st = (cudaStream_t)stream;
  if (D2 <= 16)
    fwd_kernel<T, 16><<<grid, block, 0, st>>>(su, sw, alu, qm, evc, qcol, P, D2, M, R);
  else
    fwd_kernel<T, 32><<<grid, block, 0, st>>>(su, sw, alu, qm, evc, qcol, P, D2, M, R);
  return (int)cudaGetLastError();
}

template <typename T, int DM, bool MODEL>
void bwd_pair(const T* su, const T* sw, const T* alu, const T* qm, const T* devc,
              const T* dqcol, T* dsu, T* dsw, T* dalu, T* dqm,
              int N, int P, int D2, int M, int R, cudaStream_t st) {
  const dim3 grid(tiles(M), P), block(kLanes, kGroups);
  bwd_cols_kernel<T, DM, MODEL><<<grid, block, 0, st>>>(
      su, sw, alu, qm, devc, dqcol, dsw, dqm, N, P, D2, M, R);
  bwd_rows_kernel<T, DM, MODEL><<<grid, block, 0, st>>>(
      su, sw, alu, qm, devc, dqcol, dsu, dalu, N, P, D2, M, R);
}

template <typename T, bool MODEL>
int launch_bwd(const T* su, const T* sw, const T* alu, const T* qm, const T* devc,
               const T* dqcol, T* dsu, T* dsw, T* dalu, T* dqm,
               int N, int P, int D2, int M, int R, void* stream) {
  if (bad_shape(N, P, D2, M, R)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D2 <= 16)
    bwd_pair<T, 16, MODEL>(su, sw, alu, qm, devc, dqcol, dsu, dsw, dalu, dqm, N, P, D2, M, R, st);
  else
    bwd_pair<T, 32, MODEL>(su, sw, alu, qm, devc, dqcol, dsu, dsw, dalu, dqm, N, P, D2, M, R, st);
  return (int)cudaGetLastError();
}

}  // namespace

#define PAIR_CONTRACT_ENTRIES(T, SFX)                                                        \
  extern "C" int pair_contract_fwd_##SFX(const T* su, const T* sw, const T* alu,          \
                                         const T* qm, T* evc, T* qcol, int N, int P,      \
                                         int D2, int M, int R, void* stream) {            \
    return launch_fwd<T>(su, sw, alu, qm, evc, qcol, N, P, D2, M, R, stream);             \
  }                                                                                        \
  extern "C" int pair_contract_bwd_##SFX(const T* su, const T* sw, const T* alu,          \
                                         const T* qm, const T* devc, const T* dqcol,      \
                                         T* dsu, T* dsw, T* dalu, T* dqm, int N, int P,   \
                                         int D2, int M, int R, void* stream) {            \
    return launch_bwd<T, true>(su, sw, alu, qm, devc, dqcol, dsu, dsw, dalu, dqm,         \
                               N, P, D2, M, R, stream);                                    \
  }                                                                                        \
  extern "C" int pair_contract_bwd_frozen_##SFX(const T* su, const T* sw, const T* alu,   \
                                                const T* qm, const T* devc,               \
                                                const T* dqcol, T* dsu, T* dsw, int N,    \
                                                int P, int D2, int M, int R,              \
                                                void* stream) {                           \
    return launch_bwd<T, false>(su, sw, alu, qm, devc, dqcol, dsu, dsw, nullptr, nullptr, \
                                N, P, D2, M, R, stream);                                   \
  }

PAIR_CONTRACT_ENTRIES(float, f32)
PAIR_CONTRACT_ENTRIES(double, f64)
