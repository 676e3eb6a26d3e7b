// PSD guard and Euler moment update of the MM rollout step for Hopper
// (sm_90a), float32 and float64.
//
// Replaces the TPU kernels of gpflowpilco_tpu/ops/mm_glue_pallas.py:
//   psd_boost_{f32,f64}    <- _psd_kernel (:87), launched by _psd_boost (:97)
//   euler_update_{f32,f64} <- _euler_kernel (:130), launched by _euler_update (:158)
//
// psd_boost:    out = sym(S) + (max(0, -lambda_min(sym(S))) + jitter) I
// euler_update: new_m = m + dt f1
//               C = sym(S + (dt (Sxf + Sxf^T) + dt^2 Sff)), then the same boost
//               when `project` (jitter != 0); symmetrize only otherwise.
// lambda_min comes from five Jacobi sweeps, each rotating every pair (p, q)
// once, with the Golub-Van Loan tangent of mm_glue_pallas._jacobi_min_eig
// (:33-68). The boost is stop-gradient: the backwards are plain torch.
//
// Bound on an H100: a 6 x 6 matrix is 288 bytes in float64 and ~5 x 15
// rotations of ~40 operations, far below one launch's cost, so both kernels
// are latency-bound: at N = 1 the time is the chain of dependent rotations,
// each angle an sqrt, a divide and an rsqrt in sequence. Design: the
// PSD boost (psd_kernel) runs one thread per batch entry, the matrix in
// registers; the Euler update (euler_warp) a warp per batch entry, whose
// lanes load the operands in one wave, form one entry each, gather the
// matrix by shuffles and run that thread's chain, each lane redundantly,
// then write one entry each. For D <= 8 the kernels are
// instantiated on the exact D (DM = D, no runtime guards) and a sweep runs
// in the round-robin order (jacobi_rounds): D - 1 rounds (D rounds for odd
// D) of disjoint pairs, whose angles read disjoint entries and so are
// computed together as independent instruction streams, then applied one
// after the other. A sweep's chain is then one angle a round: 5 at D = 6,
// against 15 in the cyclic order. Float32 takes the angle's square root and
// divide from the SFU (sqrt.approx, __fdividef); float64 stays IEEE. The
// order differs from the JAX kernel's row-cyclic one, so the two agree to
// rounding once the sweeps have converged (ops/mm_glue_cuda.py:
// jacobi_rounds; tests/test_torch_mm_glue.py restates it). D in 9..16 (on
// no path) keeps one thread a matrix and the cyclic order in loops over the
// capacity DM = 16 guarded by the runtime D; its matrix lives in local
// memory. The sweep loop is not unrolled, which keeps the code small.
//
// Each entry returns cudaGetLastError() as an int; the caller raises on
// nonzero. Entries launch on the given stream and do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSweeps = 5;

// A loop of DM or fewer trips (a constant count) over a capacity DM: a full
// unroll up to DM = 8, a runtime loop at DM = 16.
#define UNROLL_DM _Pragma("unroll (DM <= 8 ? DM : 1)")

// The rotation (c, s) that zeroes a[p][q] (Golub-Van Loan tangent); float32
// with the SFU's square root and divide (the #else branch is what a host
// compiler sees), float64 IEEE.
__device__ __forceinline__ void angle(float app, float aqq, float apq, float& c, float& s) {
  const float h = aqq - app;
  const float sgn = h < 0.f ? -1.f : 1.f;
  float root = h * h + 4.f * apq * apq;
#ifdef __CUDA_ARCH__
  asm("sqrt.approx.f32 %0, %0;" : "+f"(root));
#else
  root = sqrtf(root);
#endif
  const float t = __fdividef(2.f * apq * sgn, fabsf(h) + root + 1e-37f);
  c = rsqrtf(1.f + t * t);
  s = t * c;
}
__device__ __forceinline__ void angle(double app, double aqq, double apq, double& c, double& s) {
  const double h = aqq - app;
  const double sgn = h < 0.0 ? -1.0 : 1.0;
  const double t = 2.0 * apq * sgn / (fabs(h) + sqrt(h * h + 4.0 * apq * apq) + 1e-37);
  c = rsqrt(1.0 + t * t);
  s = t * c;
}

// The round-robin (circle) order of the pairs of 0..D-1: n = D rounded up
// to even; round r < n - 1 pairs r with n - 1 and (r + k) mod (n - 1) with
// (r - k) mod (n - 1) for k = 1 .. n/2 - 1; a pair holding n - 1 = D (odd
// D) is skipped. rr_p < rr_q are slot k's pair (mm_glue_cuda.jacobi_rounds).
__host__ __device__ constexpr int rr_a(int d, int r, int k) {
  return k == 0 ? r : (r + k) % (d + (d & 1) - 1);
}
__host__ __device__ constexpr int rr_b(int d, int r, int k) {
  return k == 0 ? d + (d & 1) - 1 : (r - k + d + (d & 1) - 1) % (d + (d & 1) - 1);
}
__host__ __device__ constexpr int rr_p(int d, int r, int k) {
  return rr_a(d, r, k) < rr_b(d, r, k) ? rr_a(d, r, k) : rr_b(d, r, k);
}
__host__ __device__ constexpr int rr_q(int d, int r, int k) {
  return rr_a(d, r, k) < rr_b(d, r, k) ? rr_b(d, r, k) : rr_a(d, r, k);
}

// a <- J^T a J for the rotation (c, s) in the (p, q) plane, a[p][q] set to 0
template <typename T, int D>
__device__ __forceinline__ void rotate(T (&a)[D][D], int p, int q, T c, T s) {
  const T apq = a[p][q], app = a[p][p], aqq = a[q][q];
  a[p][p] = c * c * app - T(2) * s * c * apq + s * s * aqq;
  a[q][q] = s * s * app + T(2) * s * c * apq + c * c * aqq;
  a[p][q] = T(0);
  a[q][p] = T(0);
#pragma unroll
  for (int r = 0; r < D; ++r) {
    if (r != p && r != q) {
      const T arp = a[r][p], arq = a[r][q];
      a[r][p] = c * arp - s * arq;
      a[p][r] = a[r][p];
      a[r][q] = s * arp + c * arq;
      a[q][r] = a[r][q];
    }
  }
}

// Smallest eigenvalue of the symmetric D x D matrix a (destroyed), D <= 8:
// five sweeps of round-robin rounds.
template <typename T, int D>
__device__ __forceinline__ T jacobi_rounds(T (&a)[D][D]) {
  constexpr int n = D + (D & 1), K = n / 2;
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
#pragma unroll
    for (int r = 0; r < n - 1; ++r) {
      T c[K], s[K];
#pragma unroll
      for (int k = 0; k < K; ++k)  // the round's angles: disjoint entries, independent
        if (rr_q(D, r, k) < D) angle(a[rr_p(D, r, k)][rr_p(D, r, k)], a[rr_q(D, r, k)][rr_q(D, r, k)],
                                     a[rr_p(D, r, k)][rr_q(D, r, k)], c[k], s[k]);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (rr_q(D, r, k) < D) rotate(a, rr_p(D, r, k), rr_q(D, r, k), c[k], s[k]);
    }
  }
  T lam = a[0][0];
#pragma unroll
  for (int i = 1; i < D; ++i) lam = fmin(lam, a[i][i]);
  return lam;
}

// Smallest eigenvalue of the symmetric d x d block of a (destroyed), d <=
// DM: five cyclic sweeps in the JAX kernel's order over the capacity DM
// (rows and columns past d are zero and stay zero)
template <typename T, int DM>
__device__ __forceinline__ T jacobi_cyclic(T (&a)[DM][DM], int d) {
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
UNROLL_DM
    for (int p = 0; p < DM - 1; ++p) {
UNROLL_DM
      for (int q = 0; q < DM; ++q) {
        if (q > p && q < d) {
          T c, s;
          angle(a[p][p], a[q][q], a[p][q], c, s);
          rotate(a, p, q, c, s);
        }
      }
    }
  }
  T lam = a[0][0];
UNROLL_DM
  for (int i = 1; i < DM; ++i)
    if (i < d) lam = fmin(lam, a[i][i]);
  return lam;
}

// lambda_min of the symmetric d x d block of a (destroyed): the exact-D
// round-robin sweeps for DM <= 8 (then d == DM), else the cyclic ones
template <typename T, int DM>
__device__ __forceinline__ T jacobi_min_eig(T (&a)[DM][DM], int d) {
  if constexpr (DM <= 8)
    return jacobi_rounds<T, DM>(a);
  else
    return jacobi_cyclic<T, DM>(a, d);
}

// sym (d x d, registers) -> out + boost on the diagonal.
template <typename T, int DM>
__device__ __forceinline__ void write_boosted(const T (&sym)[DM][DM], T* out, int d, T jitter) {
  T a[DM][DM];
UNROLL_DM
  for (int i = 0; i < DM; ++i)
UNROLL_DM
    for (int j = 0; j < DM; ++j) a[i][j] = (i < d && j < d) ? sym[i][j] : T(0);
  const T lam = jacobi_min_eig<T, DM>(a, d);
  const T boost = fmax(-lam, T(0)) + jitter;
UNROLL_DM
  for (int i = 0; i < DM; ++i)
UNROLL_DM
    for (int j = 0; j < DM; ++j)
      if (i < d && j < d) out[i * d + j] = i == j ? sym[i][j] + boost : sym[i][j];
}

// DM: the exact D for D <= 8 (d_arg is then DM), else the capacity 16
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) psd_kernel(const T* __restrict__ s, T* __restrict__ out,
                                                      int N, int d_arg, T jitter) {
  const int d = DM <= 8 ? DM : d_arg;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const T* sn = s + (size_t)n * d * d;
  T sym[DM][DM];
UNROLL_DM
  for (int i = 0; i < DM; ++i)
UNROLL_DM
    for (int j = 0; j < DM; ++j)
      sym[i][j] = (i < d && j < d) ? T(0.5) * (sn[i * d + j] + sn[j * d + i]) : T(0);
  write_boosted<T, DM>(sym, out + (size_t)n * d * d, d, jitter);
}

// K5b for D in 9..16 (on no path): one thread a matrix, over the capacity
// DM = 16 guarded by the runtime d (the cyclic sweeps)
template <typename T>
__global__ void __launch_bounds__(kThreads) euler_kernel(
    const T* __restrict__ m, const T* __restrict__ s, const T* __restrict__ f1,
    const T* __restrict__ sff, const T* __restrict__ sxf, T* __restrict__ nm, T* __restrict__ nc,
    int N, int d, T dt, T jitter, bool project) {
  constexpr int DM = 16;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const size_t v = (size_t)n * d, mat = (size_t)n * d * d;
  for (int i = 0; i < d; ++i) nm[v + i] = m[v + i] + dt * f1[v + i];
  T full[DM][DM];
UNROLL_DM
  for (int i = 0; i < DM; ++i)
UNROLL_DM
    for (int j = 0; j < DM; ++j) {
      if (i < d && j < d) {
        const size_t ij = mat + i * d + j;
        const T extra = dt * (sxf[ij] + sxf[mat + j * d + i]) + (dt * dt) * sff[ij];
        full[i][j] = s[ij] + extra;
      } else {
        full[i][j] = T(0);
      }
    }
  T sym[DM][DM];
UNROLL_DM
  for (int i = 0; i < DM; ++i)
UNROLL_DM
    for (int j = 0; j < DM; ++j) sym[i][j] = T(0.5) * (full[i][j] + full[j][i]);
  T* out = nc + mat;
  if (project) {
    write_boosted<T, DM>(sym, out, d, jitter);
  } else {
UNROLL_DM
    for (int i = 0; i < DM; ++i)
UNROLL_DM
      for (int j = 0; j < DM; ++j)
        if (i < d && j < d) out[i * d + j] = sym[i][j];
  }
}

// K5b for D <= 8: a warp per batch entry (a block is one warp, the grid the
// batch). Lane e takes entry e = i D + j of the matrix (and e + 32 for D >
// 5): it loads s, sff and sxf at (i, j) and (j, i) in one wave with the
// mean's operands (lanes below D), and forms sym_ij, the same value as lane
// (j, i)'s. With the boost, every lane gathers the upper triangle by
// __shfl_sync and runs jacobi_rounds on it in registers, the one-thread
// chain of psd_kernel, redundantly and with no communication inside it
// (a round's rotations split over the lanes wait for two shuffles a round,
// and measured slower); then each lane writes its entries once, coalesced.
template <typename T, int D>
__global__ void __launch_bounds__(32) euler_warp(
    const T* __restrict__ m, const T* __restrict__ s, const T* __restrict__ f1,
    const T* __restrict__ sff, const T* __restrict__ sxf, T* __restrict__ nm, T* __restrict__ nc,
    T dt, T jitter, bool project) {
  constexpr int kE = (D * D + 31) / 32;  // entries a lane
  const int lane = threadIdx.x;
  const size_t v = (size_t)blockIdx.x * D, mat = (size_t)blockIdx.x * D * D;
  if (lane < D) nm[v + lane] = m[v + lane] + dt * f1[v + lane];
  T sym[kE];
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const int e = lane + 32 * r;
    sym[r] = T(0);
    if (e < D * D) {
      const size_t ij = mat + e, ji = mat + e % D * D + e / D;
      const T full_ij = s[ij] + (dt * (sxf[ij] + sxf[ji]) + (dt * dt) * sff[ij]);
      const T full_ji = s[ji] + (dt * (sxf[ji] + sxf[ij]) + (dt * dt) * sff[ji]);
      sym[r] = T(0.5) * (full_ij + full_ji);
    }
  }
  T boost = T(0);
  if (project) {
    T a[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j)
        a[i][j] = a[j][i] = __shfl_sync(0xffffffffu, sym[(i * D + j) / 32], (i * D + j) % 32);
    boost = fmax(-jacobi_rounds<T, D>(a), T(0)) + jitter;
  }
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const int e = lane + 32 * r;
    if (e < D * D) nc[mat + e] = project && e / D == e % D ? sym[r] + boost : sym[r];
  }
}

inline int blocks(int N) { return (N + kThreads - 1) / kThreads; }

// KERNEL<T, D> launched as <<<GRID, BLOCK>>> for d = D <= 8, the exact-D
// instantiations
#define MM_GLUE_EXACT_D(KERNEL, T, GRID, BLOCK, ...)                                \
  case 1: KERNEL<T, 1><<<GRID, BLOCK, 0, st>>>(__VA_ARGS__); break;                 \
  case 2: KERNEL<T, 2><<<GRID, BLOCK, 0, st>>>(__VA_ARGS__); break;                 \
  case 3: KERNEL<T, 3><<<GRID, BLOCK, 0, st>>>(__VA_ARGS__); break;                 \
  case 4: KERNEL<T, 4><<<GRID, BLOCK, 0, st>>>(__VA_ARGS__); break;                 \
  case 5: KERNEL<T, 5><<<GRID, BLOCK, 0, st>>>(__VA_ARGS__); break;                 \
  case 6: KERNEL<T, 6><<<GRID, BLOCK, 0, st>>>(__VA_ARGS__); break;                 \
  case 7: KERNEL<T, 7><<<GRID, BLOCK, 0, st>>>(__VA_ARGS__); break;                 \
  case 8: KERNEL<T, 8><<<GRID, BLOCK, 0, st>>>(__VA_ARGS__); break;

template <typename T>
int launch_psd(const T* s, T* out, int N, int d, double jitter, void* stream) {
  if (N <= 0 || d <= 0 || d > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    MM_GLUE_EXACT_D(psd_kernel, T, blocks(N), kThreads, s, out, N, d, (T)jitter)
    default: psd_kernel<T, 16><<<blocks(N), kThreads, 0, st>>>(s, out, N, d, (T)jitter);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_euler(const T* m, const T* s, const T* f1, const T* sff, const T* sxf, T* nm, T* nc,
                 int N, int d, double dt, double jitter, void* stream) {
  if (N <= 0 || d <= 0 || d > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool project = jitter != 0.0;
  switch (d) {
    MM_GLUE_EXACT_D(euler_warp, T, N, 32, m, s, f1, sff, sxf, nm, nc, (T)dt, (T)jitter, project)
    default:
      euler_kernel<T><<<blocks(N), kThreads, 0, st>>>(m, s, f1, sff, sxf, nm, nc, N, d, (T)dt, (T)jitter, project);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define MM_GLUE_ENTRIES(T, SFX)                                                                  \
  extern "C" int psd_boost_##SFX(const T* s, T* out, int N, int d, double jitter,             \
                                 void* stream) {                                              \
    return launch_psd<T>(s, out, N, d, jitter, stream);                                        \
  }                                                                                            \
  extern "C" int euler_update_##SFX(const T* m, const T* s, const T* f1, const T* sff,        \
                                    const T* sxf, T* nm, T* nc, int N, int d, double dt,      \
                                    double jitter, void* stream) {                            \
    return launch_euler<T>(m, s, f1, sff, sxf, nm, nc, N, d, dt, jitter, stream);             \
  }

MM_GLUE_ENTRIES(float, f32)
MM_GLUE_ENTRIES(double, f64)
