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
// lambda_min comes from five cyclic Jacobi sweeps in the order and with the
// Golub-Van Loan tangent of mm_glue_pallas._jacobi_min_eig (:33-68), so the
// plain torch version (ops/mm_glue_cuda.py) and this kernel agree to
// rounding. The boost is stop-gradient: the backwards are plain torch.
//
// Bound on an H100: a 6 x 6 matrix is 288 bytes in float64 and ~5 x 15
// rotations of ~40 operations, far below one launch's cost, so both kernels
// are launch- and latency-bound. Design: one thread per batch entry; the
// D x D matrix sits in registers, with every loop over a capacity DM in
// {4, 8, 16} guarded by the runtime D and, at DM = 4 and 8, unrolled, so all
// indices are compile-time constants. At DM = 16 (D in 9..16, on no path)
// the loops stay loops and the matrix lives in local memory: unrolled, that
// instantiation made most of the build time. The sweep loop is not
// unrolled, which keeps the code small.
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

__device__ __forceinline__ float rs(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rs(double x) { return rsqrt(x); }
__device__ __forceinline__ float sq(float x) { return sqrtf(x); }
__device__ __forceinline__ double sq(double x) { return sqrt(x); }

// Smallest eigenvalue of the symmetric d x d block of a (destroyed).
template <typename T, int DM>
__device__ __forceinline__ T jacobi_min_eig(T (&a)[DM][DM], int d) {
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
UNROLL_DM
    for (int p = 0; p < DM - 1; ++p) {
UNROLL_DM
      for (int q = 0; q < DM; ++q) {
        if (q > p && q < d) {
          const T apq = a[p][q], app = a[p][p], aqq = a[q][q];
          const T h = aqq - app;
          const T sgn = h < T(0) ? T(-1) : T(1);
          const T denom = fabs(h) + sq(h * h + T(4) * apq * apq) + T(1e-37);
          const T t = T(2) * apq * sgn / denom;
          const T c = rs(T(1) + t * t);
          const T s = t * c;
          a[p][p] = c * c * app - T(2) * s * c * apq + s * s * aqq;
          a[q][q] = s * s * app + T(2) * s * c * apq + c * c * aqq;
          a[p][q] = T(0);
          a[q][p] = T(0);
UNROLL_DM
          for (int r = 0; r < DM; ++r) {
            if (r < d && r != p && r != q) {
              const T arp = a[r][p], arq = a[r][q];
              a[r][p] = c * arp - s * arq;
              a[p][r] = a[r][p];
              a[r][q] = s * arp + c * arq;
              a[q][r] = a[r][q];
            }
          }
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

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) psd_kernel(const T* __restrict__ s, T* __restrict__ out,
                                                      int N, int d, T jitter) {
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

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) euler_kernel(
    const T* __restrict__ m, const T* __restrict__ s, const T* __restrict__ f1,
    const T* __restrict__ sff, const T* __restrict__ sxf, T* __restrict__ nm, T* __restrict__ nc,
    int N, int d, T dt, T jitter, bool project) {
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

inline int blocks(int N) { return (N + kThreads - 1) / kThreads; }

template <typename T>
int launch_psd(const T* s, T* out, int N, int d, double jitter, void* stream) {
  if (N <= 0 || d <= 0 || d > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 4)
    psd_kernel<T, 4><<<blocks(N), kThreads, 0, st>>>(s, out, N, d, (T)jitter);
  else if (d <= 8)
    psd_kernel<T, 8><<<blocks(N), kThreads, 0, st>>>(s, out, N, d, (T)jitter);
  else
    psd_kernel<T, 16><<<blocks(N), kThreads, 0, st>>>(s, out, N, d, (T)jitter);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_euler(const T* m, const T* s, const T* f1, const T* sff, const T* sxf, T* nm, T* nc,
                 int N, int d, double dt, double jitter, void* stream) {
  if (N <= 0 || d <= 0 || d > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool project = jitter != 0.0;
  if (d <= 4)
    euler_kernel<T, 4><<<blocks(N), kThreads, 0, st>>>(m, s, f1, sff, sxf, nm, nc, N, d, (T)dt,
                                                       (T)jitter, project);
  else if (d <= 8)
    euler_kernel<T, 8><<<blocks(N), kThreads, 0, st>>>(m, s, f1, sff, sxf, nm, nc, N, d, (T)dt,
                                                       (T)jitter, project);
  else
    euler_kernel<T, 16><<<blocks(N), kThreads, 0, st>>>(m, s, f1, sff, sxf, nm, nc, N, d, (T)dt,
                                                        (T)jitter, project);
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
