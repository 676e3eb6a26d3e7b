// Fused pathwise GP drift evaluation for Hopper (sm_90a), float32.
//
// Replaces the TPU kernels of gpflowpilco_tpu/ops/path_eval_pallas.py:
//   path_eval_fwd      <- _fwd_kernel (:58), launched by _fused_fwd_impl (:155)
//   path_eval_bwd_dx   <- _bwd_dx_kernel (:102), launched by _fused_vjp_bwd (:186)
//   path_eval_bwd_full <- _bwd_kernel (:90), launched by _fused_vjp_bwd (:186)
//
// For particle s and latent l, with w and v pre-scaled by the caller:
//   f[s,l] = sum_b cos(x_s . omega_lb + phase_lb) w[s,l,b]
//          + sum_m exp(-1/2 |x_s * il_l - z_lm|^2) v[s,l,m]
// where |x~ - z~|^2 = |x~|^2 + z2_lm - 2 x~ . z~, clamped at 0.
// The backward recomputes proj and k rather than storing them:
//   dx[s,:] = sum_l g[s,l] ( -sum_b sin(proj) w omega_lb
//                            + (sum_m kv z_lm - sum_m kv x~_s) il_l ),  kv = k v
//   dw[s,l,b] = cos(proj) g[s,l],   dv[s,l,m] = k g[s,l]   (full backward only)
//
// Bound on an H100 (SXM, 3.35 TB/s): every launch must read w (S,L,B) and
// v (S,L,M) once; at S=B=1024, L=4, M=240 that is 20.7 MB, about 6.2 us.
// The arithmetic (S*L*(B+M) ~ 5.2 M transcendentals and ~76 MFLOP) is far
// below that. The design therefore streams w and v exactly once, in their
// native (S,L,*) layout with neighbouring threads on neighbouring b or m:
// one block takes a tile of kTile particles and loops over the latents;
// its threads stride over B and then over M, so each omega and z row read
// from L2 serves kTile particles. D <= 16 is held in registers (the
// template DM pads it with zeros, which add exact zeros to every dot
// product). Per-thread partial sums meet in a warp-shuffle plus
// shared-memory block reduction. The |x|^2+|z|^2-2x.z cancellation stays in
// full float32 (no fast math), as the JAX kernel pins HIGHEST precision.
//
// Each entry returns cudaGetLastError() as an int; the caller raises on
// nonzero. Entries launch on the given stream and do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4;  // particles per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums vals[i] over the block; thread i < N gets the total of entry i.
// `red` holds kWarps * N floats of shared memory.
template <int N>
__device__ __forceinline__ float block_sum(const float (&vals)[N], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float s = warp_sum(vals[i]);
    if (lane == 0) red[warp * N + i] = s;
  }
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x < N) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w * N + threadIdx.x];
  }
  __syncthreads();  // red is reused by the next call
  return total;
}

template <int DM>
__device__ __forceinline__ void load_row(float (&r)[DM], const float* p, int D) {
#pragma unroll
  for (int d = 0; d < DM; ++d) r[d] = d < D ? p[d] : 0.f;
}

template <int DM>
__device__ __forceinline__ float dot(const float (&a)[DM], const float (&b)[DM]) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <int DM>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ v, const float* __restrict__ omega,
    const float* __restrict__ phase, const float* __restrict__ z,
    const float* __restrict__ z2, const float* __restrict__ il,
    float* __restrict__ out, int S, int L, int B, int M, int D) {
  __shared__ float red[kWarps * kTile];
  const int s0 = blockIdx.x * kTile;
  const int np = min(kTile, S - s0);

  float xr[kTile][DM];
#pragma unroll
  for (int p = 0; p < kTile; ++p) {
    if (p < np) load_row(xr[p], x + (size_t)(s0 + p) * D, D);
    else load_row(xr[p], x, 0);
  }

  for (int l = 0; l < L; ++l) {
    float acc[kTile];
#pragma unroll
    for (int p = 0; p < kTile; ++p) acc[p] = 0.f;

    // RFF prior: sum_b cos(x . omega_lb + phase_lb) w[s,l,b]
    const float* om_l = omega + (size_t)l * B * D;
    for (int b = threadIdx.x; b < B; b += kThreads) {
      float o[DM];
      load_row(o, om_l + (size_t)b * D, D);
      const float ph = phase[(size_t)l * B + b];
#pragma unroll
      for (int p = 0; p < kTile; ++p) {
        if (p < np) {
          const float proj = dot(xr[p], o) + ph;
          acc[p] = fmaf(cosf(proj), w[((size_t)(s0 + p) * L + l) * B + b], acc[p]);
        }
      }
    }

    // canonical update: sum_m exp(-1/2 |x~ - z~_lm|^2) v[s,l,m]
    float ilr[DM];
    load_row(ilr, il + (size_t)l * D, D);
    float xs[kTile][DM];
    float x2[kTile];
#pragma unroll
    for (int p = 0; p < kTile; ++p) {
#pragma unroll
      for (int d = 0; d < DM; ++d) xs[p][d] = xr[p][d] * ilr[d];
      x2[p] = dot(xs[p], xs[p]);
    }
    const float* z_l = z + (size_t)l * M * D;
    for (int m = threadIdx.x; m < M; m += kThreads) {
      float zr[DM];
      load_row(zr, z_l + (size_t)m * D, D);
      const float zz = z2[(size_t)l * M + m];
#pragma unroll
      for (int p = 0; p < kTile; ++p) {
        if (p < np) {
          const float d2 = fmaxf(x2[p] + zz - 2.f * dot(xs[p], zr), 0.f);
          acc[p] = fmaf(expf(-0.5f * d2), v[((size_t)(s0 + p) * L + l) * M + m], acc[p]);
        }
      }
    }

    const float total = block_sum(acc, red);
    if (threadIdx.x < np) out[(size_t)(s0 + threadIdx.x) * L + l] = total;
  }
}

template <int DM, bool WANT_WV>
__global__ void __launch_bounds__(kThreads) bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ v, const float* __restrict__ omega,
    const float* __restrict__ phase, const float* __restrict__ z,
    const float* __restrict__ z2, const float* __restrict__ il,
    const float* __restrict__ g, float* __restrict__ dx,
    float* __restrict__ dw, float* __restrict__ dv,
    int S, int L, int B, int M, int D) {
  __shared__ float red[kWarps * kTile * DM];
  const int s0 = blockIdx.x * kTile;
  const int np = min(kTile, S - s0);

  float xr[kTile][DM];
#pragma unroll
  for (int p = 0; p < kTile; ++p) {
    if (p < np) load_row(xr[p], x + (size_t)(s0 + p) * D, D);
    else load_row(xr[p], x, 0);
  }
  // dx partial sums over this thread's b and m, over all latents
  float acc[kTile * DM];
#pragma unroll
  for (int i = 0; i < kTile * DM; ++i) acc[i] = 0.f;

  for (int l = 0; l < L; ++l) {
    float gl[kTile];
#pragma unroll
    for (int p = 0; p < kTile; ++p) gl[p] = p < np ? g[(size_t)(s0 + p) * L + l] : 0.f;

    // prior: dx -= g sin(proj) w omega_lb
    const float* om_l = omega + (size_t)l * B * D;
    for (int b = threadIdx.x; b < B; b += kThreads) {
      float o[DM];
      load_row(o, om_l + (size_t)b * D, D);
      const float ph = phase[(size_t)l * B + b];
#pragma unroll
      for (int p = 0; p < kTile; ++p) {
        if (p < np) {
          const size_t i = ((size_t)(s0 + p) * L + l) * B + b;
          const float proj = dot(xr[p], o) + ph;
          float sn, cs;
          sincosf(proj, &sn, &cs);
          const float c = gl[p] * (sn * w[i]);
#pragma unroll
          for (int d = 0; d < DM; ++d) acc[p * DM + d] = fmaf(-c, o[d], acc[p * DM + d]);
          if (WANT_WV) dw[i] = cs * gl[p];
        }
      }
    }

    // canonical: dx += g (sum_m kv z~_lm - sum_m kv x~) il_l
    float ilr[DM];
    load_row(ilr, il + (size_t)l * D, D);
    float xs[kTile][DM];
    float x2[kTile];
    float kvsum[kTile];
#pragma unroll
    for (int p = 0; p < kTile; ++p) {
#pragma unroll
      for (int d = 0; d < DM; ++d) xs[p][d] = xr[p][d] * ilr[d];
      x2[p] = dot(xs[p], xs[p]);
      kvsum[p] = 0.f;
    }
    const float* z_l = z + (size_t)l * M * D;
    for (int m = threadIdx.x; m < M; m += kThreads) {
      float zr[DM];
      load_row(zr, z_l + (size_t)m * D, D);
      const float zz = z2[(size_t)l * M + m];
#pragma unroll
      for (int p = 0; p < kTile; ++p) {
        if (p < np) {
          const size_t i = ((size_t)(s0 + p) * L + l) * M + m;
          const float d2 = fmaxf(x2[p] + zz - 2.f * dot(xs[p], zr), 0.f);
          const float k = expf(-0.5f * d2);
          const float kv = gl[p] * (k * v[i]);
          kvsum[p] += kv;
#pragma unroll
          for (int d = 0; d < DM; ++d) acc[p * DM + d] = fmaf(kv * ilr[d], zr[d], acc[p * DM + d]);
          if (WANT_WV) dv[i] = k * gl[p];
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kTile; ++p) {
#pragma unroll
      for (int d = 0; d < DM; ++d)
        acc[p * DM + d] = fmaf(-kvsum[p] * xs[p][d], ilr[d], acc[p * DM + d]);
    }
  }

  const float total = block_sum(acc, red);
  const int p = threadIdx.x / DM;
  const int d = threadIdx.x % DM;
  if (threadIdx.x < kTile * DM && p < np && d < D) dx[(size_t)(s0 + p) * D + d] = total;
}

constexpr int kMaxD = 16;

inline int grid_for(int S) { return (S + kTile - 1) / kTile; }

inline bool bad_shape(int S, int L, int B, int M, int D) {
  return S <= 0 || L <= 0 || B <= 0 || M <= 0 || D <= 0 || D > kMaxD;
}

}  // namespace

extern "C" int path_eval_fwd(const float* x, const float* w, const float* v,
                             const float* omega, const float* phase,
                             const float* z, const float* z2, const float* il,
                             float* out, int S, int L, int B, int M, int D,
                             void* stream) {
  if (bad_shape(S, L, B, M, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 8)
    fwd_kernel<8><<<grid_for(S), kThreads, 0, st>>>(x, w, v, omega, phase, z, z2, il, out, S, L, B, M, D);
  else
    fwd_kernel<16><<<grid_for(S), kThreads, 0, st>>>(x, w, v, omega, phase, z, z2, il, out, S, L, B, M, D);
  return (int)cudaGetLastError();
}

extern "C" int path_eval_bwd_dx(const float* x, const float* w, const float* v,
                                const float* omega, const float* phase,
                                const float* z, const float* z2, const float* il,
                                const float* g, float* dx,
                                int S, int L, int B, int M, int D, void* stream) {
  if (bad_shape(S, L, B, M, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 8)
    bwd_kernel<8, false><<<grid_for(S), kThreads, 0, st>>>(
        x, w, v, omega, phase, z, z2, il, g, dx, nullptr, nullptr, S, L, B, M, D);
  else
    bwd_kernel<16, false><<<grid_for(S), kThreads, 0, st>>>(
        x, w, v, omega, phase, z, z2, il, g, dx, nullptr, nullptr, S, L, B, M, D);
  return (int)cudaGetLastError();
}

extern "C" int path_eval_bwd_full(const float* x, const float* w, const float* v,
                                  const float* omega, const float* phase,
                                  const float* z, const float* z2, const float* il,
                                  const float* g, float* dx, float* dw, float* dv,
                                  int S, int L, int B, int M, int D, void* stream) {
  if (bad_shape(S, L, B, M, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 8)
    bwd_kernel<8, true><<<grid_for(S), kThreads, 0, st>>>(
        x, w, v, omega, phase, z, z2, il, g, dx, dw, dv, S, L, B, M, D);
  else
    bwd_kernel<16, true><<<grid_for(S), kThreads, 0, st>>>(
        x, w, v, omega, phase, z, z2, il, g, dx, dw, dv, S, L, B, M, D);
  return (int)cudaGetLastError();
}
