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
// below that.
//
// Forward (fwd_warp): latents on the block grid, (ceil(S/kTP), L) blocks
// of kTP particles, a warp a particle (128 blocks at S=1024, L=4, so each
// latent's tables are read from L2 by S/kTP blocks only). A block stages
// its latent's tables once into shared memory by cp.async as panels: row
// d < D holds coordinate d of every column (omega_lb, or z~_lm for the
// centers), row D the per-column scalar (phase_lb or z2_lm); the bases
// fill columns [0, bw), the centers [bw, bw + mw) (B and M rounded up to
// 4, the pads zero). Lane j takes the groups of 4 columns j, j + 32, ...
// in order; each group's w or v values arrive by cp.async kRing groups
// ahead into the lane's own shared-memory slots, 16 bytes a copy where the
// rows are 16-byte aligned. The lane's partial sums meet by a butterfly:
// no block barrier after staging. Columns that outgrow shared memory are
// staged in chunks of cw (a multiple of 128, so every lane has the same
// groups in each chunk), a block barrier around each. The bases' cos is
// cos_fast (range reduction, then the SFU's __cosf) for a group whose
// arguments are within kCosFast, else cosf().
//
// dx-only backward (bwd_warp, K1b): the forward's grid, staging, weight
// stream and lane-to-column partition. Once staged, the centers' rows are
// scaled by il_l in place, so that one sum per coordinate takes both kinds
// of column. Per group of 4 columns a lane recomputes the dots from the
// panels, then adds c_q times the group's rows: the bases' c = -sin(proj) w
// (sin_fast: the forward's range reduction and the SFU's __sinf, under the
// same kCosFast test, else sinf()), the centers' kv = exp(-d2 / 2) v, also
// summed alone. At D <= 6 four of the rows stay in registers from the
// dots. The lane sums meet by butterfly and lane 0 forms g[s,l] (acc - sum
// kv x~ il_l): g is a per-(s, l) scalar, applied once. With L > 1 each
// block writes its latent's partial dx_l into a (L, S, D) scratch and
// bwd_finish adds l = 0 .. L-1 in order (no float atomics); with L = 1 the
// block writes dx itself.
//
// Full backward (bwd_kernel, K1c): one block takes a tile of kTile
// particles and loops over the latents; its threads stride over B and then
// over M, so each omega and z row read from L2 serves kTile particles. D <=
// 16 is held in registers (the template DM pads it with zeros, which add
// exact zeros to every dot product). Per-thread partial sums meet in a
// warp-shuffle plus shared-memory block reduction.
//
// The |x|^2+|z|^2-2x.z cancellation stays in full float32 (no fast math),
// as the JAX kernel pins HIGHEST precision.
//
// Each entry returns cudaGetLastError() as an int; the caller raises on
// nonzero. Entries launch on the given stream and do not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

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

// ------------------------------------------------------------ forward (K1a)
constexpr int kTP = 32;    // particles a block, a warp each
constexpr int kRing = 4;   // a lane's weight groups in flight (path_eval_cuda.FWD_RING_BYTES)
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take (FWD_SMEM_MAX)
constexpr float kCosFast = 105615.0f;

// x - 2 pi k in [-pi, pi] for |x| <= kCosFast (Cody-Waite, FMA)
__device__ __forceinline__ float reduce_2pi(float x) {
  const float k = rintf(x * 0.159154943f);
  const float r = fmaf(k, -6.28318548f, x);  // 2 pi in float32, then the rest
  return fmaf(k, 1.74845553e-7f, r);
}
// cos(x) and sin(x) for |x| <= kCosFast: the reduced argument, then the
// SFU's cos or sin (absolute error about 2^-21 on [-pi, pi])
__device__ __forceinline__ float cos_fast(float x) { return __cosf(reduce_2pi(x)); }
__device__ __forceinline__ float sin_fast(float x) { return __sinf(reduce_2pi(x)); }

__device__ __forceinline__ void lds4(float (&r)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
}

// cp.async from global into shared memory: 16 bytes (both 16-byte
// aligned, bypassing L1), or one float zero-filled where !valid (src is
// then not read). The #else branches are what a host compiler sees.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
#else
  for (int q = 0; q < 4; ++q) dst[q] = src[q];
#endif
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
#else
  *dst = valid ? *src : 0.f;
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

struct Args {
  const float *x, *w, *v, *omega, *phase, *z, *z2, *il;
  const float* g;      // the backward's cotangent (S, L)
  float* out;          // f (S, L); the backward's dx (S, D) at L = 1, else its partials (L, S, D)
  int S, L, B, M, D;
  int bw, mw, cw;      // B and M rounded up to 4; the panels' chunk width
  bool vec_w, vec_v;   // w's and v's rows are 16-byte aligned
};

// Issue the cp.async copies of columns [c0, c0 + cw) of latent l's panels
// (rows 0..D of a.cw floats), reading each table in its own order, as one
// commit group; zero the pads.
__device__ __forceinline__ void stage_panels(float* pan, const Args& a, int l, int c0) {
  const int tid = threadIdx.x, nth = blockDim.x, D = a.D, cw = a.cw;
  // i / D as umulhi(i, ceil(2^32 / D)) for D > 1: exact for i < 2^16 (a
  // chunk holds fewer than 2^16 / D columns: fwd_plan)
  const unsigned inv_d = (unsigned)((0x100000000ull + D - 1) / D);
  const auto div_d = [&](int i) { return D == 1 ? i : (int)__umulhi(i, inv_d); };
  const int b0 = c0, b1 = min(c0 + cw, a.B);
  if (b0 < b1) {
    const float* src = a.omega + ((size_t)l * a.B + b0) * D;
    for (int i = tid; i < (b1 - b0) * D; i += nth) {
      const int c = div_d(i);
      cp_async4(pan + (i - c * D) * cw + c, src + i, true);
    }
    for (int c = b0 + tid; c < b1; c += nth) cp_async4(pan + D * cw + c - c0, a.phase + (size_t)l * a.B + c, true);
  }
  const int m0 = max(c0 - a.bw, 0), m1 = min(c0 + cw - a.bw, a.M);
  if (m0 < m1) {
    const int j0 = a.bw + m0 - c0;
    const float* src = a.z + ((size_t)l * a.M + m0) * D;
    for (int i = tid; i < (m1 - m0) * D; i += nth) {
      const int c = div_d(i);
      cp_async4(pan + (i - c * D) * cw + j0 + c, src + i, true);
    }
    for (int c = m0 + tid; c < m1; c += nth) cp_async4(pan + D * cw + j0 + c - m0, a.z2 + (size_t)l * a.M + c, true);
  }
  cp_async_commit();
  // the pads: bases columns [B, bw), centers columns bw + [M, mw)
  for (int i = tid; i < (D + 1) * 8; i += nth) {
    const int r = i / 8, c = i % 8;
    const int col = c < 4 ? a.B + c : a.bw + a.M + c - 4;
    if (col < (c < 4 ? a.bw : a.bw + a.mw) && col >= c0 && col < c0 + cw) pan[r * cw + col - c0] = 0.f;
  }
}

// A lane's weights: its groups (columns 4 g, g = lane + 32 item, of the
// concatenated [w | v] row of its warp's particle), each copied kRing items
// ahead by cp.async into the lane's own slots of the ring (one commit group
// an item, empty past the row), then read from there.
struct WStream {
  const float *w, *v;  // the particle's rows of w and v
  float* slot;         // the lane's slot of item 0; the next are 4 blockDim.x floats on

  __device__ WStream(const Args& a, float* ring, int s, int l)
      : w(a.w + ((size_t)s * a.L + l) * a.B), v(a.v + ((size_t)s * a.L + l) * a.M),
        slot(ring + 4 * threadIdx.x) {}
  __device__ float* at(int item) const { return slot + (item & (kRing - 1)) * 4 * blockDim.x; }
  __device__ void issue(const Args& a, int item) {
    const int c = 4 * ((threadIdx.x & 31) + 32 * item);
    if (c < a.bw + a.mw) {
      const bool base = c < a.bw;
      const float* src = base ? w + c : v + (c - a.bw);
      const int left = base ? a.B - c : a.M - (c - a.bw);  // the row's columns from src on
      if (base ? a.vec_w : a.vec_v) {
        cp_async16(at(item), src);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) cp_async4(at(item) + q, src + min(q, left - 1), q < left);
      }
    }
    cp_async_commit();
  }
  // item's weights, once its copy has landed; then the copy kRing ahead
  __device__ void take(const Args& a, float (&wv)[4], int item) {
    cp_async_wait<kRing - 1>();
    lds4(wv, at(item));
    issue(a, item + kRing);
  }
};

// Blocks (ceil(S / kTP), L) of kTP warps; warp u takes particle kTP
// blockIdx.x + u. Dynamic shared memory: the ring (kRing slots of 4 floats
// a thread), then the panels ((D + 1) x cw floats). x is scaled by il_l in
// place at the lane's first centers group.
template <int DM>
__global__ void __launch_bounds__(kTP * 32, 1) fwd_warp(const Args a) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  float* ring = reinterpret_cast<float*>(fwd_smem);
  float* pan = ring + (size_t)kRing * 4 * blockDim.x;
  const int l = blockIdx.y, lane = threadIdx.x & 31, D = a.D;
  const int s = blockIdx.x * kTP + (threadIdx.x >> 5);
  const int cols = a.bw + a.mw;
  const int items = s < a.S ? (cols / 4 - lane + 31) / 32 : 0;  // this lane's groups
  WStream ws(a, ring, s, l);
  for (int k = 0; k < kRing && s < a.S; ++k) ws.issue(a, k);

  // x (zero past D) and |x il_l|^2
  float x[DM], x2 = 0.f, acc = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    x[d] = (d < D && s < a.S) ? a.x[(size_t)s * D + d] : 0.f;
    const float xs = d < D ? x[d] * a.il[(size_t)l * D + d] : 0.f;
    x2 = fmaf(xs, xs, x2);
  }

  int k = 0;
  bool scaled = false;
  for (int c0 = 0; c0 < cols; c0 += a.cw) {
    if (c0) __syncthreads();  // the previous chunk is consumed
    stage_panels(pan, a, l, c0);
    cp_async_wait<0>();
    __syncthreads();
    const int kend = min(k + a.cw / 128, items);
    for (; k < kend; ++k) {
      float wv[4];
      ws.take(a, wv, k);
      const int c = 4 * (lane + 32 * k), j = c - c0;
      if (c >= a.bw && !scaled) {  // from here on x~ = x il_l
        scaled = true;
#pragma unroll
        for (int d = 0; d < DM; ++d) x[d] *= d < D ? a.il[(size_t)l * D + d] : 0.f;
      }
      float sc[4], dt[4] = {0.f, 0.f, 0.f, 0.f};
      lds4(sc, pan + D * a.cw + j);
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        if (d < D) {
          float o[4];
          lds4(o, pan + d * a.cw + j);
#pragma unroll
          for (int q = 0; q < 4; ++q) dt[q] = fmaf(x[d], o[q], dt[q]);
        }
      }
      if (c < a.bw) {  // bases: sum_q cos(x . omega + phase) w
        float big = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dt[q] += sc[q];
          big = fmaxf(big, fabsf(dt[q]));
        }
        if (big <= kCosFast) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc = fmaf(cos_fast(dt[q]), wv[q], acc);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc = fmaf(cosf(dt[q]), wv[q], acc);
        }
      } else {  // centers: sum_q exp(-|x~ - z~|^2 / 2) v
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float d2 = fmaxf(x2 + sc[q] - 2.f * dt[q], 0.f);
          acc = fmaf(expf(-0.5f * d2), wv[q], acc);
        }
      }
    }
  }
  const float total = warp_sum(acc);
  if (lane == 0 && s < a.S) a.out[(size_t)s * a.L + l] = total;
}

// The dx-only backward on the forward's grid and staging: warp u takes
// particle kTP blockIdx.x + u of latent blockIdx.y; dynamic shared memory
// as fwd_warp's. Once staged, the centers' coordinate rows are scaled by
// il_l in place, so that x . (z~ il) = x~ . z~ and kv (z~ il) is the
// centers' term of dx before the x~ part: x stays unscaled and one sum acc
// takes -sin(proj) w omega over the bases and kv z~ il over the centers,
// kvsum the centers' kv. At DM <= 6 the first kHeld = 4 panel rows of a
// group stay in registers from the dots to the update and the others are
// read again; wider, all are read again (more held rows spill at 64
// registers a thread). A group past kCosFast reads them all again, so
// that sinf() finds its registers free.
template <int DM>
__global__ void __launch_bounds__(kTP * 32, 1) bwd_warp(const Args a) {
  constexpr int kHeld = DM <= 6 ? 4 : 0;  // rows kept in registers from the dots
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* ring = reinterpret_cast<float*>(bwd_smem);
  float* pan = ring + (size_t)kRing * 4 * blockDim.x;
  const int l = blockIdx.y, lane = threadIdx.x & 31, D = a.D;
  const int s = blockIdx.x * kTP + (threadIdx.x >> 5);
  const int cols = a.bw + a.mw;
  const int items = s < a.S ? (cols / 4 - lane + 31) / 32 : 0;  // this lane's groups
  WStream ws(a, ring, s, l);
  for (int k = 0; k < kRing && s < a.S; ++k) ws.issue(a, k);

  float x[DM], x2 = 0.f, acc[DM], kvsum = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    x[d] = (d < D && s < a.S) ? a.x[(size_t)s * D + d] : 0.f;
    const float xs = d < D ? x[d] * a.il[(size_t)l * D + d] : 0.f;
    x2 = fmaf(xs, xs, x2);
    acc[d] = 0.f;
  }

  int k = 0;
  for (int c0 = 0; c0 < cols; c0 += a.cw) {
    if (c0) __syncthreads();  // the previous chunk is consumed
    stage_panels(pan, a, l, c0);
    cp_async_wait<0>();
    __syncthreads();
    const int j0 = max(a.bw - c0, 0), j1 = min(a.bw + a.mw - c0, a.cw);  // the chunk's centers
    if (j0 < j1) {
      for (int i = threadIdx.x; i < D * (j1 - j0); i += blockDim.x) {
        const int d = i / (j1 - j0);
        pan[d * a.cw + j0 + i - d * (j1 - j0)] *= a.il[(size_t)l * D + d];
      }
      __syncthreads();
    }
    const int kend = min(k + a.cw / 128, items);
    for (; k < kend; ++k) {
      float wv[4];
      ws.take(a, wv, k);
      const int c = 4 * (lane + 32 * k), j = c - c0;
      const bool base = c < a.bw;
      // dt: the bases' x . omega + phase, the centers' x~ . z~ - (|x~|^2 +
      // |z~|^2) / 2 = -|x~ - z~|^2 / 2; o: the first kHeld rows
      float dt[4], cq[4], o[kHeld ? kHeld : 1][4];
      lds4(dt, pan + D * a.cw + j);
#pragma unroll
      for (int q = 0; q < 4; ++q) dt[q] = base ? dt[q] : -0.5f * (x2 + dt[q]);
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        if (d < D) {
          float row[4];
          lds4(row, pan + d * a.cw + j);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dt[q] = fmaf(x[d], row[q], dt[q]);
            if (d < kHeld) o[d < kHeld ? d : 0][q] = row[q];
          }
        }
      }
      // acc += c_q times the group's rows, held or read again
      const auto add_rows = [&](bool held) {
#pragma unroll
        for (int d = 0; d < DM; ++d) {
          if (d < D) {
            float row[4];
            if (held && d < kHeld) {
#pragma unroll
              for (int q = 0; q < 4; ++q) row[q] = o[d < kHeld ? d : 0][q];
            } else {
              lds4(row, pan + d * a.cw + j);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[d] = fmaf(cq[q], row[q], acc[d]);
          }
        }
      };
      if (base) {  // bases: c_q = -sin(x . omega + phase) w
        float big = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) big = fmaxf(big, fabsf(dt[q]));
        if (big <= kCosFast) {
#pragma unroll
          for (int q = 0; q < 4; ++q) cq[q] = -sin_fast(dt[q]) * wv[q];
          add_rows(true);
        } else {  // rows read again, so that sinf() finds its registers free
#pragma unroll
          for (int q = 0; q < 4; ++q) cq[q] = -sinf(dt[q]) * wv[q];
          add_rows(false);
        }
      } else {  // centers: kv_q = exp(-|x~ - z~|^2 / 2) v
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          cq[q] = expf(fminf(dt[q], 0.f)) * wv[q];
          kvsum += cq[q];
        }
        add_rows(true);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < D) acc[d] = warp_sum(acc[d]);
  kvsum = warp_sum(kvsum);
  if (lane == 0 && s < a.S) {  // g (acc - kvsum x~ il)
    const float gl = a.g[(size_t)s * a.L + l];
    float* out = a.out + ((a.L == 1 ? 0 : (size_t)l * a.S) + s) * D;
#pragma unroll
    for (int d = 0; d < DM; ++d) {
      if (d < D) {
        const float il = a.il[(size_t)l * D + d];
        out[d] = gl * fmaf(-kvsum * (x[d] * il), il, acc[d]);
      }
    }
  }
}

// dx[i] = sum_l part[l, i] over l = 0 .. L-1 in order, i over S x D
__global__ void bwd_finish(const float* __restrict__ part, float* __restrict__ dx, int n, int L) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = part[i];
  for (int l = 1; l < L; ++l) t += part[(size_t)l * n + i];
  dx[i] = t;
}

// The full backward (K1c): dx, dw and dv
template <int DM>
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
          dw[i] = cs * gl[p];
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
          dv[i] = k * gl[p];
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

// fwd_warp or bwd_warp on (ceil(S / kTP), L) blocks
int launch_warp(void (*kernel)(Args), const Args& a, cudaStream_t st) {
  constexpr int threads = kTP * 32;
  const size_t bytes = ((size_t)kRing * 4 * threads + (size_t)(a.D + 1) * a.cw) * sizeof(float);
  if (bytes > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) return err;
  kernel<<<dim3((a.S + kTP - 1) / kTP, a.L), threads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const float* x, const float* w, const float* v, const float* omega, const float* phase,
               const float* z, const float* z2, const float* il, const float* g, float* out,
               int S, int L, int B, int M, int D, int cw) {
  return Args{x, w, v, omega, phase, z, z2, il, g, out, S, L, B, M, D, (B + 3) / 4 * 4, (M + 3) / 4 * 4, cw,
              B % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0,
              M % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0};
}

}  // namespace

// cw: the panels' chunk width, a multiple of 128 (ops/path_eval_cuda.py:fwd_plan)
extern "C" int path_eval_fwd(const float* x, const float* w, const float* v,
                             const float* omega, const float* phase,
                             const float* z, const float* z2, const float* il,
                             float* out, int S, int L, int B, int M, int D, int cw,
                             void* stream) {
  if (bad_shape(S, L, B, M, D) || cw <= 0 || cw % 128) return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, w, v, omega, phase, z, z2, il, nullptr, out, S, L, B, M, D, cw);
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 6) return launch_warp(fwd_warp<6>, a, st);
  if (D <= 8) return launch_warp(fwd_warp<8>, a, st);
  return launch_warp(fwd_warp<16>, a, st);
}

// part: the (L, S, D) scratch of the per-latent partials (unused at L = 1);
// cw as path_eval_fwd's
extern "C" int path_eval_bwd_dx(const float* x, const float* w, const float* v,
                                const float* omega, const float* phase,
                                const float* z, const float* z2, const float* il,
                                const float* g, float* dx, float* part,
                                int S, int L, int B, int M, int D, int cw, void* stream) {
  if (bad_shape(S, L, B, M, D) || cw <= 0 || cw % 128) return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, w, v, omega, phase, z, z2, il, g, L == 1 ? dx : part, S, L, B, M, D, cw);
  cudaStream_t st = (cudaStream_t)stream;
  const int err = D <= 6 ? launch_warp(bwd_warp<6>, a, st)
                  : D <= 8 ? launch_warp(bwd_warp<8>, a, st)
                           : launch_warp(bwd_warp<16>, a, st);
  if (err || L == 1) return err;
  const int n = S * D;
  bwd_finish<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(part, dx, n, L);
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
    bwd_kernel<8><<<grid_for(S), kThreads, 0, st>>>(
        x, w, v, omega, phase, z, z2, il, g, dx, dw, dv, S, L, B, M, D);
  else
    bwd_kernel<16><<<grid_for(S), kThreads, 0, st>>>(
        x, w, v, omega, phase, z, z2, il, g, dx, dw, dv, S, L, B, M, D);
  return (int)cudaGetLastError();
}
