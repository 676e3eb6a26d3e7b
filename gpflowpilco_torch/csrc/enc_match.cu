// Trigonometric-encoder moment match (exact sin/cos moments of the active
// dims and the joint-covariance stitch) for Hopper (sm_90a), float32 and
// float64.
//
// Replaces the TPU kernels of gpflowpilco_tpu/ops/enc_match_pallas.py:
//   enc_match_fwd_{f32,f64} <- _enc_fwd_kernel (:252), launched by _enc_fwd_call (:290)
//   enc_match_bwd_{f32,f64} <- _enc_bwd_kernel (:262), launched by _enc_vjp_bwd (:307)
//
// For x ~ N(mx, S) with active dims a (given order) and inactive dims b (the
// rest, ascending), y = [sin x_a; cos x_a; x_b] (De = 2 |a| + |b|):
//   y_mean (De), y_cov (De, De), cross = Cov(x, y) (D, De), not premultiplied.
// The backward is the hand adjoint of enc_match_pallas._enc_bwd_core
// (:130-233), recomputing the forward's intermediates.
//
// Bound on an H100: a few hundred bytes and a few hundred operations per
// batch entry; at the rollout's N = 1 (and N = 30 for the post-rollout cost)
// the kernel is launch- and latency-bound. The active dims come as 4-bit
// fields of one 64-bit argument (D <= 16), the inactive ones follow. Both
// entries run a warp per batch entry (enc_fwd_warp, enc_bwd_warp): the
// operands in shared memory after one wave of loads, the independent pieces
// (the active dims' terms and the trig pairs, computed once each; in the
// backward also the cross rows and the trig means' cotangents) spread over
// the lanes, and each output entry formed by one lane in a fixed order and
// written once, so that the dependent chain is a few phases deep and no
// runtime-indexed array sits in local memory.
//
// Each entry returns cudaGetLastError() as an int; the caller raises on
// nonzero. Entries launch on the given stream and do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 16;

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float fm(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fm(double a, double b, double c) { return fma(a, b, c); }

// sin and cos of one argument over the whole range, without fast math.
// float: sincosf's slow path (Payne-Hanek reduction above |x| = 105615)
// indexes an array of product words at run time, which puts a stack frame in
// local memory. Here the words stay in registers (the three that the
// exponent selects are picked by compares), and the reduced argument goes
// through the minimax polynomials of sin and cos on [-pi/4, pi/4]: within
// 2 ulp of the correctly rounded value over the float range
// (tests/test_torch_enc_match.py restates it in numpy and holds it there).
// double: sincos, whose slow path keeps a stack frame (off the path).
// The k-th (1..4) of four words, by compares, not by an index.
__device__ __forceinline__ unsigned pick4(int k, unsigned a, unsigned b, unsigned c, unsigned d) {
  return k == 1 ? a : k == 2 ? b : k == 3 ? c : d;
}
// t with a = t + quadrant pi/2, |t| <= pi/4: three-part Cody-Waite up to
// |a| = 105615, Payne-Hanek above.
__device__ __forceinline__ float reduce_pio2(float a, int* quadrant) {
  const float j = rintf(a * 0.636619772f);
  float t = fmaf(-j, 1.5707962512969971e+000f, a);
  t = fmaf(-j, 7.5497894158615964e-008f, t);
  t = fmaf(-j, 5.3903029534742384e-015f, t);
  int q = (int)j;
  if (fabsf(a) > 105615.0f) {
    if (!(fabsf(a) <= 3.402823466e38f)) {  // inf or nan
      *quadrant = 0;
      return a - a;
    }
    unsigned ia = __float_as_uint(a);
    unsigned s = ia & 0x80000000u;
    unsigned e = ((ia >> 23) & 0xffu) - 128u;
    ia = (ia << 8) | 0x80000000u;
    // |a| x 2/pi: 2/pi's first 192 bits times the 32-bit mantissa, words
    // least significant first
    const unsigned w0 = 0x3c439041u, w1 = 0xdb629599u, w2 = 0xf534ddc0u, w3 = 0xfc2757d1u,
                   w4 = 0x4e441529u, w5 = 0xa2f9836eu;
    unsigned r0, r1, r2, r3, r4, r5, r6, hi = 0;
#define PH_WORD(w, r)                           \
  {                                             \
    const unsigned plo = (w) * ia;              \
    const unsigned phi = __umulhi((w), ia);     \
    const unsigned lo_ = hi + plo;              \
    hi = phi + (lo_ < plo);                     \
    r = lo_;                                    \
  }
    PH_WORD(w0, r0) PH_WORD(w1, r1) PH_WORD(w2, r2) PH_WORD(w3, r3) PH_WORD(w4, r4) PH_WORD(w5, r5)
#undef PH_WORD
    r6 = hi;
    const int idx = 4 - (int)(e >> 5);  // 1..4
    const unsigned sh = e & 31u;
    hi = pick4(idx, r3, r4, r5, r6);
    unsigned lo = pick4(idx, r2, r3, r4, r5);
    if (sh) {
      const unsigned below = pick4(idx, r1, r2, r3, r4);
      hi = (hi << sh) | (lo >> (32 - sh));
      lo = (lo << sh) | (below >> (32 - sh));
    }
    q = (int)(hi >> 30);
    hi = (hi << 2) | (lo >> 30);
    lo = lo << 2;
    const unsigned up = (hi + (lo > 0)) > 0x80000000u;  // fraction >= 0.5
    q += (int)up;
    if (s) q = -q;
    if (up) {
      hi = ~hi;
      lo = 0u - lo;
      hi += (lo == 0);
      s ^= 0x80000000u;
    }
    int ex = 0;
    while ((int)hi > 0) {
      hi = (hi << 1) | (lo >> 31);
      lo = lo << 1;
      --ex;
    }
    lo = hi * 0xc90fdaa2u;
    hi = __umulhi(hi, 0xc90fdaa2u);
    if ((int)hi > 0) {
      hi = (hi << 1) | (lo >> 31);
      lo = lo << 1;
      --ex;
    }
    hi = hi + (lo > 0);
    t = __uint_as_float(s | ((unsigned)((ex + 126) << 23) + (hi >> 8) + ((hi << 24) >= 0x80000000u)));
  }
  *quadrant = q;
  return t;
}
// sin(t + q pi/2) for |t| <= pi/4 (minimax polynomials; q odd: the cosine's)
__device__ __forceinline__ float sin_quadrant(float t, int q) {
  const float t2 = t * t;
  float z;
  if (q & 1) {
    z = fmaf(2.44331571e-5f, t2, -1.38873163e-3f);
    z = fmaf(z, t2, 4.16666457e-2f);
    z = fmaf(z, t2, -5.00000000e-1f);
    z = fmaf(z, t2, 1.0f);
  } else {
    z = fmaf(-1.95152959e-4f, t2, 8.33216087e-3f);
    z = fmaf(z, t2, -1.66666546e-1f);
    z = fmaf(z * t2, t, t);
  }
  return (q & 2) ? -z : z;
}
__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  int q;
  const float t = reduce_pio2(x, &q);
  *s = sin_quadrant(t, q);
  *c = sin_quadrant(t, q + 1);
}
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) { sincos(x, s, c); }

// Lane dd < d: pos[dd], dd's index among the active dims (in the given
// order), or -1 - its index among the inactive ones (ascending); lane i <
// na also act[i]. Returns the lane's pos (0 for lanes >= d).
__device__ __forceinline__ int dim_roles(int lane, int d, int na, unsigned long long packed, int* act,
                                         int* pos) {
  if (lane >= d) return 0;
  unsigned mask = 0;
  int p = -1;
  for (int i = 0; i < na; ++i) {
    const int a = (int)((packed >> (4 * i)) & 0xF);
    mask |= 1u << a;
    if (a == lane) p = i;
  }
  p = p >= 0 ? p : -1 - __popc(~mask & ((1u << lane) - 1));
  pos[lane] = p;
  if (lane < na) act[lane] = (int)((packed >> (4 * lane)) & 0xF);
  return p;
}

// The forward: a warp per batch entry (a block is one warp, the grid the
// batch), on the exact shape (D, NA) where the path runs it ((4, 1)) and on
// any D <= 16 with D = NA = 0, as the backward. The lanes copy mx and S
// into shared memory in one wave, then (1) compute the terms once, spread
// over the lanes: a lane per active dim (m, v, ev, sin m, cos m: s1, c1)
// and a lane per active pair (i, j) (a, b and the sin and cos of m_i + m_j
// and m_i - m_j: the pair's raw ss, cc and sc); then (2) every entry of
// y_mean, y_cov and cross from its one lane, neighbouring lanes on
// neighbouring addresses, each written once. Every runtime index is into
// shared memory.
template <typename T, int D, int NA>
__global__ void __launch_bounds__(32) enc_fwd_warp(
    const T* __restrict__ mx_, const T* __restrict__ sxx, T* __restrict__ ym, T* __restrict__ yc,
    T* __restrict__ cr, int d_rt, int na_rt, unsigned long long packed) {
  constexpr int kD = D ? D : kMaxD, kNA = D ? NA : kMaxD;
  const int d = D ? D : d_rt, na = D ? NA : na_rt, nt = 2 * na, de = d + na;
  const int lane = threadIdx.x;
  const size_t n = blockIdx.x;
  __shared__ T mx[kD], S[kD * kD], y1s[2 * kNA], ss[kNA * kNA], cc[kNA * kNA], sc[kNA * kNA];
  __shared__ int act[kNA], pos[kD], inact[kD];

  // (0) the operands, and the dims' roles
  for (int k = lane; k < d; k += 32) mx[k] = mx_[n * d + k];
  for (int k = lane; k < d * d; k += 32) S[k] = sxx[n * d * d + k];
  const int p = dim_roles(lane, d, na, packed, act, pos);
  if (p < 0) inact[-1 - p] = lane;
  __syncwarp();

  // (1) item i < na: active dim i's trig means; item na + i na + j: pair
  // (i, j)'s raw second moments
  for (int q = lane; q < na + na * na; q += 32) {
    if (q < na) {
      const int a = act[q];
      const T e = ex(T(-0.5) * fmax(S[a * d + a], T(0)));
      T s, c;
      sin_cos(mx[a], &s, &c);
      y1s[q] = e * s;
      y1s[na + q] = e * c;
    } else {
      const int ij = q - na, ai = act[ij / na], aj = act[ij % na];
      const T vi = fmax(S[ai * d + ai], T(0)), vj = fmax(S[aj * d + aj], T(0));
      const T sij = S[ai * d + aj], sji = S[aj * d + ai];
      const T pa = ex(T(-0.5) * (vi + vj + sij + sji)), pb = ex(T(-0.5) * (vi + vj - sij - sji));
      T sa, ca, sb, cb;
      sin_cos(mx[ai] + mx[aj], &sa, &ca);
      sin_cos(mx[ai] - mx[aj], &sb, &cb);
      ss[ij] = T(0.5) * (pb * cb - pa * ca);
      cc[ij] = T(0.5) * (pb * cb + pa * ca);
      sc[ij] = T(0.5) * (pb * sb + pa * sa);
    }
  }
  __syncwarp();

  // (2) y_mean (de), y_cov (de x de), cross (d x de), one entry a lane.
  // Trig index k < nt is sin (k < na) or cos of active dim k % na; k >= nt
  // is inactive dim inact[k - nt]. Cov(x_dd, trig k) = S[dd, a] c1 (sin)
  // or -S[dd, a] s1 (cos), a = act[k % na].
  const int n_ym = de, n_yc = n_ym + de * de, n_items = n_yc + d * de;
  for (int q = lane; q < n_items; q += 32) {
    if (q < n_ym) {
      ym[n * de + q] = q < nt ? y1s[q] : mx[inact[q - nt]];
      continue;
    }
    const bool cov = q < n_yc;
    const int e = cov ? q - n_ym : q - n_yc, r = e / de, k = e % de;
    T x;
    if (cov && r < nt && k < nt) {  // raw2 - y1 y1^T
      const int i = r % na, j = k % na;
      const T raw = r < na ? (k < na ? ss[i * na + j] : sc[i * na + j])
                           : (k < na ? sc[j * na + i] : cc[i * na + j]);
      x = raw - y1s[r] * y1s[k];
    } else if (cov && r >= nt && k >= nt) {
      x = S[inact[r - nt] * d + inact[k - nt]];
    } else if (!cov && k >= nt) {
      x = S[r * d + inact[k - nt]];
    } else {  // cross's trig columns, and y_cov's blocks Cov(x_b, trig) and its transpose
      const int dd = !cov ? r : r >= nt ? inact[r - nt] : inact[k - nt], kk = !cov || r >= nt ? k : r;
      const int i = kk % na;
      x = S[dd * d + act[i]] * (kk < na ? y1s[na + i] : -y1s[i]);
    }
    (cov ? yc + n * de * de : cr + n * d * de)[e] = x;
  }
}

// The backward: a warp per batch entry (a block is one warp, the grid the
// batch), on the exact shape (D, NA) where the path runs it ((4, 1): the
// cartpole's angle) and on any D <= 16 with D = NA = 0. The lanes copy the
// entry's operands into shared memory in one wave, then run the adjoint in
// phases separated by __syncwarp, its independent pieces spread over the
// lanes: (1) the active dims' terms, a lane per dim; (2) the cross rows'
// cotangents g[dd][k], a lane per (dd, k), the trig means' cotangents dy1,
// a lane per k, and the trig pairs' adjoints, a lane per (i, j); (3) each
// active dim's dv and dm, a lane per dim; (4) every entry of dm and dS from
// its one owning lane, which adds its terms in the plain version's order
// and writes the entry once. Every runtime index is into shared memory, so
// nothing goes to local memory. pos[dd] is dd's index among the active dims,
// or -1 - its index among the inactive ones.
template <typename T, int D, int NA>
__global__ void __launch_bounds__(32) enc_bwd_warp(
    const T* __restrict__ mx_, const T* __restrict__ sxx, const T* __restrict__ dym_,
    const T* __restrict__ dyc_, const T* __restrict__ dcr_, T* __restrict__ dmx,
    T* __restrict__ dsxx, int d_rt, int na_rt, unsigned long long packed) {
  constexpr int kD = D ? D : kMaxD, kNA = D ? NA : kMaxD, kDe = D ? D + NA : 2 * kMaxD;
  const int d = D ? D : d_rt, na = D ? NA : na_rt, nt = 2 * na, de = d + na;
  const int lane = threadIdx.x;
  const size_t n = blockIdx.x;
  __shared__ T mx[kD], S[kD * kD], dym[kDe], dyc[kDe * kDe], dcr[kD * kDe];
  __shared__ T m[kNA], v[kNA], ev[kNA], sm[kNA], cm[kNA], y1s[2 * kNA], dy1s[2 * kNA], gx[kD * 2 * kNA];
  __shared__ T gab[kNA * kNA], gmb[kNA * kNA], dmp[kNA * kNA], dmm[kNA * kNA], dvp[kNA], dma[kNA];
  __shared__ int act[kNA], pos[kD];

  // (0) the operands, and the dims' roles
  for (int k = lane; k < d; k += 32) mx[k] = mx_[n * d + k];
  for (int k = lane; k < d * d; k += 32) S[k] = sxx[n * d * d + k];
  for (int k = lane; k < de; k += 32) dym[k] = dym_[n * de + k];
  for (int k = lane; k < de * de; k += 32) dyc[k] = dyc_[n * de * de + k];
  for (int k = lane; k < d * de; k += 32) dcr[k] = dcr_[n * d * de + k];
  dim_roles(lane, d, na, packed, act, pos);
  __syncwarp();

  // (1) the active dims' terms
  if (lane < na) {
    const int a = act[lane];
    const T mi = mx[a], vi = fmax(S[a * d + a], T(0)), e = ex(T(-0.5) * vi);
    T s, c;
    sin_cos(mi, &s, &c);
    m[lane] = mi;
    v[lane] = vi;
    ev[lane] = e;
    sm[lane] = s;
    cm[lane] = c;
    y1s[lane] = e * s;
    y1s[na + lane] = e * c;
  }
  __syncwarp();

  // (2) g[dd][k] = dcr[dd][k] (+ the y_cov blocks' cotangents where dd is
  // inactive); dy1s[k] = dym[k] - sum_j (dyc[k][j] + dyc[j][k]) y1s[j]; the
  // pair (i, j)'s raw second moments' adjoint
  const int n_g = d * nt, n_y = n_g + nt, n_items = n_y + na * na;
  for (int q = lane; q < n_items; q += 32) {
    if (q < n_g) {
      const int dd = q / nt, k = q % nt, p = pos[dd];
      T g = dcr[dd * de + k];
      if (p < 0) g += dyc[(nt - 1 - p) * de + k] + dyc[k * de + nt - 1 - p];
      gx[q] = g;
    } else if (q < n_y) {
      const int k = q - n_g;
      T acc = T(0);
      for (int j = 0; j < nt; ++j) acc = fm(dyc[k * de + j] + dyc[j * de + k], y1s[j], acc);
      dy1s[k] = dym[k] - acc;
    } else {
      const int ij = q - n_y, i = ij / na, j = ij % na, ai = act[i], aj = act[j];
      const T vv = v[i] + v[j], cross = S[ai * d + aj] + S[aj * d + ai];
      const T pa = ex(T(-0.5) * (vv + cross)), pb = ex(T(-0.5) * (vv - cross));
      T sa, ca, sb, cb;
      sin_cos(m[i] + m[j], &sa, &ca);
      sin_cos(m[i] - m[j], &sb, &cb);
      const T dss = dyc[i * de + j], dcc = dyc[(na + i) * de + na + j];
      const T dsc = dyc[i * de + na + j] + dyc[(na + j) * de + i];
      const T da = T(0.5) * (-dss * ca + dcc * ca + dsc * sa);
      const T db = T(0.5) * (dss * cb + dcc * cb + dsc * sb);
      const T dmadd = T(0.5) * (dss * pa * sa - dcc * pa * sa + dsc * pa * ca);
      const T dmsub = T(0.5) * (-dss * pb * sb - dcc * pb * sb + dsc * pb * cb);
      gab[ij] = T(-0.5) * da * pa - T(0.5) * db * pb;
      gmb[ij] = T(-0.5) * da * pa + T(0.5) * db * pb;
      dmp[ij] = dmadd + dmsub;
      dmm[ij] = dmadd - dmsub;
    }
  }
  __syncwarp();

  // (3) active dim i: the trig means' cotangents through the cross rows,
  // then dv (through max(S_ii, 0)) and dm
  if (lane < na) {
    const int i = lane, a = act[i];
    T dc = T(0), ds = T(0);
    for (int dd = 0; dd < d; ++dd) {
      dc = fm(gx[dd * nt + i], S[dd * d + a], dc);
      ds = fm(gx[dd * nt + na + i], S[dd * d + a], ds);
    }
    const T dc1 = dc + dy1s[na + i], ds1 = -ds + dy1s[i];
    T gr = T(0), gc = T(0), mr = T(0), mc = T(0);  // row and column sums over the pairs
    for (int j = 0; j < na; ++j) {
      gr += gab[i * na + j];
      gc += gab[j * na + i];
      mr += dmp[i * na + j];
      mc += dmm[j * na + i];
    }
    const T dev = ds1 * sm[i] + dc1 * cm[i];
    dma[i] = (mr + mc) + ds1 * ev[i] * cm[i] - dc1 * ev[i] * sm[i];
    const T dv = (gr + gc) - T(0.5) * dev * ev[i];
    dvp[i] = S[a * d + a] > T(0) ? dv : T(0);
  }
  __syncwarp();

  // (4) each entry of dm and dS from its owning lane, written once
  for (int e = lane; e < d * d; e += 32) {
    const int r = e / d, c = e % d, pr = pos[r], pc = pos[c];
    T x;
    if (pc < 0) {
      x = pr < 0 ? dyc[(nt - 1 - pr) * de + nt - 1 - pc] : T(0);
      x += dcr[r * de + nt - 1 - pc];
    } else {
      x = gx[r * nt + pc] * y1s[na + pc] - gx[r * nt + na + pc] * y1s[pc];
      if (pr >= 0) x += gmb[pr * na + pc] + gmb[pc * na + pr];
      if (r == c) x += dvp[pc];
    }
    dsxx[n * d * d + e] = x;
  }
  if (lane < d) {
    const int p = pos[lane];
    dmx[n * d + lane] = p < 0 ? dym[nt - 1 - p] : dma[p];
  }
}

inline bool bad(int N, int d, int na) { return N <= 0 || d <= 0 || d > kMaxD || na <= 0 || na > d; }

template <typename T>
int launch_fwd(const T* mx, const T* sxx, T* ym, T* yc, T* cr, int N, int d, int na,
               unsigned long long packed, void* stream) {
  if (bad(N, d, na)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 4 && na == 1)
    enc_fwd_warp<T, 4, 1><<<N, 32, 0, st>>>(mx, sxx, ym, yc, cr, d, na, packed);
  else
    enc_fwd_warp<T, 0, 0><<<N, 32, 0, st>>>(mx, sxx, ym, yc, cr, d, na, packed);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* mx, const T* sxx, const T* dym, const T* dyc, const T* dcr, T* dmx,
               T* dsxx, int N, int d, int na, unsigned long long packed, void* stream) {
  if (bad(N, d, na)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 4 && na == 1)
    enc_bwd_warp<T, 4, 1><<<N, 32, 0, st>>>(mx, sxx, dym, dyc, dcr, dmx, dsxx, d, na, packed);
  else
    enc_bwd_warp<T, 0, 0><<<N, 32, 0, st>>>(mx, sxx, dym, dyc, dcr, dmx, dsxx, d, na, packed);
  return (int)cudaGetLastError();
}

}  // namespace

#define ENC_MATCH_ENTRIES(T, SFX)                                                                \
  extern "C" int enc_match_fwd_##SFX(const T* mx, const T* sxx, T* ym, T* yc, T* cr, int N,   \
                                     int d, int na, unsigned long long packed, void* stream) { \
    return launch_fwd<T>(mx, sxx, ym, yc, cr, N, d, na, packed, stream);                       \
  }                                                                                            \
  extern "C" int enc_match_bwd_##SFX(const T* mx, const T* sxx, const T* dym, const T* dyc,   \
                                     const T* dcr, T* dmx, T* dsxx, int N, int d, int na,     \
                                     unsigned long long packed, void* stream) {               \
    return launch_bwd<T>(mx, sxx, dym, dyc, dcr, dmx, dsxx, N, d, na, packed, stream);         \
  }

ENC_MATCH_ENTRIES(float, f32)
ENC_MATCH_ENTRIES(double, f64)
