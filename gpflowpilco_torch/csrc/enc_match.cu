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
// the kernel is launch- and latency-bound. Design: one thread per batch
// entry, walking the scalar graph of the JAX kernel; the active dims come as
// 4-bit fields of one 64-bit argument (D <= 16), the inactive ones follow.
// The backward accumulates dS directly in its own (D, D) output slot.
//
// Each entry returns cudaGetLastError() as an int; the caller raises on
// nonzero. Entries launch on the given stream and do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxD = 16;

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float sn(float x) { return sinf(x); }
__device__ __forceinline__ double sn(double x) { return sin(x); }
__device__ __forceinline__ float cs(float x) { return cosf(x); }
__device__ __forceinline__ double cs(double x) { return cos(x); }

struct Parts {
  int na, nb, nt, de;
  int act[kMaxD];
  int inact[kMaxD];
};

__device__ __forceinline__ Parts decode(int d, int na, unsigned long long packed) {
  Parts p;
  p.na = na;
  unsigned mask = 0;
  for (int i = 0; i < na; ++i) {
    p.act[i] = (int)((packed >> (4 * i)) & 0xF);
    mask |= 1u << p.act[i];
  }
  p.nb = 0;
  for (int i = 0; i < d; ++i)
    if (!(mask & (1u << i))) p.inact[p.nb++] = i;
  p.nt = 2 * na;
  p.de = p.nt + p.nb;
  return p;
}

// Per-active-dim terms of the forward.
template <typename T>
struct Terms {
  T m[kMaxD], v[kMaxD], ev[kMaxD], s1[kMaxD], c1[kMaxD];
};

template <typename T>
__device__ __forceinline__ void terms(const Parts& p, const T* mx, const T* S, int d, Terms<T>& t) {
  for (int i = 0; i < p.na; ++i) {
    const int a = p.act[i];
    t.m[i] = mx[a];
    t.v[i] = fmax(S[a * d + a], T(0));
    t.ev[i] = ex(T(-0.5) * t.v[i]);
    t.s1[i] = t.ev[i] * sn(t.m[i]);
    t.c1[i] = t.ev[i] * cs(t.m[i]);
  }
}

// Raw trig second moments of active pair (i, j): a, b and the sums.
template <typename T>
struct Pair {
  T a, b, madd, msub;
};

template <typename T>
__device__ __forceinline__ Pair<T> pair(const Parts& p, const T* S, int d, const Terms<T>& t, int i,
                                        int j) {
  const T sij = S[p.act[i] * d + p.act[j]], sji = S[p.act[j] * d + p.act[i]];
  Pair<T> r;
  r.a = ex(T(-0.5) * (t.v[i] + t.v[j] + sij + sji));
  r.b = ex(T(-0.5) * (t.v[i] + t.v[j] - sij - sji));
  r.madd = t.m[i] + t.m[j];
  r.msub = t.m[i] - t.m[j];
  return r;
}

// raw2(ki, kj) over the 2 na trig dims: ss, sc, sc^T or cc.
template <typename T>
__device__ __forceinline__ T raw2(const Parts& p, const T* S, int d, const Terms<T>& t, int ki,
                                  int kj) {
  const int na = p.na, i = ki % na, j = kj % na;
  if (kj < na && na <= ki) {  // sc[j][i]
    const Pair<T> q = pair(p, S, d, t, j, i);
    return T(0.5) * (q.b * sn(q.msub) + q.a * sn(q.madd));
  }
  const Pair<T> q = pair(p, S, d, t, i, j);
  if (ki < na && kj < na) return T(0.5) * (q.b * cs(q.msub) - q.a * cs(q.madd));
  if (ki < na) return T(0.5) * (q.b * sn(q.msub) + q.a * sn(q.madd));
  return T(0.5) * (q.b * cs(q.msub) + q.a * cs(q.madd));
}

template <typename T>
__device__ __forceinline__ T y1(const Parts& p, const T* mx, const Terms<T>& t, int k) {
  if (k < p.na) return t.s1[k];
  if (k < p.nt) return t.c1[k - p.na];
  return mx[p.inact[k - p.nt]];
}

// Cov(x_dd, T_k) = S[dd, a_i] * (c1_i for k < na, else -s1_i)
template <typename T>
__device__ __forceinline__ T sxy_t(const Parts& p, const T* S, int d, const Terms<T>& t, int dd,
                                   int k) {
  const int i = k % p.na;
  return S[dd * d + p.act[i]] * (k < p.na ? t.c1[i] : -t.s1[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) enc_fwd_kernel(
    const T* __restrict__ mx_, const T* __restrict__ sxx, T* __restrict__ ym, T* __restrict__ yc,
    T* __restrict__ cr, int N, int d, int na, unsigned long long packed) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const Parts p = decode(d, na, packed);
  const int de = p.de, nt = p.nt;
  const T* mx = mx_ + (size_t)n * d;
  const T* S = sxx + (size_t)n * d * d;
  T* yme = ym + (size_t)n * de;
  T* yce = yc + (size_t)n * de * de;
  T* cre = cr + (size_t)n * d * de;
  Terms<T> t;
  terms(p, mx, S, d, t);

  for (int k = 0; k < de; ++k) yme[k] = y1(p, mx, t, k);
  for (int ki = 0; ki < nt; ++ki)
    for (int kj = 0; kj < nt; ++kj)
      yce[ki * de + kj] = raw2(p, S, d, t, ki, kj) - y1(p, mx, t, ki) * y1(p, mx, t, kj);
  for (int bi = 0; bi < p.nb; ++bi) {
    for (int kj = 0; kj < nt; ++kj) {
      const T c = sxy_t(p, S, d, t, p.inact[bi], kj);
      yce[(nt + bi) * de + kj] = c;
      yce[kj * de + nt + bi] = c;
    }
    for (int bj = 0; bj < p.nb; ++bj)
      yce[(nt + bi) * de + nt + bj] = S[p.inact[bi] * d + p.inact[bj]];
  }
  for (int dd = 0; dd < d; ++dd) {
    for (int k = 0; k < nt; ++k) cre[dd * de + k] = sxy_t(p, S, d, t, dd, k);
    for (int bi = 0; bi < p.nb; ++bi) cre[dd * de + nt + bi] = S[dd * d + p.inact[bi]];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) enc_bwd_kernel(
    const T* __restrict__ mx_, const T* __restrict__ sxx, const T* __restrict__ dym_,
    const T* __restrict__ dyc_, const T* __restrict__ dcr_, T* __restrict__ dmx,
    T* __restrict__ dsxx, int N, int d, int na, unsigned long long packed) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const Parts p = decode(d, na, packed);
  const int de = p.de, nt = p.nt;
  const T* mx = mx_ + (size_t)n * d;
  const T* S = sxx + (size_t)n * d * d;
  const T* dym = dym_ + (size_t)n * de;
  const T* dyc = dyc_ + (size_t)n * de * de;
  const T* dcr = dcr_ + (size_t)n * d * de;
  T* dm = dmx + (size_t)n * d;
  T* dS = dsxx + (size_t)n * d * d;
  Terms<T> t;
  terms(p, mx, S, d, t);

  for (int i = 0; i < d; ++i) dm[i] = T(0);
  for (int i = 0; i < d * d; ++i) dS[i] = T(0);

  // direct inactive-dim contributions
  for (int bi = 0; bi < p.nb; ++bi) {
    const int b = p.inact[bi];
    dm[b] += dym[nt + bi];
    for (int bj = 0; bj < p.nb; ++bj) dS[b * d + p.inact[bj]] += dyc[(nt + bi) * de + nt + bj];
    for (int d0 = 0; d0 < d; ++d0) dS[d0 * d + b] += dcr[d0 * de + nt + bi];
  }

  // cotangents of y1 (the trig means) from y_mean and y_cov's -y1 y1^T
  T dy1[2 * kMaxD];
  for (int k = 0; k < nt; ++k) dy1[k] = dym[k];
  for (int ki = 0; ki < nt; ++ki)
    for (int kj = 0; kj < nt; ++kj) {
      const T g = dyc[ki * de + kj];
      dy1[ki] -= g * y1(p, mx, t, kj);
      dy1[kj] -= g * y1(p, mx, t, ki);
    }

  // sxy_t(d, k) = S[d, a_i] coef(k): its consumers are the cross rows and
  // the TB/BT blocks of y_cov
  T ds1[kMaxD], dc1[kMaxD], dmA[kMaxD], dv[kMaxD];
  for (int i = 0; i < p.na; ++i) ds1[i] = dc1[i] = dmA[i] = dv[i] = T(0);
  for (int dd = 0; dd < d; ++dd) {
    int bi = -1;
    for (int q = 0; q < p.nb; ++q)
      if (p.inact[q] == dd) bi = q;
    for (int k = 0; k < nt; ++k) {
      T g = dcr[dd * de + k];
      if (bi >= 0) g += dyc[(nt + bi) * de + k] + dyc[k * de + nt + bi];
      const int i = k % p.na, a = p.act[i];
      const T coef = k < p.na ? t.c1[i] : -t.s1[i];
      dS[dd * d + a] += g * coef;
      if (k < p.na)
        dc1[i] += g * S[dd * d + a];
      else
        ds1[i] -= g * S[dd * d + a];
    }
  }
  for (int i = 0; i < p.na; ++i) {
    ds1[i] += dy1[i];
    dc1[i] += dy1[p.na + i];
  }

  // raw2 blocks -> (a, b, madd, msub) -> m, v, S
  for (int i = 0; i < p.na; ++i)
    for (int j = 0; j < p.na; ++j) {
      const T dss = dyc[i * de + j];
      const T dcc = dyc[(p.na + i) * de + p.na + j];
      const T dsc = dyc[i * de + p.na + j] + dyc[(p.na + j) * de + i];
      const Pair<T> q = pair(p, S, d, t, i, j);
      const T ca = cs(q.madd), sa = sn(q.madd), cb = cs(q.msub), sb = sn(q.msub);
      const T da = T(0.5) * (-dss * ca + dcc * ca + dsc * sa);
      const T db = T(0.5) * (dss * cb + dcc * cb + dsc * sb);
      const T dmadd = T(0.5) * (dss * q.a * sa - dcc * q.a * sa + dsc * q.a * ca);
      const T dmsub = T(0.5) * (-dss * q.b * sb - dcc * q.b * sb + dsc * q.b * cb);
      const T ga = T(-0.5) * da * q.a, gb = T(-0.5) * db * q.b;
      dv[i] += ga + gb;
      dv[j] += ga + gb;
      dS[p.act[i] * d + p.act[j]] += ga - gb;
      dS[p.act[j] * d + p.act[i]] += ga - gb;
      dmA[i] += dmadd + dmsub;
      dmA[j] += dmadd - dmsub;
    }

  // s1, c1 -> ev, m, v; then v = max(S_ii, 0)
  for (int i = 0; i < p.na; ++i) {
    const T smi = sn(t.m[i]), cmi = cs(t.m[i]);
    const T dev = ds1[i] * smi + dc1[i] * cmi;
    dmA[i] += ds1[i] * t.ev[i] * cmi - dc1[i] * t.ev[i] * smi;
    dv[i] -= T(0.5) * dev * t.ev[i];
  }
  for (int i = 0; i < p.na; ++i) {
    const int a = p.act[i];
    if (S[a * d + a] > T(0)) dS[a * d + a] += dv[i];
    dm[a] += dmA[i];
  }
}

inline int blocks(int N) { return (N + kThreads - 1) / kThreads; }

inline bool bad(int N, int d, int na) { return N <= 0 || d <= 0 || d > kMaxD || na <= 0 || na > d; }

template <typename T>
int launch_fwd(const T* mx, const T* sxx, T* ym, T* yc, T* cr, int N, int d, int na,
               unsigned long long packed, void* stream) {
  if (bad(N, d, na)) return (int)cudaErrorInvalidValue;
  enc_fwd_kernel<T><<<blocks(N), kThreads, 0, (cudaStream_t)stream>>>(mx, sxx, ym, yc, cr, N, d,
                                                                      na, packed);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* mx, const T* sxx, const T* dym, const T* dyc, const T* dcr, T* dmx,
               T* dsxx, int N, int d, int na, unsigned long long packed, void* stream) {
  if (bad(N, d, na)) return (int)cudaErrorInvalidValue;
  enc_bwd_kernel<T><<<blocks(N), kThreads, 0, (cudaStream_t)stream>>>(mx, sxx, dym, dyc, dcr, dmx,
                                                                      dsxx, N, d, na, packed);
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
