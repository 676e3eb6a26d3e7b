"""The PyTorch port's fused encoder match (ops/enc_match_cuda.py, the
counterpart of the Pallas kernel in ops/enc_match_pallas.py) held against
the JAX package in float64: values and gradients against the Pallas kernel
(in TPU interpret mode) and against the unfused Encoder.moment_match of both
packages, and the plain hand adjoint against autograd of the plain forward.
On the CPU the op runs its plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpflowpilco_tpu.components import trigonometric_encoder as jax_encoder
from gpflowpilco_tpu.moments import GaussianMoments as JaxMoments
from gpflowpilco_tpu.ops import enc_match_pallas as jenc
from gpflowpilco_torch.components import Encoder, trigonometric_encoder
from gpflowpilco_torch.moment_matching.rules import Sin
from gpflowpilco_torch.moments import GaussianMoments
from gpflowpilco_torch.ops import enc_match_cuda as ec

from ._torch_export import t

torch.set_num_threads(1)


def _state(seed, d=4, batch=(3,)):
    rng = np.random.default_rng(seed)
    mx = rng.normal(size=batch + (d,))
    a = rng.normal(size=batch + (d, d))
    return mx, 0.3 * a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d)


def _weights(seed, d, de, batch):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=batch + (de,)), rng.normal(size=batch + (de, de)),
            rng.normal(size=batch + (d, de)))


@pytest.mark.parametrize("active", [(1,), (1, 3), (3, 0), (0, 1, 2, 3)])
def test_torch_fused_encoder_matches_jax(active):
    """y_mean, y_cov and Cov(x, y) of Encoder(fused=True) and their
    gradients in the state moments, against the Pallas kernel's custom VJP
    (interpret mode) and the unfused matches of both packages; values to
    rtol 1e-11, gradients to rtol 1e-10. Active dims in any order, with and
    without inactive dims, on a batch of three states."""
    d = 4
    mx, sxx = _state(sum(active) + 10 * len(active))
    meta = jenc.make_enc_meta(active, d)
    w = _weights(7, d, 2 * len(active) + len(meta.inactive), (3,))

    def jax_fn(m, s, fused):
        if fused:
            outs = jenc.fused_encoder_match(meta, m, s)
        else:
            mt = jax_encoder(active).moment_match(JaxMoments(mean=m, cov=s))
            outs = (mt.y.mean, mt.y.cov, mt.cross_covariance(preinv=False))
        return sum(jnp.sum(jnp.asarray(wi) * o) for wi, o in zip(w, outs)), outs

    refs = []
    for fused in (True, False):
        with pltpu.force_tpu_interpret_mode():
            (_, outs), grads = jax.value_and_grad(
                lambda m, s: jax_fn(m, s, fused), argnums=(0, 1), has_aux=True
            )(jnp.asarray(mx), jnp.asarray(sxx))
        refs.append((outs, grads))

    got = {}
    for fused in (True, False):
        tmx, tsxx = t(mx).requires_grad_(True), t(sxx).requires_grad_(True)
        enc = Encoder(trigonometric_encoder(active).transform, active, fused=fused)
        mt = enc.moment_match(GaussianMoments(tmx, tsxx))
        outs = (mt.y.mean, mt.y.cov, mt.cross_covariance(preinv=False))
        sum(torch.sum(t(wi) * o) for wi, o in zip(w, outs)).backward()
        got[fused] = ([o.detach() for o in outs], (tmx.grad, tsxx.grad))
    for outs_ref, grads_ref in refs:
        for g, r in zip(got[True][0], outs_ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-11, atol=1e-13)
        for g, r in zip(got[True][1], grads_ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-12)
    for g, r in zip(got[True][0] + list(got[True][1]), got[False][0] + list(got[False][1])):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)


def test_torch_fused_encoder_hand_adjoint_matches_autograd():
    """The plain hand adjoint against autograd of the plain forward (one
    state has a negative active variance, where max(S_ii, 0) passes no
    gradient); rtol 1e-10."""
    meta = ec.make_enc_meta((2, 0), 5)
    mx, sxx = _state(21, d=5, batch=(4,))
    sxx[1, 2, 2] = -0.05
    tmx, tsxx = t(mx).requires_grad_(True), t(sxx).requires_grad_(True)
    outs = ec.enc_match_reference(meta, tmx, tsxx)
    rng = np.random.default_rng(22)
    cots = [t(rng.normal(size=o.shape)) for o in outs]
    torch.autograd.backward(outs, cots)
    dmx, dsxx = ec.enc_match_reference_bwd(meta, tmx.detach(), tsxx.detach(), *cots)
    torch.testing.assert_close(dmx, tmx.grad, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(dsxx, tsxx.grad, rtol=1e-10, atol=1e-12)


def test_torch_fused_encoder_checks_operands():
    """A transform other than SinCos, a D beyond 16, repeated active dims and
    mixed dtypes raise, on the CPU too."""
    mx, sxx = _state(31, batch=(1,))
    with pytest.raises(ValueError, match="SinCos"):
        Encoder(Sin(), (1,), fused=True).moment_match(GaussianMoments(t(mx), t(sxx)))
    with pytest.raises(ValueError, match="active dims"):
        ec.make_enc_meta((1, 1), 4)
    wide = ec.make_enc_meta((1,), 17)
    mx17, sxx17 = _state(32, d=17, batch=(1,))
    with pytest.raises(ValueError, match="D <= 16"):
        ec.fused_encoder_match(wide, t(mx17), t(sxx17))
    with pytest.raises(TypeError):
        ec.fused_encoder_match(ec.make_enc_meta((1,), 4), t(mx), t(sxx, torch.float32))


def _warp_adjoint(meta, mx, sxx, dym, dyc, dcr):
    """csrc/enc_match.cu's backward (a warp per batch entry) restated in
    float64 torch, phase by phase and entry by entry: (1) the active dims'
    terms, (2) the cross rows' cotangents g[dd][k], the trig means'
    cotangents dy1[k] and the trig pairs' adjoints, (3) each active dim's dv
    and dm, (4) each dm and dS entry summed by its one owning lane (lane e %
    32 of entry e = r D + c) in the kernel's order. Returns (dmx, dsxx)."""
    d, act = meta.num_dim, meta.active
    na, nt, de = len(act), 2 * len(act), meta.num_out
    pos = [act.index(dd) if dd in act else -1 - meta.inactive.index(dd) for dd in range(d)]
    dmx, dsxx = torch.empty_like(mx), torch.empty_like(sxx)
    for n in range(mx.shape[0]):
        x, s, gy, gc, gr = mx[n], sxx[n], dym[n], dyc[n], dcr[n]
        # (1)
        m = [x[a] for a in act]
        v = [torch.clamp(s[a, a], min=0.0) for a in act]
        ev = [torch.exp(-0.5 * vi) for vi in v]
        sm, cm = [torch.sin(mi) for mi in m], [torch.cos(mi) for mi in m]
        y1 = [ev[i] * sm[i] for i in range(na)] + [ev[i] * cm[i] for i in range(na)]
        # (2)
        gx = [[gr[dd, k] + (gc[nt - 1 - pos[dd], k] + gc[k, nt - 1 - pos[dd]] if pos[dd] < 0 else 0.0)
               for k in range(nt)] for dd in range(d)]
        dy1 = [gy[k] - sum((gc[k, j] + gc[j, k]) * y1[j] for j in range(nt)) for k in range(nt)]
        gab, gmb, dmp, dmm = ([[None] * na for _ in range(na)] for _ in range(4))
        for i in range(na):
            for j in range(na):
                vv, cross = v[i] + v[j], s[act[i], act[j]] + s[act[j], act[i]]
                pa, pb = torch.exp(-0.5 * (vv + cross)), torch.exp(-0.5 * (vv - cross))
                sa, ca = torch.sin(m[i] + m[j]), torch.cos(m[i] + m[j])
                sb, cb = torch.sin(m[i] - m[j]), torch.cos(m[i] - m[j])
                dss, dcc = gc[i, j], gc[na + i, na + j]
                dsc = gc[i, na + j] + gc[na + j, i]
                da = 0.5 * (-dss * ca + dcc * ca + dsc * sa)
                db = 0.5 * (dss * cb + dcc * cb + dsc * sb)
                dmadd = 0.5 * (dss * pa * sa - dcc * pa * sa + dsc * pa * ca)
                dmsub = 0.5 * (-dss * pb * sb - dcc * pb * sb + dsc * pb * cb)
                gab[i][j] = -0.5 * da * pa - 0.5 * db * pb
                gmb[i][j] = -0.5 * da * pa + 0.5 * db * pb
                dmp[i][j], dmm[i][j] = dmadd + dmsub, dmadd - dmsub
        # (3)
        dma, dvp = [None] * na, [None] * na
        for i, a in enumerate(act):
            dc1 = sum(gx[dd][i] * s[dd, a] for dd in range(d)) + dy1[na + i]
            ds1 = -sum(gx[dd][na + i] * s[dd, a] for dd in range(d)) + dy1[i]
            dev = ds1 * sm[i] + dc1 * cm[i]
            dma[i] = (sum(dmp[i][j] for j in range(na)) + sum(dmm[j][i] for j in range(na))
                      + ds1 * ev[i] * cm[i] - dc1 * ev[i] * sm[i])
            dv = sum(gab[i][j] for j in range(na)) + sum(gab[j][i] for j in range(na)) - 0.5 * dev * ev[i]
            dvp[i] = dv if s[a, a] > 0 else torch.zeros_like(dv)
        # (4): lane e % 32 owns entry e of dS, lane r entry r of dm
        for lane in range(32):
            for e in range(lane, d * d, 32):
                r, c = divmod(e, d)
                pr, pc = pos[r], pos[c]
                if pc < 0:
                    val = (gc[nt - 1 - pr, nt - 1 - pc] if pr < 0 else 0.0) + gr[r, nt - 1 - pc]
                else:
                    val = gx[r][pc] * y1[na + pc] - gx[r][na + pc] * y1[pc]
                    if pr >= 0:
                        val = val + (gmb[pr][pc] + gmb[pc][pr])
                    if r == c:
                        val = val + dvp[pc]
                dsxx[n, r, c] = val
            if lane < d:
                dmx[n, lane] = gy[nt - 1 - pos[lane]] if pos[lane] < 0 else dma[pos[lane]]
    return dmx, dsxx


@pytest.mark.parametrize("d, active", [(4, (1,)), (6, (4, 0)), (10, (9, 2, 5))])
def test_torch_enc_match_warp_adjoint_matches_reference(d, active):
    """The lane ownership of K4's backward (each dS and dm entry summed by
    its owner in the kernel's order) against enc_match_reference_bwd and
    against the JAX adjoint (the Pallas kernel's custom VJP in interpret
    mode), in float64, to 1e-12 of each output's scale; one state has a
    negative active variance, where max(S_ii, 0) passes no gradient."""
    meta = ec.make_enc_meta(active, d)
    mx, sxx = _state(40 + d, d=d, batch=(3,))
    sxx[1, active[0], active[0]] = -0.05
    w = _weights(41 + d, d, meta.num_out, (3,))
    got = _warp_adjoint(meta, t(mx), t(sxx), *(t(x) for x in w))
    plain = ec.enc_match_reference_bwd(meta, t(mx), t(sxx), *(t(x) for x in w))
    jmeta = jenc.make_enc_meta(active, d)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda m, s: jenc.fused_encoder_match(jmeta, m, s), jnp.asarray(mx), jnp.asarray(sxx))
        jgrads = vjp(tuple(jnp.asarray(x) for x in w))
    for what, x, p, j in zip(("dmx", "dsxx"), got, plain, jgrads):
        for want in (p, torch.as_tensor(np.array(j))):
            err = float((x - want).abs().max()) / (1.0 + float(want.abs().max()))
            assert err <= 1e-12, (what, err)


def _warp_forward(meta, mx, sxx):
    """csrc/enc_match.cu's forward (a warp per batch entry) restated in
    float64 torch: (1) item i < na, active dim i's trig means; item na + i
    na + j, pair (i, j)'s raw ss, cc and sc; (2) item q over the outputs,
    y_mean's de entries, then y_cov's de^2, then cross's D de, each formed
    by its one lane (q % 32) and written once. Returns (y_mean, y_cov,
    cross) and, per output, how many items wrote each entry."""
    d, act = meta.num_dim, meta.active
    na, nt, de = len(act), 2 * len(act), meta.num_out
    inact = meta.inactive
    n = mx.shape[0]
    outs = [torch.full((n, de), float("nan"), dtype=mx.dtype), torch.full((n, de, de), float("nan"), dtype=mx.dtype),
            torch.full((n, d, de), float("nan"), dtype=mx.dtype)]
    writes = [torch.zeros(o.shape[1:], dtype=torch.long) for o in outs]
    for b in range(n):
        x, s = mx[b], sxx[b]
        y1s, ss, cc, sc = [None] * nt, [None] * (na * na), [None] * (na * na), [None] * (na * na)
        for q in range(na + na * na):  # (1)
            if q < na:
                a = act[q]
                e = torch.exp(-0.5 * torch.clamp(s[a, a], min=0.0))
                y1s[q], y1s[na + q] = e * torch.sin(x[a]), e * torch.cos(x[a])
            else:
                ij = q - na
                ai, aj = act[ij // na], act[ij % na]
                vi, vj = torch.clamp(s[ai, ai], min=0.0), torch.clamp(s[aj, aj], min=0.0)
                pa = torch.exp(-0.5 * (vi + vj + s[ai, aj] + s[aj, ai]))
                pb = torch.exp(-0.5 * (vi + vj - s[ai, aj] - s[aj, ai]))
                madd, msub = x[ai] + x[aj], x[ai] - x[aj]
                ss[ij] = 0.5 * (pb * torch.cos(msub) - pa * torch.cos(madd))
                cc[ij] = 0.5 * (pb * torch.cos(msub) + pa * torch.cos(madd))
                sc[ij] = 0.5 * (pb * torch.sin(msub) + pa * torch.sin(madd))
        n_ym, n_yc = de, de + de * de
        for q in range(n_yc + d * de):  # (2)
            if q < n_ym:
                outs[0][b, q] = y1s[q] if q < nt else x[inact[q - nt]]
                writes[0][q] += b == 0
                continue
            cov = q < n_yc
            e = q - n_ym if cov else q - n_yc
            r, k = divmod(e, de)
            if cov and r < nt and k < nt:
                i, j = r % na, k % na
                raw = (ss[i * na + j] if k < na else sc[i * na + j]) if r < na else \
                    (sc[j * na + i] if k < na else cc[i * na + j])
                val = raw - y1s[r] * y1s[k]
            elif cov and r >= nt and k >= nt:
                val = s[inact[r - nt], inact[k - nt]]
            elif not cov and k >= nt:
                val = s[r, inact[k - nt]]
            else:
                dd = r if not cov else inact[r - nt] if r >= nt else inact[k - nt]
                kk = k if not cov or r >= nt else r
                i = kk % na
                val = s[dd, act[i]] * (y1s[na + i] if kk < na else -y1s[i])
            outs[1 if cov else 2][b, r, k] = val
            writes[1 if cov else 2][r, k] += b == 0
    return outs, writes


@pytest.mark.parametrize("d, active", [(4, (1,)), (6, (4, 0)), (10, (9, 2, 5)), (5, (4, 3, 2, 1, 0))])
def test_torch_enc_match_warp_forward_matches_reference(d, active):
    """The item split and lane ownership of K4's forward (the terms once
    each, every output entry formed by one item and written once) against
    enc_match_reference and against the JAX Pallas kernel in interpret
    mode, in float64, to 1e-12 of each output's scale; one state has a
    negative active variance (max(S_ii, 0))."""
    meta = ec.make_enc_meta(active, d)
    mx, sxx = _state(60 + d, d=d, batch=(3,))
    sxx[1, active[0], active[0]] = -0.05
    got, writes = _warp_forward(meta, t(mx), t(sxx))
    assert all(bool((w == 1).all()) for w in writes)
    plain = ec.enc_match_reference(meta, t(mx), t(sxx))
    with pltpu.force_tpu_interpret_mode():
        jouts = jenc.fused_encoder_match(jenc.make_enc_meta(active, d), jnp.asarray(mx), jnp.asarray(sxx))
    for what, x, p, j in zip(("ym", "yc", "cr"), got, plain, jouts):
        for want in (p, torch.as_tensor(np.array(j))):
            err = float((x - want).abs().max()) / (1.0 + float(want.abs().max()))
            assert err <= 1e-12, (what, err)


def _fma32(a, b, c):
    """float32 a * b + c with one rounding (the product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _sin_cos32(x):
    """csrc/enc_match.cu's float sin_cos restated in numpy: three-part
    Cody-Waite reduction by pi/2 up to |x| = 105615, above it Payne-Hanek
    with 2/pi's first 192 bits times the 32-bit mantissa, the three product
    words that the exponent selects, then the minimax polynomials of sin and
    cos on [-pi/4, pi/4] by the quadrant."""
    x = np.asarray(x, np.float32)
    j = np.rint(x * np.float32(0.636619772))
    t = _fma32(-j, np.float32(1.5707962512969971), x)
    t = _fma32(-j, np.float32(7.5497894158615964e-08), t)
    t = _fma32(-j, np.float32(5.3903029534742384e-15), t)
    big = np.abs(x) > np.float32(105615.0)
    q = np.where(big, 0, j).astype(np.int64)
    ia = x.view(np.uint32).astype(np.uint64)
    sign = ia & 0x80000000
    e = ((ia >> 23) & 0xFF) - 128
    mant = ((ia << 8) | 0x80000000) & 0xFFFFFFFF
    words = [0x3C439041, 0xDB629599, 0xF534DDC0, 0xFC2757D1, 0x4E441529, 0xA2F9836E]
    res, carry = [], np.zeros_like(mant)
    for w in words:
        p = mant * np.uint64(w)
        lo = (carry + (p & 0xFFFFFFFF)) & 0xFFFFFFFF
        carry = (p >> 32) + (lo < (p & 0xFFFFFFFF))
        res.append(lo)
    res.append(carry)
    res = np.stack(res)  # (7, ...), least significant first
    idx = np.clip(4 - (e >> 5).astype(np.int64), 1, 4)
    sh = (e & 31).astype(np.uint64)
    pick = lambda k: np.take_along_axis(res, (idx + k)[None], 0)[0]  # noqa: E731
    hi, lo, below = pick(2), pick(1), pick(0)
    win = ((hi << 32) | lo) << sh | (below >> (32 - sh)) * (sh > 0)
    win &= 0xFFFFFFFFFFFFFFFF
    qb = (win >> 62).astype(np.int64)
    frac = (win << 2) & 0xFFFFFFFFFFFFFFFF  # 0.frac in 64 bits
    hi, lo = frac >> 32, frac & 0xFFFFFFFF
    up = (hi + (lo > 0)) > 0x80000000
    qb = np.where(sign > 0, -(qb + up), qb + up)
    frac = np.where(up, (0 - frac) & 0xFFFFFFFFFFFFFFFF, frac)
    sign = np.where(up, sign ^ 0x80000000, sign)
    hi = frac >> 32
    nz = (hi > 0) & (hi < 0x80000000)
    shift = np.where(nz, 32 - np.frexp(hi.astype(np.float64))[1], 0).astype(np.uint64)
    frac = (frac << shift) & 0xFFFFFFFFFFFFFFFF
    ex = -shift.astype(np.int64)
    prod = (frac >> 32) * np.uint64(0xC90FDAA2)
    hi, lo = prod >> 32, prod & 0xFFFFFFFF
    low = (hi > 0) & (hi < 0x80000000)
    hi = np.where(low, ((hi << 1) | (lo >> 31)) & 0xFFFFFFFF, hi)
    lo = np.where(low, (lo << 1) & 0xFFFFFFFF, lo)
    ex = ex - low
    hi = hi + (lo > 0)
    bits = (sign | ((((ex + 126) << 23).astype(np.uint64) + (hi >> 8) + (((hi << 24) & 0xFFFFFFFF) >= 0x80000000))
                    & 0xFFFFFFFF)).astype(np.uint32)
    t = np.where(big, bits.view(np.float32), t)
    q = np.where(big, qb, q)

    def quadrant(t, q):
        t2 = t * t
        zc = _fma32(np.float32(2.44331571e-5), t2, np.float32(-1.38873163e-3))
        zc = _fma32(_fma32(_fma32(zc, t2, np.float32(4.16666457e-2)), t2, np.float32(-0.5)), t2, np.float32(1.0))
        zs = _fma32(np.float32(-1.95152959e-4), t2, np.float32(8.33216087e-3))
        zs = _fma32(_fma32(zs, t2, np.float32(-1.66666546e-1)) * t2, t, t)
        z = np.where(q & 1, zc, zs)
        return np.where(q & 2, -z, z)

    return quadrant(t, q), quadrant(t, q + 1)


def test_torch_enc_match_float_sin_cos_within_two_ulp():
    """The float32 sin and cos of K4's backward (no local memory: the
    Payne-Hanek product words stay in registers) are within 2 ulp of the
    correctly rounded values, below and above the reduction's switch at
    |x| = 105615 and over random bit patterns across the float range."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2**32, size=200_000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    x = np.concatenate([rng.uniform(-10, 10, 200_000), rng.uniform(-2e5, 2e5, 200_000),
                        bits[np.isfinite(bits)], [105615.0, 105616.0, -3.4e38, 1e7, 0.0]]).astype(np.float32)
    s, c = _sin_cos32(x)
    for got, want in ((s, np.sin(x.astype(np.float64))), (c, np.cos(x.astype(np.float64)))):
        w32 = want.astype(np.float32)
        ulp = np.abs(np.nextafter(w32, np.float32(np.inf)) - w32).astype(np.float64)
        err = np.abs(got.astype(np.float64) - want) / np.maximum(ulp, 1e-45)
        assert err.max() <= 2.0, (float(err.max()), x[np.argmax(err)])
