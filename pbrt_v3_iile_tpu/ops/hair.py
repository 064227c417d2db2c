"""Hair BSDF — Marschner/d'Eon-style fiber scattering, fully vectorized.

Parity target: the reference's hair material (ref: src/materials/hair.{h,cpp}
— HairBSDF::f, ::Sample_f, ::Pdf, ::ComputeApPdf and the helpers Mp/Ap/Np/
Phi/Logistic/TrimmedLogistic, hair.cpp:~60-430), itself the pbrt-v3
implementation of "A Practical and Controllable Hair and Fur Model for
Production Path Tracing" (Chiang et al. 2016).

Wavefront restructuring: instead of a per-hit virtual BxDF with pMax
scalar loops, every quantity is computed for the whole wavefront at once;
the p = 0..2 lobe loop is unrolled into stacked (4,N) arrays so the whole
evaluation is a handful of fused vector passes (exp/log/trig on (N,) lanes) —
no per-ray control flow, no data-dependent branches.

Conventions match the reference: directions are in the curve's local frame
with +x along the fiber tangent, (y,z) the normal plane; `h` in [-1,1] is
the ray's offset across the fiber width (ref: hair.cpp h = -1 + 2*v).
Since curves are tessellated to ribbons in this framework (scene/shapes.py),
`h` is reconstructed from the interpolated v coordinate.
"""

from __future__ import annotations

import jax.numpy as jnp

PMAX = 3
SQRT_PI_OVER_8 = 0.626657069
TWO_PI = 2.0 * jnp.pi


# ---------------------------------------------------------------------------
# numeric helpers (ref: hair.cpp I0/LogI0/Logistic/LogisticCDF/TrimmedLogistic)
# ---------------------------------------------------------------------------

def _i0(x):
    """Modified Bessel I0, 10-term series (ref: hair.cpp I0)."""
    val = jnp.zeros_like(x)
    x2i = jnp.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


def _log_i0(x):
    """(ref: hair.cpp LogI0)."""
    big = x > 12.0
    safe = jnp.maximum(x, 1e-6)
    log_big = safe + 0.5 * (-jnp.log(TWO_PI) + jnp.log(1.0 / safe)
                            + 1.0 / (8.0 * safe))
    return jnp.where(big, log_big, jnp.log(_i0(jnp.minimum(x, 12.0))))


def _logistic(x, s):
    x = jnp.abs(x)
    e = jnp.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + jnp.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    """(ref: hair.cpp SampleTrimmedLogistic)."""
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    t = u * k + _logistic_cdf(a, s)
    t = jnp.clip(t, 1e-6, 1.0 - 1e-6)
    x = -s * jnp.log(1.0 / t - 1.0)
    return jnp.clip(x, a, b)


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def _safe_asin(x):
    return jnp.arcsin(jnp.clip(x, -1.0, 1.0))


def _fr_dielectric(cos_i, eta):
    """Unpolarized Fresnel, external side (ref: reflection.cpp FrDielectric)."""
    cos_i = jnp.clip(cos_i, 0.0, 1.0)
    sin_t = _safe_sqrt(1.0 - cos_i * cos_i) / eta
    total = sin_t >= 1.0
    cos_t = _safe_sqrt(1.0 - sin_t * sin_t)
    r_par = (eta * cos_i - cos_t) / jnp.maximum(eta * cos_i + cos_t, 1e-9)
    r_perp = (cos_i - eta * cos_t) / jnp.maximum(cos_i + eta * cos_t, 1e-9)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return jnp.where(total, 1.0, f)


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------

def beta_to_v(beta_m):
    """Longitudinal roughness -> lobe variances (4,N)
    (ref: hair.cpp HairBSDF ctor v[] init)."""
    v0 = (0.726 * beta_m + 0.812 * beta_m ** 2 + 3.7 * beta_m ** 20) ** 2
    return jnp.stack([v0, 0.25 * v0, 4.0 * v0, 4.0 * v0], axis=0)


def beta_to_s(beta_n):
    """Azimuthal roughness -> logistic scale (ref: hair.cpp ctor s)."""
    return SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * beta_n ** 2
                             + 5.372 * beta_n ** 22)


def _tilt_tables(alpha_deg):
    """sin/cos of 2^k * alpha for k=0,1,2 (ref: hair.cpp ctor
    sin2kAlpha/cos2kAlpha doubling recurrence)."""
    a = jnp.deg2rad(alpha_deg)
    s0 = jnp.sin(a)
    c0 = _safe_sqrt(1.0 - s0 * s0)
    s1 = 2.0 * c0 * s0
    c1 = c0 * c0 - s0 * s0
    s2 = 2.0 * c1 * s1
    c2 = c1 * c1 - s1 * s1
    return (s0, s1, s2), (c0, c1, c2)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering (ref: hair.cpp Mp)."""
    v = jnp.maximum(v, 1e-7)
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small = v <= 0.1
    mp_small = jnp.exp(_log_i0(a) - b - 1.0 / v + 0.6931
                       + jnp.log(1.0 / (2.0 * v)))
    # sinh(1/v) overflows for small v; only used on the v > .1 branch
    inv_v = 1.0 / jnp.where(small, 1.0, v)
    mp_big = jnp.exp(-b) * _i0(a) / (jnp.sinh(inv_v) * 2.0 *
                                     jnp.where(small, 1.0, v))
    return jnp.where(small, mp_small, mp_big)


def _ap(cos_to, eta, h, transmittance):
    """Attenuation of lobes p=0..3 (ref: hair.cpp Ap) -> (4,N,3)."""
    cos_go = _safe_sqrt(1.0 - h * h)
    cos_theta = cos_to * cos_go
    f = _fr_dielectric(cos_theta, eta)[..., None]
    T = transmittance
    a0 = jnp.broadcast_to(f, T.shape)
    a1 = (1.0 - f) ** 2 * T
    a2 = a1 * T * f
    # residual: sum of remaining bounces (geometric series)
    a3 = a2 * f * T / jnp.maximum(1.0 - T * f, 1e-4)
    return jnp.stack([a0, a1, a2, a3], axis=0)


def _phi_fn(p, gamma_o, gamma_t):
    """Net azimuthal deflection of lobe p (ref: hair.cpp Phi)."""
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * jnp.pi


def _np(phi, p, s, gamma_o, gamma_t):
    """Azimuthal scattering (ref: hair.cpp Np)."""
    dphi = phi - _phi_fn(p, gamma_o, gamma_t)
    dphi = jnp.mod(dphi + jnp.pi, TWO_PI) - jnp.pi
    return _trimmed_logistic(dphi, s, -jnp.pi, jnp.pi)


def _tilted_to(p_idx, sin_to, cos_to, sin2k, cos2k):
    """Apply lobe-dependent scale tilt to theta_o (ref: hair.cpp f()
    sinThetaOp/cosThetaOp cases).  p_idx in {0,1,2}."""
    if p_idx == 0:
        s = sin_to * cos2k[1] - cos_to * sin2k[1]
        c = cos_to * cos2k[1] + sin_to * sin2k[1]
    elif p_idx == 1:
        s = sin_to * cos2k[0] + cos_to * sin2k[0]
        c = cos_to * cos2k[0] - sin_to * sin2k[0]
    else:
        s = sin_to * cos2k[2] + cos_to * sin2k[2]
        c = cos_to * cos2k[2] - sin_to * sin2k[2]
    return s, jnp.abs(c)


def _geom(wo, wi, h, eta, sigma_a):
    """Shared per-pair quantities."""
    sin_to = wo[..., 0]
    cos_to = _safe_sqrt(1.0 - sin_to * sin_to)
    phi_o = jnp.arctan2(wo[..., 2], wo[..., 1])
    sin_ti = wi[..., 0]
    cos_ti = _safe_sqrt(1.0 - sin_ti * sin_ti)
    phi_i = jnp.arctan2(wi[..., 2], wi[..., 1])

    sin_tt = sin_to / eta
    cos_tt = _safe_sqrt(1.0 - sin_tt * sin_tt)
    etap = _safe_sqrt(eta * eta - sin_to * sin_to) / jnp.maximum(cos_to, 1e-6)
    sin_gt = h / jnp.maximum(etap, 1e-6)
    cos_gt = _safe_sqrt(1.0 - sin_gt * sin_gt)
    gamma_t = _safe_asin(sin_gt)
    gamma_o = _safe_asin(h)
    # absorption along the internal chord (ref: hair.cpp f() T=Exp(-sigma_a*
    # (2*cosGammaT/cosThetaT)))
    T = jnp.exp(-sigma_a * (2.0 * cos_gt / jnp.maximum(cos_tt, 1e-5))[..., None])
    return (sin_to, cos_to, phi_o, sin_ti, cos_ti, phi_i,
            gamma_o, gamma_t, T)


# ---------------------------------------------------------------------------
# public API: evaluate / pdf / sample (wavefront)
# ---------------------------------------------------------------------------

def evaluate(wo, wi, h, sigma_a, beta_m, beta_n, alpha_deg=2.0, eta=1.55):
    """HairBSDF::f for a wavefront.  wo/wi (N,3) local (+x = fiber tangent),
    h (N,), sigma_a (N,3), beta_m/beta_n (N,).  Returns f (N,3)."""
    eta = jnp.broadcast_to(jnp.asarray(eta, jnp.float32), h.shape)
    (sin_to, cos_to, phi_o, sin_ti, cos_ti, phi_i,
     gamma_o, gamma_t, T) = _geom(wo, wi, h, eta, sigma_a)
    v = beta_to_v(beta_m)
    s = beta_to_s(beta_n)
    sin2k, cos2k = _tilt_tables(jnp.broadcast_to(
        jnp.asarray(alpha_deg, jnp.float32), h.shape))
    ap = _ap(cos_to, eta, h, T)
    phi = phi_i - phi_o

    fsum = jnp.zeros_like(sigma_a)
    for p in range(PMAX):
        sin_top, cos_top = _tilted_to(p, sin_to, cos_to, sin2k, cos2k)
        mp = _mp(cos_ti, cos_top, sin_ti, sin_top, v[p])
        np_ = _np(phi, float(p), s, gamma_o, gamma_t)
        fsum = fsum + (mp * np_)[..., None] * ap[p]
    mp_last = _mp(cos_ti, cos_to, sin_ti, sin_to, v[PMAX])
    fsum = fsum + (mp_last / TWO_PI)[..., None] * ap[PMAX]

    abscos = jnp.abs(wi[..., 2])
    fsum = jnp.where((abscos > 0.0)[..., None],
                     fsum / jnp.maximum(abscos, 1e-6)[..., None], fsum)
    return fsum


def _ap_pdf(cos_to, eta, h, T):
    """Luminance-normalized lobe selection pdf (ref: hair.cpp
    ComputeApPdf) -> (4,N)."""
    ap = _ap(cos_to, eta, h, T)
    y = (0.212671 * ap[..., 0] + 0.715160 * ap[..., 1]
         + 0.072169 * ap[..., 2])
    tot = jnp.sum(y, axis=0, keepdims=True)
    return y / jnp.maximum(tot, 1e-9)


def pdf(wo, wi, h, sigma_a, beta_m, beta_n, alpha_deg=2.0, eta=1.55):
    """HairBSDF::Pdf (ref: hair.cpp Pdf)."""
    eta = jnp.broadcast_to(jnp.asarray(eta, jnp.float32), h.shape)
    (sin_to, cos_to, phi_o, sin_ti, cos_ti, phi_i,
     gamma_o, gamma_t, T) = _geom(wo, wi, h, eta, sigma_a)
    v = beta_to_v(beta_m)
    s = beta_to_s(beta_n)
    sin2k, cos2k = _tilt_tables(jnp.broadcast_to(
        jnp.asarray(alpha_deg, jnp.float32), h.shape))
    appdf = _ap_pdf(cos_to, eta, h, T)
    phi = phi_i - phi_o

    out = jnp.zeros_like(h)
    for p in range(PMAX):
        sin_top, cos_top = _tilted_to(p, sin_to, cos_to, sin2k, cos2k)
        mp = _mp(cos_ti, cos_top, sin_ti, sin_top, v[p])
        out = out + mp * appdf[p] * _np(phi, float(p), s, gamma_o, gamma_t)
    out = out + _mp(cos_ti, cos_to, sin_ti, sin_to, v[PMAX]) \
        * appdf[PMAX] / TWO_PI
    return out


def sample(wo, u4, h, sigma_a, beta_m, beta_n, alpha_deg=2.0, eta=1.55):
    """HairBSDF::Sample_f (ref: hair.cpp Sample_f).

    u4: (N,4) uniforms [lobe pick, phi, theta-u0, theta-u1].
    Returns (wi (N,3), f (N,3), pdf (N,))."""
    eta = jnp.broadcast_to(jnp.asarray(eta, jnp.float32), h.shape)
    sin_to = wo[..., 0]
    cos_to = _safe_sqrt(1.0 - sin_to * sin_to)
    phi_o = jnp.arctan2(wo[..., 2], wo[..., 1])
    sin_tt = sin_to / eta
    cos_tt = _safe_sqrt(1.0 - sin_tt * sin_tt)
    etap = _safe_sqrt(eta * eta - sin_to * sin_to) / jnp.maximum(cos_to, 1e-6)
    sin_gt = h / jnp.maximum(etap, 1e-6)
    cos_gt = _safe_sqrt(1.0 - sin_gt * sin_gt)
    gamma_t = _safe_asin(sin_gt)
    gamma_o = _safe_asin(h)
    T = jnp.exp(-sigma_a * (2.0 * cos_gt /
                            jnp.maximum(cos_tt, 1e-5))[..., None])

    v = beta_to_v(beta_m)
    s = beta_to_s(beta_n)
    sin2k, cos2k = _tilt_tables(jnp.broadcast_to(
        jnp.asarray(alpha_deg, jnp.float32), h.shape))
    appdf = _ap_pdf(cos_to, eta, h, T)          # (4,N)

    # pick lobe p by CDF inversion (ref: Sample_f "p" loop)
    cdf = jnp.cumsum(appdf, axis=0)
    u0 = u4[..., 0]
    p_pick = jnp.sum((u0[None, :] > cdf).astype(jnp.int32), axis=0)
    p_pick = jnp.clip(p_pick, 0, PMAX)

    # tilted theta_o for the picked lobe (identity for the residual lobe)
    tilts = [_tilted_to(p, sin_to, cos_to, sin2k, cos2k) for p in range(PMAX)]
    tilts.append((sin_to, cos_to))
    sin_top = jnp.select([p_pick == p for p in range(PMAX + 1)],
                         [t[0] for t in tilts])
    cos_top = jnp.select([p_pick == p for p in range(PMAX + 1)],
                         [t[1] for t in tilts])

    # longitudinal sample (ref: Sample_f cosTheta = 1 + v*log(...))
    vp = jnp.take_along_axis(v, p_pick[None, :], axis=0)[0]
    u_th = jnp.maximum(u4[..., 2], 1e-5)
    cos_theta = 1.0 + vp * jnp.log(u_th + (1.0 - u_th)
                                   * jnp.exp(-2.0 / jnp.maximum(vp, 1e-7)))
    sin_theta = _safe_sqrt(1.0 - cos_theta * cos_theta)
    cos_phi_l = jnp.cos(TWO_PI * u4[..., 3])
    sin_ti = -cos_theta * sin_top + sin_theta * cos_phi_l * cos_top
    cos_ti = _safe_sqrt(1.0 - sin_ti * sin_ti)

    # azimuthal sample
    u_phi = u4[..., 1]
    dphi_smooth = jnp.stack(
        [_phi_fn(float(p), gamma_o, gamma_t)
         + _sample_trimmed_logistic(u_phi, s, -jnp.pi, jnp.pi)
         for p in range(PMAX)], axis=0)
    dphi = jnp.where(p_pick < PMAX,
                     jnp.take_along_axis(
                         dphi_smooth, jnp.clip(p_pick, 0, PMAX - 1)[None, :],
                         axis=0)[0],
                     TWO_PI * u_phi)
    phi_i = phi_o + dphi
    wi = jnp.stack([sin_ti, cos_ti * jnp.cos(phi_i),
                    cos_ti * jnp.sin(phi_i)], axis=-1)

    f = evaluate(wo, wi, h, sigma_a, beta_m, beta_n, alpha_deg, eta)
    p_ = pdf(wo, wi, h, sigma_a, beta_m, beta_n, alpha_deg, eta)
    return wi, f, p_


def sigma_a_from_concentration(eumelanin, pheomelanin):
    """(ref: hair.cpp SigmaAFromConcentration) -> (3,) RGB absorption."""
    eum = jnp.asarray([0.419, 0.697, 1.37], jnp.float32)
    pheo = jnp.asarray([0.187, 0.4, 1.05], jnp.float32)
    return eumelanin * eum + pheomelanin * pheo


def sigma_a_from_reflectance(c, beta_n):
    """(ref: hair.cpp SigmaAFromReflectance)."""
    t = (jnp.log(jnp.maximum(c, 1e-5)) /
         (5.969 - 0.215 * beta_n + 2.532 * beta_n ** 2
          - 10.73 * beta_n ** 3 + 5.574 * beta_n ** 4
          + 0.245 * beta_n ** 5))
    return t * t
