"""Wavefront BSDF evaluation and sampling.

Re-expresses the reference's BxDF class hierarchy (ref:
src/core/reflection.{h,cpp}: LambertianReflection, OrenNayar,
MicrofacetReflection, FresnelSpecular, SpecularReflection; BSDF::f
reflection.cpp:686, BSDF::Sample_f reflection.cpp:719; microfacet math in
src/core/microfacet.cpp) as a fixed set of *lobes* evaluated for the whole
wavefront with per-ray masks — no virtual dispatch, one vector pass per lobe.

All directions are in the local shading frame (+z = shading normal).
Lobe selection is luminance-weighted (an improvement over the reference's
uniform component choice; both are unbiased).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..utils import vecmath as vm
from . import sampling as smp
from ..scene.api import (
    MAT_NONE, MAT_MATTE, MAT_PLASTIC, MAT_MIRROR, MAT_GLASS, MAT_METAL,
    MAT_UBER, MAT_SUBSTRATE, MAT_TRANSLUCENT, MAT_DISNEY, MAT_HAIR,
    MAT_FOURIER, MAT_SUBSURFACE,
)
from . import hair as hairlib

INV_PI = 1.0 / jnp.pi


class BsdfParams(NamedTuple):
    kind: jnp.ndarray        # (N,) i32
    kd: jnp.ndarray          # (N,3) diffuse
    ks: jnp.ndarray          # (N,3) glossy
    kr: jnp.ndarray          # (N,3) specular reflection
    kt: jnp.ndarray          # (N,3) specular transmission
    alpha: jnp.ndarray       # (N,) microfacet alpha (post roughness-remap)
    eta: jnp.ndarray         # (N,) dielectric IOR
    metal_eta: jnp.ndarray   # (N,3)
    metal_k: jnp.ndarray     # (N,3)
    sigma: jnp.ndarray       # (N,) oren-nayar sigma (degrees)
    aux: jnp.ndarray         # (N,8) disney [metallic, specTint, sheen,
                             # sheenTint, clearcoat, ccGloss, specTrans,
                             # flatness] (ref: materials/disney.cpp);
                             # for hair: [beta_m, beta_n, alpha_deg, ...]
                             # with sigma_a stored in kd
    h: jnp.ndarray = None    # (N,) hair fiber offset in [-1,1]
                             # (ref: hair.cpp h = -1 + 2*v); None when the
                             # caller has no uv (treated as h = 0)
    fourier_id: jnp.ndarray = None  # (N,) i32 fourier table id (-1 none)
    fourier: object = None   # shared FourierDev tables (static gate:
                             # None when the scene has no fourier material)


def roughness_to_alpha(rough):
    """(ref: microfacet.h TrowbridgeReitzDistribution::RoughnessToAlpha)."""
    r = jnp.maximum(rough, 1e-3)
    x = jnp.log(r)
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


def gather_params(scene, mat_id, uv=None, p=None,
                  tex_width=None, face=None) -> BsdfParams:
    """Material SoA gather + texture evaluation at the hit
    (ref: Material::ComputeScatteringFunctions evaluating Texture::Evaluate,
    src/materials/matte.cpp:46 etc.).  uv (N,2) / p (N,3) enable textured
    slots; without them constants are used.  tex_width: optional (N,)
    UV-space ray-cone footprint for mip selection (scene/textures.py).
    face: optional (N,) i32 ptex face index (Interaction.face)."""
    from ..scene import textures as texlib

    g = lambda a: jnp.take(a, mat_id, axis=0)
    rough = g(scene.mat_rough)
    uro = g(scene.mat_urough)
    rough = jnp.where(uro >= 0.0, jnp.where(uro > 0, uro, rough), rough)
    kd = g(scene.mat_kd)
    ks = g(scene.mat_ks)
    sigma = g(scene.mat_sigma)
    if uv is not None and int(scene.textures.kind.shape[0]) > 1:
        if p is None:
            p = jnp.zeros(uv.shape[:-1] + (3,), uv.dtype)
        kd_t = g(scene.mat_kd_tex)
        ks_t = g(scene.mat_ks_tex)
        sg_t = g(scene.mat_sigma_tex)
        ro_t = g(scene.mat_rough_tex)
        tw = tex_width
        kd = jnp.where((kd_t >= 0)[..., None],
                       texlib.eval_texture(scene.textures, kd_t, uv, p, tw, face),
                       kd)
        ks = jnp.where((ks_t >= 0)[..., None],
                       texlib.eval_texture(scene.textures, ks_t, uv, p, tw, face),
                       ks)
        sigma = jnp.where(
            sg_t >= 0,
            texlib.eval_texture(scene.textures, sg_t, uv, p, tw, face)[..., 0],
            sigma)
        rough = jnp.where(
            ro_t >= 0,
            texlib.eval_texture(scene.textures, ro_t, uv, p, tw, face)[..., 0],
            rough)
    remap = g(scene.mat_remap) > 0.5
    kind = g(scene.mat_kind)
    alpha = jnp.where(remap, roughness_to_alpha(rough),
                      jnp.maximum(rough, 1e-3))
    # disney's own remap (ref: disney.cpp: microRough = sqr(rough))
    alpha = jnp.where(kind == MAT_DISNEY,
                      jnp.maximum(rough * rough, 1e-3), alpha)
    # hair: curve ribbons carry the across-fiber coordinate in v, so the
    # ray's fiber offset is h = -1 + 2*frac(v) (ref: shapes/curve.cpp via
    # hair.cpp h = -1 + 2*v; here curves are tessellated ribbons)
    if uv is not None:
        v_coord = uv[..., 1] - jnp.floor(uv[..., 1])
        h = jnp.clip(-1.0 + 2.0 * v_coord, -0.9995, 0.9995)
    else:
        h = jnp.zeros(kind.shape, jnp.float32)
    fourier = getattr(scene, "fourier", None)
    return BsdfParams(
        kind=kind,
        kd=kd, ks=ks,
        kr=g(scene.mat_kr), kt=g(scene.mat_kt),
        alpha=alpha, eta=g(scene.mat_eta),
        metal_eta=g(scene.mat_metal_eta), metal_k=g(scene.mat_metal_k),
        sigma=sigma, aux=g(scene.mat_aux), h=h,
        fourier_id=(g(scene.mat_fourier_id) if fourier is not None
                    else None),
        fourier=fourier,
    )


# ---------------------------------------------------------------------------
# Fresnel
# ---------------------------------------------------------------------------

def fr_dielectric(cos_i, eta_i, eta_t):
    """(ref: reflection.cpp FrDielectric) — cos_i may be signed."""
    entering = cos_i > 0.0
    ei = jnp.where(entering, eta_i, eta_t)
    et = jnp.where(entering, eta_t, eta_i)
    ci = jnp.abs(jnp.clip(cos_i, -1.0, 1.0))
    sin_i = jnp.sqrt(jnp.maximum(0.0, 1.0 - ci * ci))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t * sin_t))
    r_par = (et * ci - ei * ct) / jnp.maximum(et * ci + ei * ct, 1e-9)
    r_perp = (ei * ci - et * ct) / jnp.maximum(ei * ci + et * ct, 1e-9)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return jnp.where(tir, 1.0, fr)


def fr_conductor(cos_i, eta, k):
    """(ref: reflection.cpp FrConductor) — eta, k are (N,3) rgb."""
    ci = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)[..., None]
    c2 = ci * ci
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * e2 * k2, 0.0))
    t1 = a2b2 + c2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-9)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-9)
    return 0.5 * (rp + rs)


def schlick_fresnel(rs, cos_i):
    """(ref: reflection.h FresnelBlend::SchlickFresnel)."""
    pw = jnp.power(jnp.clip(1.0 - cos_i, 0.0, 1.0), 5.0)[..., None]
    return rs + pw * (1.0 - rs)


def fresnel_moment1(eta):
    """First moment of the Fresnel reflectance, polynomial fits
    (ref: core/bssrdf.cpp FresnelMoment1)."""
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return jnp.where(eta < 1.0, lo, hi)


# ---------------------------------------------------------------------------
# Trowbridge-Reitz (GGX) microfacet distribution, isotropic
# (ref: src/core/microfacet.cpp)
# ---------------------------------------------------------------------------

def _cos2(w):
    return jnp.clip(w[..., 2] * w[..., 2], 0.0, 1.0)


def tr_d(wh, alpha):
    c2 = _cos2(wh)
    s2 = jnp.maximum(1.0 - c2, 0.0)
    a2 = alpha * alpha
    e = c2 + s2 / jnp.maximum(a2, 1e-9)
    d = 1.0 / (jnp.pi * a2 * jnp.maximum(e * e, 1e-12))
    return jnp.where(c2 > 0.0, d, 0.0)


def tr_lambda(w, alpha):
    c2 = _cos2(w)
    s2 = jnp.maximum(1.0 - c2, 0.0)
    tan2 = s2 / jnp.maximum(c2, 1e-9)
    return jnp.where(
        c2 > 1e-9,
        0.5 * (-1.0 + jnp.sqrt(jnp.maximum(1.0 + alpha * alpha * tan2, 0.0))),
        1e9,
    )


def tr_g(wo, wi, alpha):
    return 1.0 / (1.0 + tr_lambda(wo, alpha) + tr_lambda(wi, alpha))


def tr_sample_wh(wo, u, alpha):
    """Sample full NDF (isotropic).  The reference samples visible normals
    (microfacet.cpp TrowbridgeReitzSample); both give unbiased estimators —
    the pdf below matches this sampler."""
    tan2 = alpha * alpha * u[..., 0] / jnp.maximum(1.0 - u[..., 0], 1e-9)
    cos_t = 1.0 / jnp.sqrt(1.0 + tan2)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * jnp.pi * u[..., 1]
    wh = vm.spherical_direction(sin_t, cos_t, phi)
    # flip to wo's hemisphere
    return jnp.where((wo[..., 2:3] * wh[..., 2:3]) < 0.0, -wh, wh)


def tr_pdf(wo, wh, alpha):
    return tr_d(wh, alpha) * jnp.abs(wh[..., 2])


def gtr1_d(wh, a):
    """Berry/GTR1 clearcoat distribution (ref: disney.cpp GTR1)."""
    a2 = a * a
    c2 = _cos2(wh)
    denom = jnp.pi * jnp.log(jnp.maximum(a2, 1e-6)) * (1.0 + (a2 - 1.0) * c2)
    return (a2 - 1.0) / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)


def _smith_g_ggx(cos_t, a):
    """(ref: disney.cpp smithG_GGX)."""
    c2 = cos_t * cos_t
    a2 = a * a
    return 1.0 / jnp.maximum(cos_t + jnp.sqrt(a2 + c2 - a2 * c2), 1e-7)


def _schlick_weight(c):
    return jnp.power(jnp.clip(1.0 - c, 0.0, 1.0), 5.0)


# ---------------------------------------------------------------------------
# Lobe presence weights per material kind
# ---------------------------------------------------------------------------

def _lum(rgb):
    return vm.luminance(jnp.maximum(rgb, 0.0))




def _lobe_weights(p: BsdfParams):
    """Returns per-lobe selection weights (N,4):
    0 diffuse, 1 glossy-microfacet, 2 specular-reflect, 3 specular-transmit.
    """
    k = p.kind
    w_d = jnp.where((k == MAT_MATTE) | (k == MAT_PLASTIC) | (k == MAT_UBER)
                    | (k == MAT_SUBSTRATE) | (k == MAT_TRANSLUCENT)
                    | (k == MAT_FOURIER) | (k == MAT_SUBSURFACE),
                    _lum(p.kd), 0.0)
    w_g = jnp.where((k == MAT_PLASTIC) | (k == MAT_UBER)
                    | (k == MAT_TRANSLUCENT) | (k == MAT_FOURIER),
                    _lum(p.ks), 0.0)
    w_g = jnp.where(k == MAT_METAL, 1.0, w_g)
    w_g = jnp.where(k == MAT_HAIR, 1.0, w_g)
    w_g = jnp.where(k == MAT_SUBSTRATE, _lum(p.ks), w_g)
    w_r = jnp.where((k == MAT_MIRROR) | (k == MAT_UBER)
                    | (k == MAT_SUBSURFACE), _lum(p.kr), 0.0)
    w_r = jnp.where(k == MAT_GLASS, _lum(p.kr), w_r)
    w_t = jnp.where(k == MAT_GLASS, _lum(p.kt), 0.0)
    # disney: diffuse gated by (1-metallic)(1-specTrans); glossy always
    # present (metal blend + clearcoat); specTrans adds delta transmission
    # (ref: disney.cpp DisneyMaterial::ComputeScatteringFunctions)
    is_dis = k == MAT_DISNEY
    metallic = p.aux[..., 0]
    spec_trans = p.aux[..., 6]
    w_d = jnp.where(is_dis,
                    (1.0 - metallic) * (1.0 - spec_trans) * _lum(p.kd), w_d)
    w_g = jnp.where(is_dis,
                    0.25 * p.aux[..., 4] + jnp.maximum(
                        metallic * _lum(p.kd), 0.08), w_g)
    w_t = jnp.where(is_dis, spec_trans * (1.0 - metallic), w_t)
    w = jnp.stack([w_d, w_g, w_r, w_t], axis=-1)
    tot = jnp.sum(w, axis=-1, keepdims=True)
    # default to diffuse when nothing present (black body)
    w = jnp.where(tot > 0.0, w / jnp.maximum(tot, 1e-12), 0.0)
    return w


def _same_hemisphere(a, b):
    return (a[..., 2] * b[..., 2]) > 0.0


# ---------------------------------------------------------------------------
# Evaluate (non-specular lobes only, like BSDF::f with ~BSDF_SPECULAR)
# ---------------------------------------------------------------------------

def evaluate(p: BsdfParams, wo, wi, enable_hair: bool = True):
    """Returns (f (N,3), pdf (N,)) for non-delta lobes.

    Mirrors BSDF::f + BSDF::Pdf (reflection.cpp:686, :776) with the lobe
    model: pdf is the selection-weighted mix of lobe pdfs.

    enable_hair statically gates the fiber lobe (callers that know the
    scene has no hair material — PathConfig.has_hair — skip its cost).
    """
    w = _lobe_weights(p)
    refl = _same_hemisphere(wo, wi)
    cos_o = jnp.abs(wo[..., 2])
    cos_i = jnp.abs(wi[..., 2])

    # diffuse lobe (lambert / oren-nayar, ref reflection.cpp OrenNayar::f)
    sigma_rad = jnp.deg2rad(jnp.maximum(p.sigma, 0.0))
    s2 = sigma_rad * sigma_rad
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    B = 0.45 * s2 / (s2 + 0.09)
    sin_o = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_o * cos_o))
    sin_i = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_i * cos_i))
    # max(0, cos(phi_i - phi_o))
    denom_i = jnp.maximum(sin_i, 1e-9)
    denom_o = jnp.maximum(sin_o, 1e-9)
    cos_dphi = (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / (
        denom_i * denom_o)
    max_cos = jnp.where((sin_i > 1e-4) & (sin_o > 1e-4),
                        jnp.maximum(cos_dphi, 0.0), 0.0)
    sin_alpha = jnp.maximum(sin_i, sin_o)
    tan_beta = jnp.minimum(sin_i, sin_o) / jnp.maximum(
        jnp.minimum(cos_i, cos_o), 1e-4)
    on = A + B * max_cos * sin_alpha * tan_beta
    f_diff = p.kd * (INV_PI * jnp.where(p.sigma > 0, on, 1.0))[..., None]
    pdf_diff = smp.cosine_hemisphere_pdf(cos_i)

    # glossy microfacet lobe
    wh = wo + wi
    wh_len = vm.length(wh)
    wh = jnp.where((wh_len > 1e-9)[..., None], wh / jnp.maximum(wh_len, 1e-9)[..., None], 0.0)
    d = tr_d(wh, p.alpha)
    g = tr_g(wo, wi, p.alpha)
    is_metal = p.kind == MAT_METAL
    is_substrate = p.kind == MAT_SUBSTRATE
    fr_d = fr_dielectric(vm.dot(wi, wh), jnp.ones_like(p.eta), p.eta)[..., None]
    # pbrt-v3's plastic builds its microfacet Fresnel with the indices
    # REVERSED — FresnelDielectric(1.5f, 1.f), ref: materials/plastic.cpp:59
    # — so rays "enter" from the denser side: total internal reflection
    # beyond ~42 deg and a far brighter glossy lobe than the (1 -> eta)
    # form every other material uses.  Round-5 oracle parity traced a
    # -12% killeroo statue deficit and a -25% atrium rug/floor deficit to
    # exactly this (BENCH_NOTES round 5); parity means reproducing it.
    fr_pl = fr_dielectric(vm.dot(wi, wh), p.eta,
                          jnp.ones_like(p.eta))[..., None]
    fr_d = jnp.where((p.kind == MAT_PLASTIC)[..., None], fr_pl, fr_d)
    fr_c = fr_conductor(vm.dot(wi, wh), p.metal_eta, p.metal_k)
    fr = jnp.where(is_metal[..., None], fr_c, fr_d)
    spec_coef = jnp.where(is_metal[..., None], jnp.ones_like(p.ks), p.ks)
    denom = 4.0 * jnp.maximum(cos_i * cos_o, 1e-7)
    f_gloss = spec_coef * (d * g / denom)[..., None] * fr
    # substrate FresnelBlend (ref: reflection.cpp FresnelBlend::f)
    fb_diff = (28.0 / (23.0 * jnp.pi)) * p.kd * (1.0 - p.ks) * (
        (1.0 - jnp.power(1.0 - 0.5 * cos_i, 5.0))
        * (1.0 - jnp.power(1.0 - 0.5 * cos_o, 5.0))
    )[..., None]
    fb_spec = (d / (4.0 * jnp.maximum(jnp.abs(vm.dot(wi, wh)), 1e-7)
                    * jnp.maximum(jnp.maximum(cos_i, cos_o), 1e-7)))[..., None] \
        * schlick_fresnel(p.ks, vm.dot(wi, wh))
    f_diff = jnp.where(is_substrate[..., None], fb_diff, f_diff)
    f_gloss = jnp.where(is_substrate[..., None], fb_spec, f_gloss)

    # ---- disney principled lobes (ref: materials/disney.cpp:
    # DisneyDiffuse::f, DisneyRetro::f, DisneySheen::f, DisneyFresnel,
    # DisneyClearcoat::f) ----
    is_dis = p.kind == MAT_DISNEY
    metallic = p.aux[..., 0]
    spec_tint = p.aux[..., 1]
    sheen_amt = p.aux[..., 2]
    sheen_tint = p.aux[..., 3]
    clearcoat = p.aux[..., 4]
    cc_gloss = p.aux[..., 5]
    spec_trans = p.aux[..., 6]
    cos_d = jnp.abs(vm.dot(wi, wh))        # half-vector cosine theta_d
    FL = _schlick_weight(cos_i)
    FV = _schlick_weight(cos_o)
    rough_dis = jnp.sqrt(jnp.maximum(p.alpha, 1e-6))  # alpha = rough^2
    base_diff = p.kd * (INV_PI * (1.0 - 0.5 * FL)
                        * (1.0 - 0.5 * FV))[..., None]
    RR = 2.0 * rough_dis * cos_d * cos_d
    retro = p.kd * (INV_PI * RR * (FL + FV + FL * FV * (RR - 1.0)))[..., None]
    ctint = p.kd / jnp.maximum(_lum(p.kd), 1e-4)[..., None]
    white = jnp.ones_like(p.kd)
    csheen = vm.lerp(sheen_tint[..., None], white, ctint)
    f_sheen = (sheen_amt * _schlick_weight(cos_d))[..., None] * csheen
    # diffuse+retro scale by (1-metallic)(1-specTrans); sheen by
    # (1-metallic) (ref: disney.cpp diffuseWeight / sheenWeight)
    dif_w = ((1.0 - metallic) * (1.0 - spec_trans))[..., None]
    f_diff_dis = dif_w * (base_diff + retro) \
        + (1.0 - metallic)[..., None] * f_sheen
    r0 = ((p.eta - 1.0) / jnp.maximum(p.eta + 1.0, 1e-6)) ** 2
    cspec0 = vm.lerp(metallic[..., None],
                     r0[..., None] * vm.lerp(spec_tint[..., None], white,
                                             ctint), p.kd)
    F_dis = cspec0 + _schlick_weight(cos_d)[..., None] * (1.0 - cspec0)
    f_spec_dis = (d * g / denom)[..., None] * F_dis
    a_cc = vm.lerp(cc_gloss, 0.1, 0.001)
    d_cc = gtr1_d(wh, a_cc)
    g_cc = _smith_g_ggx(cos_i, 0.25) * _smith_g_ggx(cos_o, 0.25)
    f_cc_s = 0.04 + 0.96 * _schlick_weight(cos_d)
    f_cc = (0.25 * clearcoat * d_cc * g_cc * f_cc_s)[..., None] * white
    f_diff = jnp.where(is_dis[..., None], f_diff_dis, f_diff)
    f_gloss = jnp.where(is_dis[..., None], f_spec_dis + f_cc, f_gloss)
    pdf_gloss = tr_pdf(wo, wh, p.alpha) / (
        4.0 * jnp.maximum(jnp.abs(vm.dot(wo, wh)), 1e-7))
    pdf_gloss = jnp.where(wh_len > 1e-9, pdf_gloss, 0.0)

    valid_d = refl & (w[..., 0] > 0.0)
    valid_g = refl & (w[..., 1] > 0.0) & (d > 0.0)
    f = (jnp.where(valid_d[..., None], f_diff, 0.0)
         + jnp.where(valid_g[..., None], f_gloss, 0.0))
    pdf = (jnp.where(valid_d, w[..., 0] * pdf_diff, 0.0)
           + jnp.where(valid_g, w[..., 1] * pdf_gloss, 0.0))

    # ---- exact FourierBSDF (ref: reflection.cpp FourierBSDF::f) ----
    # f comes from the measured table; the pdf is the proxy-lobe mix
    # (exact-f/proxy-pdf is unbiased as long as the proxy pdf covers
    # f's support): for transmissive tables (kt proxy > 0, set from the
    # table's eta at parse time) the diffuse proxy becomes a TWO-SIDED
    # cosine so transmitted directions are samplable (ADVICE r2).
    if p.fourier is not None:
        from . import fourierbsdf as fourierlib

        is_fourier = p.kind == MAT_FOURIER
        f_four = fourierlib.evaluate_device(p.fourier, p.fourier_id, wo, wi)
        f = jnp.where(is_fourier[..., None], f_four, f)
        kt_l = _lum(p.kt)
        pt = kt_l / jnp.maximum(_lum(p.kd) + kt_l, 1e-9)
        cos_pdf = jnp.abs(wi[..., 2]) * smp.INV_PI
        pdf_diff_2s = jnp.where(refl, (1.0 - pt), pt) * cos_pdf
        pdf_four = (w[..., 0] * pdf_diff_2s
                    + jnp.where(refl & (d > 0.0),
                                w[..., 1] * pdf_gloss, 0.0))
        pdf = jnp.where(is_fourier, pdf_four, pdf)

    # ---- hair fiber lobe (full-sphere, ref: materials/hair.cpp) ----
    if enable_hair:
        is_hair = p.kind == MAT_HAIR
        h_fib = p.h if p.h is not None else jnp.zeros_like(p.eta)
        f_hair = hairlib.evaluate(wo, wi, h_fib, p.kd,
                                  p.aux[..., 0], p.aux[..., 1],
                                  p.aux[..., 2], p.eta)
        pdf_hair = hairlib.pdf(wo, wi, h_fib, p.kd,
                               p.aux[..., 0], p.aux[..., 1],
                               p.aux[..., 2], p.eta)
        f = jnp.where(is_hair[..., None], f_hair, f)
        pdf = jnp.where(is_hair, pdf_hair, pdf)
    # renormalize pdf over non-delta lobes only (delta lobes are never
    # evaluated here): the sampler picks them, so the pdf of arriving at a
    # non-delta lobe is conditional — but for MIS weights the reference
    # uses the unconditional Pdf over all components; weights w already sum
    # to <=1 including delta lobes, matching BSDF::Pdf semantics
    # (reflection.cpp:776: mean over all matching components).
    return f, pdf


class BsdfSample(NamedTuple):
    wi: jnp.ndarray          # (N,3) local
    f: jnp.ndarray           # (N,3)
    pdf: jnp.ndarray         # (N,)
    is_specular: jnp.ndarray  # (N,) bool (delta lobe sampled)
    is_transmission: jnp.ndarray  # (N,) bool
    valid: jnp.ndarray       # (N,) bool


def sample(p: BsdfParams, wo, u_lobe, u2, enable_hair: bool = True) -> BsdfSample:
    """BSDF::Sample_f for the wavefront (ref: reflection.cpp:719).

    u_lobe: (N,) lobe-choice uniform; u2: (N,2) direction sample.
    """
    w = _lobe_weights(p)
    cdf = jnp.cumsum(w, axis=-1)
    lobe = jnp.sum((u_lobe[..., None] > cdf).astype(jnp.int32), axis=-1)
    lobe = jnp.clip(lobe, 0, 3)

    cos_o = jnp.abs(wo[..., 2])
    sign_o = jnp.where(wo[..., 2] >= 0.0, 1.0, -1.0)

    # --- candidate: diffuse (cosine hemisphere on wo's side; fourier
    # tables with transmission flip to the far side with probability
    # pt = kt/(kd+kt), mirroring the two-sided proxy pdf in evaluate) ---
    wi_d = smp.cosine_sample_hemisphere(u2)
    is_four_s = p.kind == MAT_FOURIER
    kt_l_s = _lum(p.kt)
    pt_s = jnp.where(is_four_s,
                     kt_l_s / jnp.maximum(_lum(p.kd) + kt_l_s, 1e-9), 0.0)
    u_c0 = jnp.clip(u_lobe / jnp.maximum(w[..., 0], 1e-9), 0.0, 1.0)
    flip_t = is_four_s & (u_c0 < pt_s)
    d_sign = jnp.where(flip_t, -sign_o, sign_o)
    wi_d = wi_d * jnp.stack([jnp.ones_like(sign_o), jnp.ones_like(sign_o),
                             d_sign], axis=-1)

    # --- candidate: glossy (sample wh, reflect) ---
    wh = tr_sample_wh(wo, u2, p.alpha)
    wi_g = vm.reflect(wo, wh)

    # --- candidate: specular reflection ---
    wi_r = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)

    # --- candidate: specular transmission (ref: FresnelSpecular) ---
    entering = wo[..., 2] > 0.0
    eta_rel = jnp.where(entering, 1.0 / p.eta, p.eta)
    n_face = jnp.stack([jnp.zeros_like(sign_o), jnp.zeros_like(sign_o),
                        sign_o], axis=-1)
    wi_t, t_ok = vm.refract(wo, n_face, eta_rel)

    is_glass = p.kind == MAT_GLASS
    is_dis_t = (p.kind == MAT_DISNEY) & (lobe == 3)
    # glass (and disney specTrans once its lobe is picked): choose reflect
    # vs transmit by true Fresnel (matching FresnelSpecular); for disney
    # the lobe-choice uniform is rescaled to its conditional range
    fr_g = fr_dielectric(wo[..., 2], jnp.ones_like(p.eta), p.eta)
    cdf2 = jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf], axis=-1)
    w_lobe3 = jnp.maximum(w[..., 3], 1e-9)
    u_cond = jnp.clip((u_lobe - cdf2[..., 3]) / w_lobe3, 0.0, 1.0)
    u_fres = jnp.where(is_glass, u_lobe, u_cond)
    glass_like = is_glass | is_dis_t
    glass_pick_refl = u_fres < fr_g
    lobe = jnp.where(glass_like, jnp.where(glass_pick_refl, 2, 3), lobe)

    wi = jnp.where(
        (lobe == 0)[..., None], wi_d,
        jnp.where((lobe == 1)[..., None], wi_g,
                  jnp.where((lobe == 2)[..., None], wi_r, wi_t)))

    is_delta = lobe >= 2
    # f & pdf for smooth lobes via evaluate() (hair handled separately
    # below with its own importance sampler, so skip its lobe here)
    f_sm, pdf_sm = evaluate(p, wo, wi, enable_hair=False)

    cos_i = jnp.abs(wi[..., 2])
    # delta reflect
    fr_mirror = jnp.ones_like(p.kr)
    fr_sr = jnp.where(is_glass[..., None],
                      fr_g[..., None],
                      jnp.where(((p.kind == MAT_UBER)
                                 | (p.kind == MAT_SUBSURFACE))[..., None],
                                fr_dielectric(wo[..., 2],
                                              jnp.ones_like(p.eta),
                                              p.eta)[..., None],
                                fr_mirror))
    f_r = p.kr * fr_sr / jnp.maximum(cos_i, 1e-7)[..., None]
    pdf_r = jnp.where(is_glass, fr_g, w[..., 2])
    # delta transmit: ft = kt (1-F) / |cos| * (1/eta_rel)^2 (radiance
    # transport scaling, ref reflection.cpp SpecularTransmission::Sample_f)
    scale_t = (1.0 / jnp.maximum(eta_rel, 1e-6)) ** 2
    f_t = p.kt * ((1.0 - fr_g) * scale_t / jnp.maximum(cos_i, 1e-7))[..., None]
    pdf_t = 1.0 - fr_g

    f = jnp.where(is_delta[..., None],
                  jnp.where((lobe == 2)[..., None], f_r, f_t), f_sm)
    pdf = jnp.where(is_delta,
                    jnp.where(lobe == 2, pdf_r, pdf_t), pdf_sm)

    valid = pdf > 0.0
    valid = valid & jnp.where(lobe == 3, t_ok, True)
    # diffuse/glossy lobes stay hemisphere-bound EXCEPT the fourier
    # two-sided diffuse proxy, whose far-side flips are intentional
    same_h = _same_hemisphere(wo, wi)
    hemi_ok = same_h | (is_four_s & (lobe == 0))
    valid = valid & jnp.where(lobe <= 1, hemi_ok, True)
    valid = valid & (cos_o > 0.0)
    is_trans = (lobe == 3) | (is_four_s & (lobe == 0) & ~same_h)

    # ---- hair fiber sampling (ref: hair.cpp HairBSDF::Sample_f) ----
    if enable_hair:
        is_hair = p.kind == MAT_HAIR
        # 4 uniforms from the 3 available: demux the phi sample's low bits
        # for the conditional theta dimension (ref uses DemuxFloat)
        u4 = jnp.stack([u_lobe, u2[..., 0], u2[..., 1],
                        (u2[..., 0] * 4096.0) % 1.0], axis=-1)
        h_fib = p.h if p.h is not None else jnp.zeros_like(p.eta)
        wi_h, f_h, pdf_h = hairlib.sample(
            wo, u4, h_fib, p.kd, p.aux[..., 0], p.aux[..., 1],
            p.aux[..., 2], p.eta)
        wi = jnp.where(is_hair[..., None], wi_h, wi)
        f = jnp.where(is_hair[..., None], f_h, f)
        pdf = jnp.where(is_hair, pdf_h, pdf)
        is_delta = is_delta & ~is_hair
        # hair scatters over the full sphere; flag hemisphere crossings as
        # transmission so ray origins are offset to the correct side
        is_trans = jnp.where(is_hair, ~_same_hemisphere(wo, wi), is_trans)
        valid = jnp.where(is_hair, pdf > 0.0, valid)

    return BsdfSample(
        wi=wi, f=f, pdf=pdf,
        is_specular=is_delta,
        is_transmission=is_trans,
        valid=valid,
    )


def has_nonspecular(p: BsdfParams):
    """True when the material has any non-delta component (ref:
    bsdf->NumComponents(~SPECULAR) > 0 checks)."""
    w = _lobe_weights(p)
    return (w[..., 0] + w[..., 1]) > 0.0


def is_black(p: BsdfParams):
    w = _lobe_weights(p)
    tot = _lum(p.kd) + _lum(p.ks) + _lum(p.kr) + _lum(p.kt) + \
        jnp.where((p.kind == MAT_METAL) | (p.kind == MAT_HAIR), 1.0, 0.0)
    return (tot <= 0.0) | (p.kind == MAT_NONE)
