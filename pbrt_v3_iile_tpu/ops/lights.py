"""Wavefront light sampling, pdfs, and emitted-radiance evaluation.

Semantics follow the reference's light plugins (ref: src/lights/point.cpp,
spot.cpp, distant.cpp, diffuse.cpp, infinite.cpp) and shape sampling
(src/shapes/triangle.cpp:Sample, sphere.cpp:Sample cone sampling), with
two wavefront-driven deviations, both unbiased:
- a triangle-mesh area light is ONE light with an area-weighted CDF over
  its triangles (the reference makes one light per triangle);
- the constant-color infinite light is sampled uniformly over the sphere.
All masks, no dispatch.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import vecmath as vm
from . import sampling as smp
from ..scene.api import (
    LIGHT_POINT, LIGHT_DISTANT, LIGHT_INFINITE, LIGHT_AREA_TRI,
    LIGHT_AREA_SPHERE, LIGHT_SPOT, LIGHT_GONIO, LIGHT_PROJECTION,
)

HIGHEST = jax.lax.Precision.HIGHEST  # no TF32 in geometry transforms


class LightSample(NamedTuple):
    wi: jnp.ndarray        # (N,3) unit, towards light
    li: jnp.ndarray        # (N,3) incident radiance (pre-visibility)
    pdf: jnp.ndarray       # (N,) solid-angle pdf (w.r.t. chosen light)
    dist: jnp.ndarray      # (N,) distance to light point (shadow ray tmax)
    is_delta: jnp.ndarray  # (N,) delta light (no MIS vs bsdf)
    n_l: jnp.ndarray       # (N,3) normal at the sampled light point
                           # (= -wi for point-like/distant/infinite) — used
                           # by BDPT junction pdfs


def choose_light(scene, u):
    """Light selection by the scene's distribution (uniform or
    power-weighted; ref: integrator.cpp:85 UniformSampleOneLight +
    lightdistrib.cpp).  Returns (light_id, select_pdf)."""
    L = scene.light_cdf.shape[0]
    idx = jnp.clip(jnp.searchsorted(scene.light_cdf, u),
                   0, jnp.maximum(scene.n_lights - 1, 0)).astype(jnp.int32)
    pdf = jnp.take(scene.light_pdf, idx)
    return idx, pdf


def _spatial_voxel(scene, p):
    """World point -> flat voxel index of the spatial light grid
    (ref: lightdistrib.cpp SpatialLightDistribution::Lookup)."""
    res = scene.spatial_res
    ext = jnp.maximum(scene.world_max - scene.world_min, 1e-6)
    q = ((p - scene.world_min[None, :]) / ext[None, :]
         * res[None, :].astype(jnp.float32)).astype(jnp.int32)
    q = jnp.clip(q, 0, res[None, :] - 1)
    return (q[:, 2] * res[1] + q[:, 1]) * res[0] + q[:, 0]


def choose_light_spatial(scene, u, p):
    """Position-aware light selection from the per-voxel distribution
    (ref: lightdistrib.h:100 SpatialLightDistribution).  Falls back to
    the global table when the grid is 1 voxel (strategy != spatial).
    Returns (light_id, select_pdf)."""
    V = scene.spatial_cdf.shape[0]
    v = jnp.clip(_spatial_voxel(scene, p), 0, V - 1)
    cdf = jnp.take(scene.spatial_cdf, v, axis=0)          # (N, L)
    idx = jnp.sum((cdf < u[:, None]).astype(jnp.int32), axis=-1)
    idx = jnp.clip(idx, 0, jnp.maximum(scene.n_lights - 1, 0))
    pdf_rows = jnp.take(scene.spatial_pdf, v, axis=0)
    pdf = jnp.take_along_axis(pdf_rows, idx[:, None], axis=-1)[:, 0]
    return idx.astype(jnp.int32), pdf


def light_select_pdf_spatial(scene, p, lid):
    """Selection pdf of light lid when sampling from point p under the
    spatial distribution (the MIS counterpart of choose_light_spatial)."""
    V = scene.spatial_cdf.shape[0]
    v = jnp.clip(_spatial_voxel(scene, p), 0, V - 1)
    pdf_rows = jnp.take(scene.spatial_pdf, v, axis=0)
    return jnp.take_along_axis(
        pdf_rows, jnp.maximum(lid, 0)[:, None], axis=-1)[:, 0]


def infinite_select_pdf_spatial(scene, p):
    """Sum of selection pdfs of all infinite lights at p (env-escape
    MIS weight under the spatial distribution)."""
    V = scene.spatial_cdf.shape[0]
    v = jnp.clip(_spatial_voxel(scene, p), 0, V - 1)
    pdf_rows = jnp.take(scene.spatial_pdf, v, axis=0)     # (N, Lp >= L)
    Ls = scene.light_kind.shape[0]
    live = jnp.arange(Ls) < scene.n_lights
    m = (scene.light_kind == 2) & live
    return jnp.sum(jnp.where(m[None, :], pdf_rows[:, :Ls], 0.0), axis=-1)


def _sample_light_triangle(scene, light_id, u):
    """Area-weighted triangle pick within a light's range via masked
    search over the flat per-light CDF (K is small)."""
    K = scene.ltri_cdf.shape[0]
    off = jnp.take(scene.light_tri_off, light_id)     # (N,)
    cnt = jnp.take(scene.light_tri_cnt, light_id)
    j = jnp.arange(K)[None, :]                        # (1,K)
    in_range = (j >= off[:, None]) & (j < (off + cnt)[:, None])
    ge = in_range & (scene.ltri_cdf[None, :] >= u[:, None])
    # first triangle whose cdf >= u (cdf is per-light normalized)
    big = jnp.where(ge, j, K)
    tri = jnp.min(big, axis=-1)
    tri = jnp.where(tri >= K, jnp.maximum(off + cnt - 1, 0), tri)
    return jnp.clip(tri, 0, K - 1)


def sample_li(scene, light_id, p_ref, u3) -> LightSample:
    """Light::Sample_Li for the wavefront. u3: (N,3) uniforms
    (tri pick + 2D point sample)."""
    N = p_ref.shape[0]
    g = lambda a: jnp.take(a, light_id, axis=0)
    kind = g(scene.light_kind)
    L = g(scene.light_L)
    pos = g(scene.light_pos)
    ldir = g(scene.light_dir)
    two_sided = g(scene.light_two_sided) > 0.5

    u2 = u3[:, 1:3]

    # ---- point / spot ----
    to_l = pos - p_ref
    d2 = jnp.maximum(vm.length_sq(to_l), 1e-12)
    dist_p = jnp.sqrt(d2)
    wi_p = to_l / dist_p[:, None]
    li_point = L / d2[:, None]
    # spot falloff (ref: spot.cpp Falloff)
    cos_t = vm.dot(-wi_p, ldir)
    ct, cf = g(scene.light_cos_total), g(scene.light_cos_falloff)
    delta_f = jnp.clip((cos_t - ct) / jnp.maximum(cf - ct, 1e-9), 0.0, 1.0)
    falloff = jnp.where(cos_t >= cf, 1.0,
                        jnp.where(cos_t <= ct, 0.0, (delta_f ** 2) ** 2))
    li_spot = li_point * falloff[:, None]

    # ---- goniometric / projection (point lights modulated by a map) ----
    li_gonio = li_point * _gonio_scale(scene, light_id, -wi_p)
    li_proj = li_point * _projection_scale(scene, light_id, -wi_p)

    # ---- distant ----
    wi_d = ldir
    dist_d = jnp.full(N, 2.0) * scene.world_radius

    # ---- infinite ----
    # constant color: uniform sphere; env map: 2D-distribution importance
    # sampling (ref: infinite.cpp Sample_Li via Distribution2D)
    wi_u = smp.uniform_sample_sphere(u2)
    pdf_u = jnp.full(N, smp.INV_4PI)
    wi_e, pdf_e, li_e = _sample_env_map(scene, u2)
    use_env = (scene.has_env_map > 0) & (light_id == scene.env_light_id)
    wi_i = jnp.where(use_env[:, None], wi_e, wi_u)
    pdf_i = jnp.where(use_env, pdf_e, pdf_u)
    dist_i = jnp.full(N, 2.0) * scene.world_radius

    # ---- area triangle ----
    tri = _sample_light_triangle(scene, light_id, u3[:, 0])
    b = smp.uniform_sample_triangle(u2)
    p0 = jnp.take(scene.ltri_p0, tri, axis=0)
    e1 = jnp.take(scene.ltri_e1, tri, axis=0)
    e2 = jnp.take(scene.ltri_e2, tri, axis=0)
    n_l = jnp.take(scene.ltri_ng, tri, axis=0)
    p_l = p0 + b[:, 0:1] * e1 + b[:, 1:2] * e2
    to_t = p_l - p_ref
    d2_t = jnp.maximum(vm.length_sq(to_t), 1e-12)
    dist_t = jnp.sqrt(d2_t)
    wi_t = to_t / dist_t[:, None]
    area = jnp.maximum(g(scene.light_area), 1e-12)
    cos_l = vm.dot(n_l, -wi_t)
    emit_t = two_sided | (cos_l > 0.0)
    pdf_t = d2_t / jnp.maximum(jnp.abs(cos_l) * area, 1e-12)
    li_t = jnp.where(emit_t[:, None], L, 0.0)
    pdf_t = jnp.where(jnp.abs(cos_l) > 1e-7, pdf_t, 0.0)

    # ---- area sphere (cone sampling, ref sphere.cpp:Sample(ref,u)) ----
    sph = jnp.clip(g(scene.light_sphere), 0, scene.sph_center.shape[0] - 1)
    c = jnp.take(scene.sph_center, sph, axis=0)
    r = jnp.take(scene.sph_radius, sph)
    to_c = c - p_ref
    dc2 = jnp.maximum(vm.length_sq(to_c), 1e-12)
    dc = jnp.sqrt(dc2)
    outside = dc2 > r * r
    sin2_max = jnp.clip(r * r / dc2, 0.0, 1.0)
    cos_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_max))
    wz = to_c / dc[:, None]
    tx, ty = vm.coordinate_system(wz)
    w_cone = smp.uniform_sample_cone(u2, cos_max)
    wi_s = vm.to_world(w_cone, tx, ty, wz)
    # distance to sphere surface along wi_s
    cos_alpha = w_cone[..., 2]
    ds = dc * cos_alpha - jnp.sqrt(jnp.maximum(
        r * r - dc2 * (1.0 - cos_alpha ** 2), 0.0))
    pdf_s = smp.uniform_cone_pdf(cos_max)
    # inside the sphere: uniform area sampling fallback
    n_in = smp.uniform_sample_sphere(u2)
    p_in = c + r[:, None] * n_in
    to_in = p_in - p_ref
    d2_in = jnp.maximum(vm.length_sq(to_in), 1e-12)
    dist_in = jnp.sqrt(d2_in)
    wi_in = to_in / dist_in[:, None]
    cos_in = vm.dot(n_in, -wi_in)
    pdf_in = d2_in / jnp.maximum(
        jnp.abs(cos_in) * 4.0 * jnp.pi * r * r, 1e-12)
    wi_s = jnp.where(outside[:, None], wi_s, wi_in)
    pdf_s = jnp.where(outside, pdf_s, pdf_in)
    ds = jnp.where(outside, ds, dist_in)
    li_s = L  # sphere emits outward everywhere

    is_pt = kind == LIGHT_POINT
    is_spot = kind == LIGHT_SPOT
    is_dist = kind == LIGHT_DISTANT
    is_inf = kind == LIGHT_INFINITE
    is_tri = kind == LIGHT_AREA_TRI
    is_sph = kind == LIGHT_AREA_SPHERE
    is_gon = kind == LIGHT_GONIO
    is_prj = kind == LIGHT_PROJECTION

    def sel(*pairs, default):
        out = default
        for m, v in pairs:
            if v.ndim > m.ndim:
                m = m[..., None]
            out = jnp.where(m, v, out)
        return out

    li_inf = jnp.where(use_env[:, None], li_e, L)
    is_ptlike = is_pt | is_spot | is_gon | is_prj
    wi = sel((is_ptlike, wi_p), (is_dist, wi_d), (is_inf, wi_i),
             (is_tri, wi_t), (is_sph, wi_s), default=wi_i)
    li = sel((is_pt, li_point), (is_spot, li_spot), (is_gon, li_gonio),
             (is_prj, li_proj), (is_dist, L),
             (is_inf, li_inf), (is_tri, li_t), (is_sph, li_s), default=L)
    pdf = sel((is_ptlike | is_dist, jnp.ones(N)), (is_inf, pdf_i),
              (is_tri, pdf_t), (is_sph, pdf_s), default=jnp.ones(N))
    dist = sel((is_ptlike, dist_p), (is_dist | is_inf, dist_i),
               (is_tri, dist_t), (is_sph, ds), default=dist_i)
    is_delta = is_ptlike | is_dist
    # normal at the sampled light point (for BDPT junction pdfs)
    n_sph_pt = vm.normalize(p_ref + ds[:, None] * wi_s - c)
    n_light = sel((is_tri, n_l), (is_sph, n_sph_pt), default=-wi)
    return LightSample(wi=wi, li=li, pdf=pdf, dist=dist, is_delta=is_delta,
                       n_l=n_light)


def pdf_li(scene, light_id, p_ref, wi, hit_t, hit_cos):
    """Light::Pdf_Li for a bsdf-sampled direction that HIT the light
    (area lights) or escaped (infinite).  hit_t: distance to the emissive
    hit; hit_cos: |cos| at the light surface."""
    g = lambda a: jnp.take(a, light_id, axis=0)
    kind = g(scene.light_kind)
    area = jnp.maximum(g(scene.light_area), 1e-12)
    pdf_tri = (hit_t * hit_t) / jnp.maximum(hit_cos * area, 1e-12)

    sph = jnp.clip(g(scene.light_sphere), 0, scene.sph_center.shape[0] - 1)
    c = jnp.take(scene.sph_center, sph, axis=0)
    r = jnp.take(scene.sph_radius, sph)
    dc2 = jnp.maximum(vm.length_sq(c - p_ref), 1e-12)
    outside = dc2 > r * r
    sin2_max = jnp.clip(r * r / dc2, 0.0, 1.0)
    cos_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_max))
    pdf_sph_out = smp.uniform_cone_pdf(cos_max)
    pdf_sph_in = (hit_t * hit_t) / jnp.maximum(
        hit_cos * 4.0 * jnp.pi * r * r, 1e-12)
    pdf_sph = jnp.where(outside, pdf_sph_out, pdf_sph_in)

    pdf_inf = jnp.where(
        (scene.has_env_map > 0) & (light_id == scene.env_light_id),
        _env_dir_pdf(scene, wi), smp.INV_4PI)
    pdf = jnp.where(kind == LIGHT_AREA_TRI, pdf_tri,
                    jnp.where(kind == LIGHT_AREA_SPHERE, pdf_sph,
                              jnp.where(kind == LIGHT_INFINITE,
                                        pdf_inf, 0.0)))
    return pdf


def area_light_le(scene, light_id, n_l, w_out):
    """Emitted radiance of an area light towards w_out (ref:
    diffuse.cpp DiffuseAreaLight::L)."""
    g = lambda a: jnp.take(a, light_id, axis=0)
    L = g(scene.light_L)
    two_sided = g(scene.light_two_sided) > 0.5
    lit = two_sided | (vm.dot(n_l, w_out) > 0.0)
    valid_area = (g(scene.light_kind) == LIGHT_AREA_TRI) | \
        (g(scene.light_kind) == LIGHT_AREA_SPHERE)
    return jnp.where((lit & valid_area & (light_id >= 0))[:, None], L, 0.0)


def _env_uv(scene, d):
    """Direction -> lat-long (u, v) in the light frame (ref: infinite.cpp
    Le: SphericalPhi/Theta of WorldToLight(d), z-up)."""
    dl = jnp.dot(d, scene.env_world_to.T, precision=HIGHEST)
    theta = vm.spherical_theta(dl)
    phi = vm.spherical_phi(dl)
    return phi * smp.INV_2PI, theta * (1.0 / jnp.pi), theta


def _env_lookup(scene, d):
    """Bilinear radiance lookup of the env map for directions d."""
    EH, EW = scene.env_img.shape[:2]
    u, v, _ = _env_uv(scene, d)
    fx = u * EW - 0.5
    fy = v * EH - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    x0m = jnp.mod(x0, EW)
    x1m = jnp.mod(x0 + 1, EW)
    y0c = jnp.clip(y0, 0, EH - 1)
    y1c = jnp.clip(y0 + 1, 0, EH - 1)
    flat = scene.env_img.reshape(-1, 3)
    at = lambda xm, ym: jnp.take(flat, ym * EW + xm, axis=0)
    return ((1 - ax) * (1 - ay) * at(x0m, y0c) + ax * (1 - ay) * at(x1m, y0c)
            + (1 - ax) * ay * at(x0m, y1c) + ax * ay * at(x1m, y1c))


def _env_dir_pdf(scene, d):
    """Solid-angle pdf of env-map sampling for direction d."""
    EH, EW = scene.env_pdf.shape
    u, v, _ = _env_uv(scene, d)
    x = jnp.clip((u * EW).astype(jnp.int32), 0, EW - 1)
    y = jnp.clip((v * EH).astype(jnp.int32), 0, EH - 1)
    return jnp.take(scene.env_pdf.reshape(-1), y * EW + x)


def _sample_env_map(scene, u2):
    """Importance-sample the env map 2D distribution; returns
    (wi (N,3), pdf (N,), Li (N,3))."""
    import jax

    EH, EW = scene.env_pdf.shape
    row = jnp.clip(jnp.searchsorted(scene.env_marg_cdf, u2[..., 0]),
                   0, EH - 1)
    cond_rows = jnp.take(scene.env_cond_cdf, row, axis=0)  # (N, EW)
    col = jnp.clip(jax.vmap(jnp.searchsorted)(cond_rows, u2[..., 1]),
                   0, EW - 1)
    v = (row.astype(jnp.float32) + 0.5) / EH
    u = (col.astype(jnp.float32) + 0.5) / EW
    theta = v * jnp.pi
    phi = u * 2.0 * jnp.pi
    st = jnp.sin(theta)
    d_light = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi),
                         jnp.cos(theta)], axis=-1)
    wi = jnp.dot(d_light, scene.env_to_world.T, precision=HIGHEST)
    pdf = jnp.take(scene.env_pdf.reshape(-1), row * EW + col)
    li = jnp.take(scene.env_img.reshape(-1, 3), row * EW + col, axis=0)
    return wi, pdf, li


def environment_le(scene, d):
    """Radiance from infinite lights for escaped rays (ref:
    infinite.cpp InfiniteAreaLight::Le). Sums all infinite lights;
    the env-mapped light contributes its texture lookup."""
    L = scene.light_kind.shape[0]
    is_inf = scene.light_kind == LIGHT_INFINITE
    live = jnp.arange(L) < scene.n_lights
    has_map = jnp.arange(L) == scene.env_light_id
    total_const = jnp.sum(
        jnp.where((is_inf & live & ~has_map)[:, None], scene.light_L, 0.0),
        axis=0)
    out = jnp.broadcast_to(total_const, d.shape)
    env = _env_lookup(scene, d)
    return jnp.where(scene.has_env_map > 0, out + env, out)


def _light_map_lookup(scene, img_id, u, v):
    """Bilinear lookup into the stacked light map array for rays whose
    light has a map; rays with img_id<0 get 1.0."""
    G, MH, MW = scene.light_img.shape[:3]
    gi = jnp.clip(img_id, 0, G - 1)
    fx = u * MW - 0.5
    fy = v * MH - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    x0c = jnp.clip(x0, 0, MW - 1)
    x1c = jnp.clip(x0 + 1, 0, MW - 1)
    y0c = jnp.clip(y0, 0, MH - 1)
    y1c = jnp.clip(y0 + 1, 0, MH - 1)
    flat = scene.light_img.reshape(-1, 3)
    at = lambda x, y: jnp.take(flat, (gi * MH + y) * MW + x, axis=0)
    val = ((1 - ax) * (1 - ay) * at(x0c, y0c) + ax * (1 - ay) * at(x1c, y0c)
           + (1 - ax) * ay * at(x0c, y1c) + ax * ay * at(x1c, y1c))
    return jnp.where((img_id >= 0)[..., None], val, 1.0)


def _gonio_scale(scene, light_id, w):
    """Goniophotometric angular scale for world direction w from the
    light (ref: goniometric.h Scale: world->light, swap y/z, lat-long
    lookup)."""
    g = lambda a: jnp.take(a, light_id, axis=0)
    w2l = g(scene.light_w2l)                         # (N,3,3)
    wl = jnp.einsum("nij,nj->ni", w2l, w, precision=HIGHEST)
    wl = wl / jnp.maximum(vm.length(wl), 1e-12)[..., None]
    # swap y/z (the reference's photometric maps are y-up)
    wl = jnp.stack([wl[..., 0], wl[..., 2], wl[..., 1]], axis=-1)
    theta = vm.spherical_theta(wl)
    phi = vm.spherical_phi(wl)
    return _light_map_lookup(scene, g(scene.light_img_id),
                             phi * smp.INV_2PI, theta / jnp.pi)


def _projection_scale(scene, light_id, w):
    """Projection-light screen lookup for world direction w (ref:
    projection.cpp Projection: perspective-project into the fov window,
    zero outside)."""
    g = lambda a: jnp.take(a, light_id, axis=0)
    w2l = g(scene.light_w2l)
    wl = jnp.einsum("nij,nj->ni", w2l, w, precision=HIGHEST)
    z = wl[..., 2]
    ax = g(scene.light_proj_ax)
    ay = g(scene.light_proj_ay)
    zs = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
    u = (wl[..., 0] / (zs * ax) + 1.0) * 0.5
    v = (wl[..., 1] / (zs * ay) + 1.0) * 0.5
    inside = (z > 1e-3) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    val = _light_map_lookup(scene, g(scene.light_img_id), u, 1.0 - v)
    return jnp.where(inside[..., None], val, 0.0)


class LightEmission(NamedTuple):
    o: jnp.ndarray      # (N,3) photon origin
    d: jnp.ndarray      # (N,3) photon direction (into the scene)
    beta: jnp.ndarray   # (N,3) Le*|cos|/(pdf_pos*pdf_dir) — photon power
                        # before light-selection pdf division
    valid: jnp.ndarray  # (N,)
    # separated quantities for BDPT MIS (ref: bdpt.cpp Vertex pdfs):
    le: jnp.ndarray       # (N,3) emitted radiance / intensity
    n_l: jnp.ndarray      # (N,3) emission normal (= d for point-like)
    pdf_pos: jnp.ndarray  # (N,) area-measure position pdf (1 for delta)
    pdf_dir: jnp.ndarray  # (N,) solid-angle direction pdf (1 for delta)
    delta_pos: jnp.ndarray  # (N,) position is a delta (point/spot/...)
    delta_dir: jnp.ndarray  # (N,) direction is a delta (distant)


def sample_le(scene, light_id, u6) -> LightEmission:
    """Light::Sample_Le for photon emission (ref: point.cpp:58,
    spot.cpp:Sample_Le, distant.cpp:Sample_Le disk emission,
    diffuse.cpp:Sample_Le cosine hemisphere, infinite.cpp:Sample_Le).

    u6: (N,6) uniforms [tri/env pick, side, pos_u0, pos_u1, dir_u0,
    dir_u1].  The returned beta folds Le, emission cosine, and both
    pdfs; divide by the light-selection pdf at the call site."""
    N = u6.shape[0]
    g = lambda a: jnp.take(a, light_id, axis=0)
    kind = g(scene.light_kind)
    L = g(scene.light_L)
    pos = g(scene.light_pos)
    ldir = g(scene.light_dir)      # for distant: wi TOWARDS the light
    two_sided = g(scene.light_two_sided) > 0.5
    u_pos = u6[:, 2:4]
    u_dir = u6[:, 4:6]
    wr = scene.world_radius
    wc = 0.5 * (scene.world_min + scene.world_max)

    # ---- point-like: uniform sphere direction ----
    d_sph = smp.uniform_sample_sphere(u_dir)
    beta_pt = L * (4.0 * jnp.pi)
    # spot: uniform cone of cosTotalWidth (ref: spot.cpp Sample_Le)
    ct, cf = g(scene.light_cos_total), g(scene.light_cos_falloff)
    tx_s, ty_s = vm.coordinate_system(ldir)
    w_cone = smp.uniform_sample_cone(u_dir, ct)
    d_spot = vm.to_world(w_cone, tx_s, ty_s, ldir)
    cos_sp = vm.dot(d_spot, ldir)
    delta_f = jnp.clip((cos_sp - ct) / jnp.maximum(cf - ct, 1e-9), 0.0, 1.0)
    falloff = jnp.where(cos_sp >= cf, 1.0,
                        jnp.where(cos_sp <= ct, 0.0, (delta_f ** 2) ** 2))
    beta_spot = L * (falloff / jnp.maximum(
        smp.uniform_cone_pdf(ct), 1e-12))[:, None]
    beta_gonio = beta_pt * _gonio_scale(scene, light_id, d_sph)
    beta_proj = beta_pt * _projection_scale(scene, light_id, d_sph)

    # ---- distant: disk of world radius perpendicular to the direction
    # (ref: distant.cpp Sample_Le) ----
    v1, v2 = vm.coordinate_system(ldir)
    cd = smp.concentric_sample_disk(u_pos)
    o_dist = wc + wr * (cd[:, 0:1] * v1 + cd[:, 1:2] * v2) + wr * ldir
    d_dist = -ldir
    beta_dist = L * (jnp.pi * wr * wr)

    # ---- area triangle: area-uniform point + cosine direction ----
    tri = _sample_light_triangle(scene, light_id, u6[:, 0])
    b = smp.uniform_sample_triangle(u_pos)
    p0 = jnp.take(scene.ltri_p0, tri, axis=0)
    e1 = jnp.take(scene.ltri_e1, tri, axis=0)
    e2 = jnp.take(scene.ltri_e2, tri, axis=0)
    n_t = jnp.take(scene.ltri_ng, tri, axis=0)
    p_t = p0 + b[:, 0:1] * e1 + b[:, 1:2] * e2
    flip = two_sided & (u6[:, 1] < 0.5)
    n_emit = jnp.where(flip[:, None], -n_t, n_t)
    w_loc = smp.cosine_sample_hemisphere(u_dir)
    tx_t, ty_t = vm.coordinate_system(n_emit)
    d_tri = vm.to_world(w_loc, tx_t, ty_t, n_emit)
    area = jnp.maximum(g(scene.light_area), 1e-12)
    # beta = L*cos/(pdf_pos*pdf_dir) = L*area*pi; two-sided doubles power
    beta_tri = L * (area * jnp.pi * jnp.where(two_sided, 2.0, 1.0))[:, None]

    # ---- area sphere: uniform surface point + cosine direction ----
    sph = jnp.clip(g(scene.light_sphere), 0, scene.sph_center.shape[0] - 1)
    c_s = jnp.take(scene.sph_center, sph, axis=0)
    r_s = jnp.take(scene.sph_radius, sph)
    n_s = smp.uniform_sample_sphere(u_pos)
    p_s = c_s + r_s[:, None] * n_s
    tx_p, ty_p = vm.coordinate_system(n_s)
    d_sphl = vm.to_world(w_loc, tx_p, ty_p, n_s)
    beta_sphl = L * (4.0 * jnp.pi * jnp.pi * r_s * r_s)[:, None]

    # ---- infinite: direction from env distribution (or uniform),
    # origin on the world-bounding disk behind it ----
    wi_u = smp.uniform_sample_sphere(u_dir)
    wi_e, pdf_e, li_e = _sample_env_map(scene, u_dir)
    use_env = (scene.has_env_map > 0) & (light_id == scene.env_light_id)
    wi_inf = jnp.where(use_env[:, None], wi_e, wi_u)   # towards the light
    pdf_inf = jnp.where(use_env, pdf_e, jnp.full(N, smp.INV_4PI))
    le_inf = jnp.where(use_env[:, None], li_e, L)
    v1i, v2i = vm.coordinate_system(wi_inf)
    o_inf = wc + wr * (cd[:, 0:1] * v1i + cd[:, 1:2] * v2i) + wr * wi_inf
    d_inf = -wi_inf
    beta_inf = le_inf * (jnp.pi * wr * wr / jnp.maximum(
        pdf_inf, 1e-12))[:, None]

    is_pt = kind == LIGHT_POINT
    is_spot = kind == LIGHT_SPOT
    is_gon = kind == LIGHT_GONIO
    is_prj = kind == LIGHT_PROJECTION
    is_dist = kind == LIGHT_DISTANT
    is_inf = kind == LIGHT_INFINITE
    is_tri = kind == LIGHT_AREA_TRI
    is_sph = kind == LIGHT_AREA_SPHERE

    def sel3(*pairs, default):
        out = default
        for m, v in pairs:
            out = jnp.where(m[:, None], v, out)
        return out

    o = sel3((is_pt | is_spot | is_gon | is_prj, pos), (is_dist, o_dist),
             (is_inf, o_inf), (is_tri, p_t), (is_sph, p_s), default=pos)
    d = sel3((is_pt | is_gon | is_prj, d_sph), (is_spot, d_spot),
             (is_dist, d_dist), (is_inf, d_inf), (is_tri, d_tri),
             (is_sph, d_sphl), default=d_sph)
    beta = sel3((is_pt, beta_pt), (is_spot, beta_spot), (is_gon, beta_gonio),
                (is_prj, beta_proj), (is_dist, beta_dist), (is_inf, beta_inf),
                (is_tri, beta_tri), (is_sph, beta_sphl), default=beta_pt)
    valid = (light_id >= 0) & (light_id < scene.n_lights) & \
        (vm.luminance(jnp.abs(beta)) > 0.0)

    # separated emission pdfs / radiance (ref: *.cpp Pdf_Le signatures)
    N1 = jnp.ones(N)
    le = sel3((is_pt, L), (is_spot, L * falloff[:, None]),
              (is_gon, L * _gonio_scale(scene, light_id, d_sph)),
              (is_prj, L * _projection_scale(scene, light_id, d_sph)),
              (is_dist, L), (is_inf, le_inf), (is_tri, L), (is_sph, L),
              default=L)
    n_emit_out = sel3((is_tri, n_emit), (is_sph, n_s), default=d)
    inv_disk = 1.0 / jnp.maximum(jnp.pi * wr * wr, 1e-12)
    pdf_pos = jnp.where(is_tri, 1.0 / area,
               jnp.where(is_sph, 1.0 / jnp.maximum(
                   4.0 * jnp.pi * r_s * r_s, 1e-12),
               jnp.where(is_dist | is_inf, inv_disk, N1)))
    cos_emit = jnp.where(is_tri | is_sph,
                         vm.absdot(d, n_emit_out), N1)
    pdf_dir = jnp.where(is_tri | is_sph,
                        smp.cosine_hemisphere_pdf(cos_emit),
               jnp.where(is_pt | is_gon | is_prj, jnp.full(N, smp.INV_4PI),
               jnp.where(is_spot, smp.uniform_cone_pdf(ct),
               jnp.where(is_inf, pdf_inf, N1))))
    delta_pos = is_pt | is_spot | is_gon | is_prj
    delta_dir = is_dist
    return LightEmission(o=o, d=d, beta=beta, valid=valid, le=le,
                         n_l=n_emit_out, pdf_pos=pdf_pos, pdf_dir=pdf_dir,
                         delta_pos=delta_pos, delta_dir=delta_dir)


def pdf_le_dir(scene, light_id, n_l, w):
    """Solid-angle pdf of a light at a surface point with normal n_l
    emitting towards w (ref: diffuse.cpp/point.cpp/spot.cpp Pdf_Le
    direction half).  Delta-direction lights (distant) return 0."""
    g = lambda a: jnp.take(a, light_id, axis=0)
    kind = g(scene.light_kind)
    two_sided = g(scene.light_two_sided) > 0.5
    cos_w = vm.dot(n_l, w)
    pdf_area = jnp.where(two_sided,
                         0.5 * smp.cosine_hemisphere_pdf(jnp.abs(cos_w)),
                         jnp.where(cos_w > 0.0,
                                   smp.cosine_hemisphere_pdf(cos_w), 0.0))
    ct = g(scene.light_cos_total)
    cos_sp = vm.dot(g(scene.light_dir), w)
    pdf_spot = jnp.where(cos_sp >= ct, smp.uniform_cone_pdf(ct), 0.0)
    pdf_inf = jnp.where(
        (scene.has_env_map > 0) & (light_id == scene.env_light_id),
        _env_dir_pdf(scene, -w), smp.INV_4PI)
    is_area = (kind == LIGHT_AREA_TRI) | (kind == LIGHT_AREA_SPHERE)
    is_ptlike = (kind == LIGHT_POINT) | (kind == LIGHT_GONIO) | \
        (kind == LIGHT_PROJECTION)
    return jnp.where(is_area, pdf_area,
           jnp.where(is_ptlike, smp.INV_4PI,
           jnp.where(kind == LIGHT_SPOT, pdf_spot,
           jnp.where(kind == LIGHT_INFINITE, pdf_inf, 0.0))))


def pdf_light_origin(scene, light_id):
    """Area-measure pdf of sampling this light's emission origin, times
    the scene light-selection pdf (ref: bdpt Vertex::PdfLightOrigin).
    Delta-position lights return 0 (remapped by the MIS delta flags)."""
    g = lambda a: jnp.take(a, light_id, axis=0)
    kind = g(scene.light_kind)
    sel = jnp.take(scene.light_pdf, light_id)
    area = jnp.maximum(g(scene.light_area), 1e-12)
    sph = jnp.clip(g(scene.light_sphere), 0, scene.sph_center.shape[0] - 1)
    r_s = jnp.take(scene.sph_radius, sph)
    inv_disk = 1.0 / jnp.maximum(
        jnp.pi * scene.world_radius * scene.world_radius, 1e-12)
    pdf_pos = jnp.where(kind == LIGHT_AREA_TRI, 1.0 / area,
               jnp.where(kind == LIGHT_AREA_SPHERE,
                         1.0 / jnp.maximum(4.0 * jnp.pi * r_s * r_s, 1e-12),
               jnp.where(kind == LIGHT_DISTANT, inv_disk, 0.0)))
    return pdf_pos * sel


def finite_light_distribution(scene):
    """(pdf, cdf) over light slots restricted to non-infinite lights,
    renormalized — BDPT light subpaths start from finite lights only
    (escaped-ray + NEE strategies cover the environment)."""
    Ls = scene.light_kind.shape[0]
    live = jnp.arange(Ls) < scene.n_lights
    w = jnp.where(live & (scene.light_kind != LIGHT_INFINITE),
                  scene.light_pdf, 0.0)
    total = jnp.maximum(jnp.sum(w), 1e-20)
    pdf = w / total
    return pdf, jnp.cumsum(pdf)


def has_infinite(scene):
    L = scene.light_kind.shape[0]
    live = jnp.arange(L) < scene.n_lights
    return jnp.any((scene.light_kind == LIGHT_INFINITE) & live)
