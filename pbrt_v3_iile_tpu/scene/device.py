"""Device scene: every scene entity as flat jnp arrays (one pytree).

This is the flat-array replacement for the reference's pointer-based
Scene/Primitive/Material/Light object graph (ref: src/core/scene.h:49,
primitive.h, light.h): geometry, BVH, materials and lights are
structure-of-arrays so any wavefront stage is a gather + vector op.
Replicated across the device mesh (small-scene regime, ref SURVEY §5).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from ..utils import log
import jax.numpy as jnp

from ..ops import bvh as bvhlib
from ..ops import fourierbsdf as fourierlib
from . import api as apilib
from . import textures as texlib


class DeviceScene(NamedTuple):
    # --- triangles (BVH order) ---
    tri_p0: jnp.ndarray      # (T,3)
    tri_e1: jnp.ndarray      # (T,3) p1-p0
    tri_e2: jnp.ndarray      # (T,3) p2-p0
    tri_ng: jnp.ndarray      # (T,3) geometric normal (unit)
    tri_ns: jnp.ndarray      # (T,3,3) shading normals per vertex
    tri_uv: jnp.ndarray      # (T,3,2)
    tri_mat: jnp.ndarray     # (T,) i32
    tri_light: jnp.ndarray   # (T,) i32, -1 = not emissive
    # --- object motion blur (TransformedPrimitive/AnimatedTransform,
    # ref: core/primitive.h + transform.h:412 Decompose/Interpolate):
    # M rotation-correct sub-keyframes (T/S lerped, R slerped at build
    # time, <=15 deg per segment), piecewise-lerped per ray time inside
    # the triangle test.  Static scenes carry (1,1,...) placeholders;
    # the BVH is built over the union of ALL sub-keyframes' bounds so
    # traversal stays conservative for any time. ---
    tris_steps_packed: jnp.ndarray  # (M,T,12) or (1,1,12) f32: p0,e1,e2
    tri_ng_steps: jnp.ndarray       # (M,T,3) or (1,1,3)
    tri_ns_steps: jnp.ndarray       # (M,T,3,3) or (1,1,3,3)
    # --- BVH (LinearBVHNode layout, ref bvh.cpp:95) ---
    node_min: jnp.ndarray    # (M,3)
    node_max: jnp.ndarray    # (M,3)
    node_right: jnp.ndarray  # (M,) i32
    node_count: jnp.ndarray  # (M,) i32 (0 = interior)
    node_axis: jnp.ndarray   # (M,) i32
    # --- packed hot-path layouts (one gather per traversal step) ---
    # int32 rows: the float bounds ride as bit patterns next to the ids
    nodes_packed: jnp.ndarray  # (M,8) i32: bits(min3), bits(max3), right, count<<2|axis
    tris_packed: jnp.ndarray   # (T,12) f32: p0, e1, e2, pad
    # --- analytic spheres (emitters) ---
    sph_center: jnp.ndarray  # (S,3)
    sph_radius: jnp.ndarray  # (S,)
    sph_mat: jnp.ndarray     # (S,) i32
    sph_light: jnp.ndarray   # (S,) i32
    n_spheres: jnp.ndarray   # () i32 — real count (array is padded)
    # --- materials SoA ---
    mat_kind: jnp.ndarray    # (M,) i32
    mat_kd: jnp.ndarray      # (M,3)
    mat_ks: jnp.ndarray
    mat_kr: jnp.ndarray
    mat_kt: jnp.ndarray
    mat_rough: jnp.ndarray   # (M,)
    mat_urough: jnp.ndarray
    mat_vrough: jnp.ndarray
    mat_eta: jnp.ndarray
    mat_metal_eta: jnp.ndarray  # (M,3)
    mat_metal_k: jnp.ndarray    # (M,3)
    mat_sigma: jnp.ndarray
    mat_remap: jnp.ndarray   # (M,) bool-ish f32
    mat_aux: jnp.ndarray     # (M,8) disney extras (api.MaterialRecord.aux)
    mat_kd_tex: jnp.ndarray  # (M,) i32 texture id or -1
    mat_ks_tex: jnp.ndarray
    mat_sigma_tex: jnp.ndarray
    mat_rough_tex: jnp.ndarray
    # --- texture table ---
    textures: texlib.TextureTable
    # --- lights SoA ---
    light_kind: jnp.ndarray  # (L,) i32
    light_L: jnp.ndarray     # (L,3)
    light_pos: jnp.ndarray   # (L,3)
    light_dir: jnp.ndarray   # (L,3)
    light_cos_total: jnp.ndarray    # (L,)
    light_cos_falloff: jnp.ndarray  # (L,)
    light_two_sided: jnp.ndarray    # (L,)
    light_sphere: jnp.ndarray       # (L,) i32 index into spheres
    light_tri_off: jnp.ndarray      # (L,) i32 into light-tri table
    light_tri_cnt: jnp.ndarray      # (L,) i32
    light_area: jnp.ndarray         # (L,) total emitting area
    light_pdf: jnp.ndarray          # (L,) selection probability
    light_cdf: jnp.ndarray          # (L,) cumulative selection
    n_lights: jnp.ndarray           # () i32
    # goniometric / projection light maps (fixed-size resampled stack)
    light_w2l: jnp.ndarray      # (L,3,3) world-to-light rotation
    light_img: jnp.ndarray      # (G, MH, MW, 3) per-light direction maps
    light_img_id: jnp.ndarray   # (L,) i32 index into light_img or -1
    light_proj_ax: jnp.ndarray  # (L,) projection: tan(fov/2)*screen half-x
    light_proj_ay: jnp.ndarray  # (L,)
    # --- light-triangle table (for area sampling; own ordering) ---
    ltri_p0: jnp.ndarray     # (K,3)
    ltri_e1: jnp.ndarray
    ltri_e2: jnp.ndarray
    ltri_ng: jnp.ndarray     # (K,3)
    ltri_area: jnp.ndarray   # (K,)
    ltri_cdf: jnp.ndarray    # (K,) per-light-normalized cumulative area
    ltri_light: jnp.ndarray  # (K,) i32 owning light
    # --- media (homogeneous + grid-density heterogeneous) ---
    med_sigma_a: jnp.ndarray   # (D,3)
    med_sigma_s: jnp.ndarray   # (D,3)
    med_g: jnp.ndarray         # (D,)
    med_grid_id: jnp.ndarray   # (D,) i32 index into med_density or -1
    med_w2m: jnp.ndarray       # (D,4,4) world->medium (unit cube) xform
    med_density: jnp.ndarray   # (G,DZ,DY,DX) padded density grids
    med_grid_dims: jnp.ndarray  # (G,3) i32 actual (nx,ny,nz) per grid
    med_max_density: jnp.ndarray  # (D,) max grid density (1 for homog.)
    tri_med_in: jnp.ndarray    # (T,) i32 interior medium id or -1
    tri_med_out: jnp.ndarray   # (T,) i32 exterior medium id or -1
    camera_medium: jnp.ndarray  # () i32
    n_media: jnp.ndarray        # () i32
    # --- environment map (first infinite light with a mapname) ---
    env_img: jnp.ndarray        # (EH, EW, 3) radiance (already scaled by L)
    env_marg_cdf: jnp.ndarray   # (EH,) row-marginal CDF over sin-weighted lum
    env_cond_cdf: jnp.ndarray   # (EH, EW) per-row conditional CDF
    env_pdf: jnp.ndarray        # (EH, EW) solid-angle pdf of each texel dir
    env_to_world: jnp.ndarray   # (3,3) light-to-world rotation
    env_world_to: jnp.ndarray   # (3,3) inverse
    has_env_map: jnp.ndarray    # () i32 0/1
    env_light_id: jnp.ndarray   # () i32 which light owns the map (-1 none)
    # --- world ---
    world_min: jnp.ndarray   # (3,)
    world_max: jnp.ndarray   # (3,)
    # --- SpatialLightDistribution (ref: lightdistrib.h:100): per-voxel
    # light-selection pdf/cdf over a world-bounds grid; (1, L) uniform
    # tables when the strategy is not "spatial" ---
    spatial_pdf: jnp.ndarray  # (V, L) f32
    spatial_cdf: jnp.ndarray  # (V, L) f32
    spatial_res: jnp.ndarray  # (3,) i32 grid resolution (1,1,1 if off)
    world_radius: jnp.ndarray  # ()
    # --- optional kd-tree aggregate (ref: accelerators/kdtreeaccel.cpp;
    # built when the scene says Accelerator "kdtree" — ops/kdtree.py) ---
    kd_split: jnp.ndarray = jnp.zeros(1, jnp.float32)   # (K,)
    kd_meta: jnp.ndarray = jnp.full(1, 3, jnp.int32)    # (K,) axis|leaf+count
    kd_offset: jnp.ndarray = jnp.zeros(1, jnp.int32)    # (K,)
    kd_prims: jnp.ndarray = jnp.zeros(1, jnp.int32)     # (P,)
    kd_bounds: jnp.ndarray = jnp.zeros((2, 3), jnp.float32)
    # --- ray-cone texture filtering (ref: core/mipmap.h MIPMap width;
    # redesigned as ray cones for the wavefront — scene/textures.py) ---
    tri_uv_density: jnp.ndarray = jnp.zeros(1, jnp.float32)  # (T,) sqrt(dUV/dA)
    tex_theta: jnp.ndarray = jnp.zeros((), jnp.float32)      # pixel cone angle
    tex_cone_o: jnp.ndarray = jnp.zeros(3, jnp.float32)      # cone apex (camera)
    # --- exact FourierBSDF tables (ref: materials/fourier.cpp), dense
    # (ops/fourierbsdf.FourierDev); None when the scene has none ---
    mat_fourier_id: jnp.ndarray = jnp.full(1, -1, jnp.int32)  # (M,)
    fourier: object = None
    # --- ptex face index per triangle (ref: triangle.cpp faceIndices →
    # SurfaceInteraction::faceIndex; consumed by scene/textures.py) ---
    tri_face: jnp.ndarray = jnp.zeros(1, jnp.int32)  # (T,) or (1,)
    # --- BSSRDF per-channel Burley diffusion length (ref: core/bssrdf.cpp
    # TabulatedBSSRDF's radial profile role; integrators/path.py) ---
    mat_sss_d: jnp.ndarray = jnp.zeros((1, 3), jnp.float32)  # (M,3)
    # --- fused-kernel cluster tables (ops/clusters_pallas.ClusterPack);
    # None unless the scene is built for the GPU cluster traversal ---
    clusters: object = None


def _build_clusters_maybe(flat, p, e1, e2, with_clusters):
    """Packed cluster tables for the fused GPU traversal
    (ops/clusters_pallas.py); p/e1/e2 are the BVH-ordered device
    triangles so cluster prim offsets ARE scene triangle ids."""
    if not with_clusters:
        return None
    from ..ops import clusters_pallas as cluster_lib
    return cluster_lib.build_cluster_pack(flat, p[:, 0], e1, e2)


def _pad(a, n, fill=0.0):
    a = np.asarray(a)
    if a.shape[0] >= n:
        return a
    pad_shape = (n - a.shape[0],) + a.shape[1:]
    return np.concatenate([a, np.full(pad_shape, fill, dtype=a.dtype)], axis=0)


def _anim_eval(anim, t):
    """Evaluate a decomposed AnimatedTransform at time t in [0,1]
    (ref: transform.cpp AnimatedTransform::Interpolate — translation and
    scale lerp, rotation slerps).  Returns (verts (cnt,3,3),
    shading normals (cnt,3,3))."""
    from ..utils import transforms as xf
    q = xf.quat_slerp(float(t), anim["q0"], anim["q1"])
    R = xf.quat_to_matrix(q)
    S = anim["S0"] + t * (anim["S1"] - anim["S0"])
    T = anim["T0"] + t * (anim["T1"] - anim["T0"])
    M3 = (R @ S).astype(np.float64)
    p_obj = np.asarray(anim["p_obj"], np.float64)
    pw = p_obj @ M3.T + T[None, None, :]
    n_obj = anim.get("n_obj")
    if n_obj is None:
        n_obj = _smooth_from_geo(anim["p_obj"])
    inv_t = np.linalg.inv(M3).T
    nw = np.asarray(n_obj, np.float64) @ inv_t.T
    ln = np.linalg.norm(nw, axis=-1, keepdims=True)
    nw = nw / np.maximum(ln, 1e-20)
    return pw.astype(np.float32), nw.astype(np.float32)


def _motion_steps(sd):
    """Scene-global sub-keyframe count: enough steps that each
    piecewise-linear segment spans <= 15 degrees of the largest
    rotation (the transform.h:412 slerp, discretized for the
    fixed-shape wavefront; error bound ~0.9% of radius at 15 deg)."""
    from ..utils import transforms as xf
    max_angle = 0.0
    for b in sd.tri_blocks:
        anim = b.get("anim")
        if anim is not None:
            c = abs(float(np.dot(anim["q0"], anim["q1"])))
            max_angle = max(max_angle, 2.0 * np.arccos(min(c, 1.0)))
    steps = int(np.ceil(np.degrees(max_angle) / 15.0)) + 1
    return int(np.clip(steps, 2, 16))


def build_device_scene(sd: apilib.SceneDesc, use_native_bvh: bool = True,
                       with_clusters: bool = False) -> DeviceScene:
    # ---- concatenate triangle blocks ----
    if sd.tri_blocks:
        p = np.concatenate([b["p"] for b in sd.tri_blocks], axis=0)
        ns = np.concatenate(
            [b["n"] if b["n"] is not None else _smooth_from_geo(b["p"])
             for b in sd.tri_blocks], axis=0)
        uv = np.concatenate(
            [b["uv"] if b["uv"] is not None else _default_uv(b["p"].shape[0])
             for b in sd.tri_blocks], axis=0)
        mat = np.concatenate([b["mat"] for b in sd.tri_blocks])
        lig = np.concatenate([b["light"] for b in sd.tri_blocks])
        face = np.concatenate(
            [b.get("face", np.arange(b["p"].shape[0], dtype=np.int32))
             for b in sd.tri_blocks])
        m_in = np.concatenate([b.get("med_in", np.full(b["p"].shape[0], -1,
                                                       np.int32))
                               for b in sd.tri_blocks])
        m_out = np.concatenate([b.get("med_out", np.full(b["p"].shape[0], -1,
                                                         np.int32))
                                for b in sd.tri_blocks])
        n_steps = _motion_steps(sd) if sd.has_motion else 2
        p_step_rows, ns_step_rows = [], []
        for b in sd.tri_blocks:
            anim = b.get("anim")
            bn = (b["n"] if b["n"] is not None
                  else _smooth_from_geo(b["p"]))
            if anim is not None:
                evs = [_anim_eval(anim, sidx / (n_steps - 1))
                       for sidx in range(n_steps)]
                p_step_rows.append(np.stack([e[0] for e in evs]))
                ns_step_rows.append(np.stack([e[1] for e in evs]))
            elif b.get("p_end") is not None:
                # legacy two-keyframe block (no decomposition): linear
                be = b["p_end"]
                bne = b["n_end"] if b.get("n_end") is not None else bn
                ts = np.linspace(0.0, 1.0, n_steps)[:, None, None, None]
                p_step_rows.append(b["p"][None] * (1 - ts) + be[None] * ts)
                ns_step_rows.append(bn[None] * (1 - ts) + bne[None] * ts)
            else:
                p_step_rows.append(np.repeat(b["p"][None], n_steps, 0))
                ns_step_rows.append(np.repeat(bn[None], n_steps, 0))
        p_steps = np.concatenate(p_step_rows, axis=1)   # (M,T,3,3)
        ns_steps = np.concatenate(ns_step_rows, axis=1)
        p_end = p_steps[-1]
        ns_end = ns_steps[-1]
    else:
        p = np.zeros((1, 3, 3), np.float32)
        ns = np.zeros((1, 3, 3), np.float32)
        uv = np.zeros((1, 3, 2), np.float32)
        mat = np.zeros(1, np.int32)
        lig = np.full(1, -1, np.int32)
        face = np.zeros(1, np.int32)
        m_in = np.full(1, -1, np.int32)
        m_out = np.full(1, -1, np.int32)
        p_end = p
        ns_end = ns
        n_steps = 2
        p_steps = np.repeat(p[None], 2, 0)
        ns_steps = np.repeat(ns[None], 2, 0)

    has_motion = bool(getattr(sd, "has_motion", False))
    if has_motion:
        # BVH bounds must cover the whole shutter: build over the union
        # of ALL sub-keyframes (a rotating shape sweeps outside the
        # endpoint-lerp hull; the numpy builder only consumes per-prim
        # bounds/centroids so the (T, 3*M, 3) stack is valid input)
        allpts = np.concatenate(list(p_steps), axis=1)
        flat = bvhlib.build_bvh(allpts, use_native=False)
    else:
        flat = bvhlib.build_bvh(p, use_native=use_native_bvh)
    order = flat.prim_order
    p, ns, uv, mat, lig = p[order], ns[order], uv[order], mat[order], lig[order]
    m_in, m_out = m_in[order], m_out[order]
    face = face[order]
    p_end, ns_end = p_end[order], ns_end[order]
    p_steps = p_steps[:, order]
    ns_steps = ns_steps[:, order]

    def _geo_normal(pp):
        e1_ = pp[:, 1] - pp[:, 0]
        e2_ = pp[:, 2] - pp[:, 0]
        ng_ = np.cross(e1_, e2_)
        a2 = np.linalg.norm(ng_, axis=-1, keepdims=True)
        return np.where(a2 > 1e-20, ng_ / np.maximum(a2, 1e-20), 0.0)

    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    ng = _geo_normal(p)

    # ---- spheres (padded to >=1) ----
    S = max(1, len(sd.spheres))
    sph_center = np.zeros((S, 3), np.float32)
    sph_radius = np.zeros(S, np.float32)
    sph_mat = np.zeros(S, np.int32)
    sph_light = np.full(S, -1, np.int32)
    for i, s in enumerate(sd.spheres):
        sph_center[i] = s["center"]
        sph_radius[i] = s["radius"]
        sph_mat[i] = s["mat"]
        sph_light[i] = s["light"]

    # ---- materials SoA ----
    M = len(sd.materials)
    z3 = lambda: np.zeros((M, 3), np.float32)
    mk = np.zeros(M, np.int32)
    kd, ks, kr, kt = z3(), z3(), z3(), z3()
    meta, mk_k = z3(), z3()
    rough = np.zeros(M, np.float32)
    uro = np.full(M, -1.0, np.float32)
    vro = np.full(M, -1.0, np.float32)
    eta = np.full(M, 1.5, np.float32)
    sigma = np.zeros(M, np.float32)
    remap = np.ones(M, np.float32)
    mat_aux = np.zeros((M, 8), np.float32)
    tex_table, tex_ids = texlib.build_table(sd.textures)
    kd_tex = np.full(M, -1, np.int32)
    ks_tex = np.full(M, -1, np.int32)
    sg_tex = np.full(M, -1, np.int32)
    ro_tex = np.full(M, -1, np.int32)
    fr_id = np.full(M, -1, np.int32)
    fourier_tables = []
    sss_d = np.zeros((M, 3), np.float32)
    for i, m in enumerate(sd.materials):
        if getattr(m, "fourier_table", None) is not None:
            fr_id[i] = len(fourier_tables)
            fourier_tables.append(m.fourier_table)
        if getattr(m, "sss_d", None) is not None:
            sss_d[i] = m.sss_d
        kd_tex[i] = tex_ids.get(m.kd_tex, -1)
        ks_tex[i] = tex_ids.get(m.ks_tex, -1)
        sg_tex[i] = tex_ids.get(m.sigma_tex, -1)
        ro_tex[i] = tex_ids.get(m.rough_tex, -1)
        mk[i] = m.kind
        if m.kd is not None:
            kd[i] = m.kd
        if m.ks is not None:
            ks[i] = m.ks
        if m.kr is not None:
            kr[i] = m.kr
        if m.kt is not None:
            kt[i] = m.kt
        if m.metal_eta is not None:
            meta[i] = m.metal_eta
        if m.metal_k is not None:
            mk_k[i] = m.metal_k
        rough[i] = m.roughness
        uro[i] = m.uroughness
        vro[i] = m.vroughness
        eta[i] = m.eta
        sigma[i] = m.sigma
        remap[i] = 1.0 if m.remap_roughness else 0.0
        if m.aux is not None:
            mat_aux[i] = m.aux

    # ---- light-triangle table ----
    ltp, lte1, lte2, ltng, ltarea, ltlight = [], [], [], [], [], []
    l_off = np.zeros(max(1, len(sd.lights)), np.int32)
    l_cnt = np.zeros(max(1, len(sd.lights)), np.int32)
    l_area = np.zeros(max(1, len(sd.lights)), np.float32)
    # area triangles must be found in ORIGINAL block order (pre-BVH-permute):
    # rebuild from blocks directly.
    tri_light_orig = []
    tri_p_orig = []
    for b in sd.tri_blocks:
        tri_light_orig.append(b["light"])
        tri_p_orig.append(b["p"])
    if tri_p_orig:
        tri_light_orig = np.concatenate(tri_light_orig)
        tri_p_orig = np.concatenate(tri_p_orig, axis=0)
    else:
        tri_light_orig = np.full(0, -1, np.int32)
        tri_p_orig = np.zeros((0, 3, 3), np.float32)

    for li, lrec in enumerate(sd.lights):
        if lrec.kind == apilib.LIGHT_AREA_TRI and lrec.tri_count > 0:
            sel = np.arange(lrec.tri_start, lrec.tri_start + lrec.tri_count)
            tp = tri_p_orig[sel]
            te1 = tp[:, 1] - tp[:, 0]
            te2 = tp[:, 2] - tp[:, 0]
            cr = np.cross(te1, te2)
            a = 0.5 * np.linalg.norm(cr, axis=-1)
            n = np.where(a[:, None] > 1e-20, cr / np.maximum(2 * a[:, None], 1e-20), 0.0)
            l_off[li] = len(ltarea) and sum(len(x) for x in ltarea) or 0
            l_off[li] = int(sum(len(x) for x in ltarea))
            l_cnt[li] = tp.shape[0]
            l_area[li] = float(a.sum())
            ltp.append(tp[:, 0]); lte1.append(te1); lte2.append(te2)
            ltng.append(n); ltarea.append(a)
            ltlight.append(np.full(tp.shape[0], li, np.int32))
        elif lrec.kind == apilib.LIGHT_AREA_SPHERE:
            r = sd.spheres[lrec.sphere_index]["radius"]
            l_area[li] = float(4.0 * np.pi * r * r)

    if ltarea:
        ltri_p0 = np.concatenate(ltp).astype(np.float32)
        ltri_e1 = np.concatenate(lte1).astype(np.float32)
        ltri_e2 = np.concatenate(lte2).astype(np.float32)
        ltri_ng = np.concatenate(ltng).astype(np.float32)
        ltri_area = np.concatenate(ltarea).astype(np.float32)
        ltri_light = np.concatenate(ltlight)
        # per-light-normalized cdf
        ltri_cdf = np.zeros_like(ltri_area)
        for li in range(len(sd.lights)):
            o, c = l_off[li], l_cnt[li]
            if c > 0:
                seg = ltri_area[o:o + c]
                ltri_cdf[o:o + c] = np.cumsum(seg) / max(seg.sum(), 1e-20)
    else:
        ltri_p0 = np.zeros((1, 3), np.float32)
        ltri_e1 = np.zeros((1, 3), np.float32)
        ltri_e2 = np.zeros((1, 3), np.float32)
        ltri_ng = np.zeros((1, 3), np.float32)
        ltri_area = np.zeros(1, np.float32)
        ltri_cdf = np.ones(1, np.float32)
        ltri_light = np.full(1, -1, np.int32)

    # ---- lights SoA ----
    L = max(1, len(sd.lights))
    lkind = np.zeros(L, np.int32)
    lL = np.zeros((L, 3), np.float32)
    lpos = np.zeros((L, 3), np.float32)
    ldir = np.tile(np.array([[0, 0, 1.0]], np.float32), (L, 1))
    lct = np.full(L, -1.0, np.float32)
    lcf = np.full(L, -1.0, np.float32)
    l2s = np.zeros(L, np.float32)
    lsph = np.full(L, -1, np.int32)
    for i, lrec in enumerate(sd.lights):
        lkind[i] = lrec.kind
        lL[i] = lrec.L
        if lrec.position is not None:
            lpos[i] = lrec.position
        if lrec.direction is not None:
            ldir[i] = lrec.direction
        lct[i] = lrec.cos_total
        lcf[i] = lrec.cos_falloff
        l2s[i] = 1.0 if lrec.two_sided else 0.0
        lsph[i] = lrec.sphere_index

    # ---- goniometric / projection direction maps ----
    MH, MW = 64, 128
    lw2l = np.tile(np.eye(3, dtype=np.float32)[None], (L, 1, 1))
    limg_id = np.full(L, -1, np.int32)
    lproj_ax = np.ones(L, np.float32)
    lproj_ay = np.ones(L, np.float32)
    lmaps = []
    lmap_mean_lum = np.ones(L, np.float32)
    for i, lrec in enumerate(sd.lights):
        if lrec.kind not in (apilib.LIGHT_GONIO, apilib.LIGHT_PROJECTION):
            continue
        if lrec.w2l is not None:
            lw2l[i] = lrec.w2l
        if lrec.kind == apilib.LIGHT_PROJECTION:
            tan_half = float(np.tan(0.5 * np.deg2rad(lrec.fov)))
            aspect = 1.0
            img = None
            if lrec.map_name and not os.path.exists(lrec.map_name):
                import sys
                log.warning(f"light map {lrec.map_name} not found; "
            f"treating as unfiltered")
            if lrec.map_name and os.path.exists(lrec.map_name):
                try:
                    img = texlib._load_image_any(lrec.map_name)
                    aspect = img.shape[1] / img.shape[0]
                except Exception as e:
                    import sys
                    log.warning(f"projection map load failed: {e}")
            # ref: projection.cpp screen window — fov maps to the
            # shorter axis; the longer axis extends by the aspect ratio
            if aspect > 1.0:
                lproj_ax[i] = tan_half * aspect
                lproj_ay[i] = tan_half
            else:
                lproj_ax[i] = tan_half
                lproj_ay[i] = tan_half / aspect
            if img is not None:
                limg_id[i] = len(lmaps)
                lmaps.append(_resample_bilinear(img, MH, MW))
        else:  # goniometric
            if lrec.map_name and not os.path.exists(lrec.map_name):
                import sys
                log.warning(f"light map {lrec.map_name} not found; "
            f"treating as unfiltered")
            if lrec.map_name and os.path.exists(lrec.map_name):
                try:
                    img = texlib._load_image_any(lrec.map_name)
                    limg_id[i] = len(lmaps)
                    lmaps.append(_resample_bilinear(img, MH, MW))
                except Exception as e:
                    import sys
                    log.warning(f"gonio map load failed: {e}")
    for i in range(L):
        if limg_id[i] >= 0:
            lum = lmaps[limg_id[i]] @ np.array([0.212671, 0.715160, 0.072169])
            lmap_mean_lum[i] = float(lum.mean())
    light_img = (np.stack(lmaps) if lmaps
                 else np.ones((1, MH, MW, 3), np.float32))

    # ---- media ----
    D = max(1, len(sd.media))
    med_a = np.zeros((D, 3), np.float32)
    med_s = np.zeros((D, 3), np.float32)
    med_g = np.zeros(D, np.float32)
    med_gid = np.full(D, -1, np.int32)
    med_w2m = np.tile(np.eye(4, dtype=np.float32), (D, 1, 1))
    med_maxd = np.ones(D, np.float32)
    grids = []
    for i, mrec in enumerate(sd.media):
        med_a[i] = mrec.sigma_a
        med_s[i] = mrec.sigma_s
        med_g[i] = mrec.g
        if getattr(mrec, "density", None) is not None:
            med_gid[i] = len(grids)
            grids.append(np.asarray(mrec.density, np.float32))
            med_w2m[i] = np.asarray(mrec.w2m, np.float32)
            med_maxd[i] = max(float(mrec.density.max()), 1e-9)
    # pad grids to a common (DZ,DY,DX) so they stack into one array
    if grids:
        dz = max(g.shape[0] for g in grids)
        dy = max(g.shape[1] for g in grids)
        dx = max(g.shape[2] for g in grids)
        med_dens = np.zeros((len(grids), dz, dy, dx), np.float32)
        med_dims = np.zeros((len(grids), 3), np.int32)
        for gi, g in enumerate(grids):
            med_dens[gi, :g.shape[0], :g.shape[1], :g.shape[2]] = g
            med_dims[gi] = [g.shape[2], g.shape[1], g.shape[0]]  # nx,ny,nz
    else:
        med_dens = np.ones((1, 1, 1, 1), np.float32)
        med_dims = np.ones((1, 3), np.int32)

    # ---- environment map ----
    env = _build_env_map(sd)

    # world bounds (geometry + spheres)
    wmin = p.min(axis=(0, 1)) if p.size else np.zeros(3)
    wmax = p.max(axis=(0, 1)) if p.size else np.ones(3)
    for s in sd.spheres:
        wmin = np.minimum(wmin, np.asarray(s["center"]) - s["radius"])
        wmax = np.maximum(wmax, np.asarray(s["center"]) + s["radius"])
    wradius = 0.5 * float(np.linalg.norm(wmax - wmin))
    wradius = max(wradius, 1e-3)

    # light selection: power-weighted when requested (ref:
    # lightdistrib.cpp PowerLightDistribution / light Power() methods),
    # else uniform (UniformLightDistribution).  The spatial voxel
    # distribution degrades to power here.
    nl = len(sd.lights)
    use_power = sd.integrator.light_strategy in ("power", "spatial")
    powers = np.zeros(L, np.float64)
    for i, lrec in enumerate(sd.lights):
        lum = float(np.dot(np.asarray(lrec.L, np.float64),
                           [0.212671, 0.715160, 0.072169]))
        if lrec.kind == apilib.LIGHT_POINT:
            powers[i] = 4.0 * np.pi * lum
        elif lrec.kind == apilib.LIGHT_SPOT:
            powers[i] = 2.0 * np.pi * lum * (
                1.0 - 0.5 * (lrec.cos_falloff + lrec.cos_total))
        elif lrec.kind in (apilib.LIGHT_DISTANT, apilib.LIGHT_INFINITE):
            powers[i] = np.pi * wradius * wradius * lum
        elif lrec.kind in (apilib.LIGHT_AREA_TRI, apilib.LIGHT_AREA_SPHERE):
            powers[i] = np.pi * lum * max(l_area[i], 1e-12) *                 (2.0 if lrec.two_sided else 1.0)
        elif lrec.kind == apilib.LIGHT_GONIO:
            # ref: goniometric.h Power(): 4 pi I * mean(map)
            powers[i] = 4.0 * np.pi * lum * lmap_mean_lum[i]
        elif lrec.kind == apilib.LIGHT_PROJECTION:
            # ref: projection.cpp Power(): solid angle of the cone
            tan2 = lproj_ax[i] * lproj_ay[i]
            cos_w = 1.0 / np.sqrt(1.0 + tan2)
            powers[i] = 2.0 * np.pi * (1.0 - cos_w) * lum * lmap_mean_lum[i]
    if use_power and powers[:max(nl, 1)].sum() > 0 and nl > 0:
        lpdf = np.zeros(L, np.float32)
        lpdf[:nl] = (powers[:nl] / powers[:nl].sum()).astype(np.float32)
    else:
        lpdf = np.full(L, 1.0 / max(nl, 1), np.float32)
    lcdf = np.cumsum(lpdf).astype(np.float32)

    # ---- SpatialLightDistribution (ref: lightdistrib.h:100
    # SpatialLightDistribution + lightdistrib.cpp ComputeDistribution):
    # voxelize the world bounds; per voxel, weight each light by its
    # estimated unoccluded contribution ~ power / max(d^2, diag^2/4) to
    # the voxel center (distant/infinite lights count as constant).
    # Precomputed densely at build time (the reference fills its hash
    # table lazily per thread; here a dense table is a single gather).
    if sd.integrator.light_strategy == "spatial" and nl > 0:
        ext = np.maximum(wmax - wmin, 1e-6)
        max_ext = float(ext.max())
        res = np.clip((ext / max_ext * 16.0).astype(np.int64), 1, 16)
        # light reference positions (centroid of emitting geometry)
        lref = np.zeros((L, 3), np.float64)
        has_pos = np.zeros(L, bool)
        for i, lrec in enumerate(sd.lights):
            if lrec.kind in (apilib.LIGHT_POINT, apilib.LIGHT_SPOT,
                             apilib.LIGHT_GONIO, apilib.LIGHT_PROJECTION):
                lref[i] = lpos[i]
                has_pos[i] = True
            elif lrec.kind == apilib.LIGHT_AREA_SPHERE:
                lref[i] = sd.spheres[lrec.sphere_index]["center"]
                has_pos[i] = True
            elif lrec.kind == apilib.LIGHT_AREA_TRI and l_cnt[i] > 0:
                tr = tri_p_orig[tri_light_orig == i]
                if tr.size:
                    lref[i] = tr.reshape(-1, 3).mean(axis=0)
                    has_pos[i] = True
        gz, gy, gx = np.meshgrid(
            (np.arange(res[2]) + 0.5) / res[2],
            (np.arange(res[1]) + 0.5) / res[1],
            (np.arange(res[0]) + 0.5) / res[0], indexing="ij")
        centers = (wmin[None, :]
                   + np.stack([gx, gy, gz], axis=-1).reshape(-1, 3) * ext)
        V = centers.shape[0]
        diag2 = float(np.sum((ext / res.astype(np.float64)) ** 2))
        d2 = np.sum((centers[:, None, :] - lref[None, :, :]) ** 2,
                    axis=-1)                                    # (V, L)
        contrib = powers[None, :] / np.maximum(d2, 0.25 * diag2)
        const = powers[None, :] / max(np.pi * wradius * wradius, 1e-9)
        contrib = np.where(has_pos[None, :], contrib, const)
        contrib[:, nl:] = 0.0
        tot = contrib.sum(axis=1, keepdims=True)
        # voxels that see nothing fall back to the global distribution
        spat_pdf = np.where(tot > 0, contrib / np.maximum(tot, 1e-30),
                            lpdf[None, :]).astype(np.float32)
        spat_cdf = np.cumsum(spat_pdf, axis=1).astype(np.float32)
        spat_res = res[:3].astype(np.int32)
    else:
        spat_pdf = lpdf[None, :]
        spat_cdf = lcdf[None, :]
        spat_res = np.ones(3, np.int32)
    # pad rows to a multiple of 8 floats: row gathers of 32-byte-aligned
    # rows (same layout rule as the (M,8) nodes_packed)
    Lp = ((max(spat_pdf.shape[1], 1) + 7) // 8) * 8
    if spat_pdf.shape[1] < Lp:
        pad_n = Lp - spat_pdf.shape[1]
        spat_pdf = np.concatenate(
            [spat_pdf, np.zeros((spat_pdf.shape[0], pad_n), np.float32)], 1)
        # cdf pad = 2.0 so (cdf < u) never counts a padded slot
        spat_cdf = np.concatenate(
            [spat_cdf, np.full((spat_cdf.shape[0], pad_n), 2.0,
                               np.float32)], 1)

    f32 = lambda a: jnp.asarray(a, dtype=jnp.float32)
    i32 = lambda a: jnp.asarray(a, dtype=jnp.int32)

    # packed hot-path layouts: the traversal loop fetches one contiguous
    # row per step instead of five scattered gathers
    M_nodes = flat.node_min.shape[0]
    nodes_packed = np.zeros((M_nodes, 8), np.int32)
    nodes_packed[:, 0:3] = flat.node_min.astype(np.float32).view(np.int32)
    nodes_packed[:, 3:6] = flat.node_max.astype(np.float32).view(np.int32)
    nodes_packed[:, 6] = flat.node_right.astype(np.int32)
    nodes_packed[:, 7] = ((flat.node_count.astype(np.int32) << 2)
                          | flat.node_axis.astype(np.int32))
    T_tris = p.shape[0]
    tris_packed = np.zeros((T_tris, 12), np.float32)
    tris_packed[:, 0:3] = p[:, 0]
    tris_packed[:, 3:6] = e1
    tris_packed[:, 6:9] = e2
    if has_motion:
        Ms = p_steps.shape[0]
        tris_steps_packed = np.zeros((Ms, T_tris, 12), np.float32)
        tris_steps_packed[:, :, 0:3] = p_steps[:, :, 0]
        tris_steps_packed[:, :, 3:6] = p_steps[:, :, 1] - p_steps[:, :, 0]
        tris_steps_packed[:, :, 6:9] = p_steps[:, :, 2] - p_steps[:, :, 0]
        ng_steps = np.stack([_geo_normal(p_steps[si])
                             for si in range(Ms)])
    else:
        tris_steps_packed = np.zeros((1, 1, 12), np.float32)
        ns_steps = ns[None, :1]
        ng_steps = ng[None, :1]

    # ray-cone texture filter inputs (scene/textures.py module doc): the
    # per-triangle UV-area density converts a world-space cone radius to a
    # UV footprint; the pixel cone angle comes from the camera
    duv1 = uv[:, 1] - uv[:, 0]
    duv2 = uv[:, 2] - uv[:, 0]
    uv_area = 0.5 * np.abs(duv1[..., 0] * duv2[..., 1]
                           - duv1[..., 1] * duv2[..., 0])
    w_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    uv_density = np.sqrt(uv_area / np.maximum(w_area, 1e-20)).astype(
        np.float32)
    cam = sd.camera
    if cam.kind == "perspective":
        tex_theta = (2.0 * np.tan(0.5 * np.deg2rad(cam.fov))
                     / max(sd.film.y_resolution, 1))
    else:
        tex_theta = 0.0  # ortho/env/realistic: finest level (as before)
    cone_o = np.asarray(cam.cam_to_world[:3, 3], np.float32)

    ds = DeviceScene(
        tri_p0=f32(p[:, 0]), tri_e1=f32(e1), tri_e2=f32(e2),
        tri_ng=f32(ng), tri_ns=f32(ns), tri_uv=f32(uv),
        tri_mat=i32(mat), tri_light=i32(lig),
        tris_steps_packed=f32(tris_steps_packed),
        tri_ng_steps=f32(ng_steps), tri_ns_steps=f32(ns_steps),
        node_min=f32(flat.node_min), node_max=f32(flat.node_max),
        node_right=i32(flat.node_right), node_count=i32(flat.node_count),
        node_axis=i32(flat.node_axis),
        nodes_packed=i32(nodes_packed), tris_packed=f32(tris_packed),
        sph_center=f32(sph_center), sph_radius=f32(sph_radius),
        sph_mat=i32(sph_mat), sph_light=i32(sph_light),
        n_spheres=i32(len(sd.spheres)),
        mat_kind=i32(mk), mat_kd=f32(kd), mat_ks=f32(ks), mat_kr=f32(kr),
        mat_kt=f32(kt), mat_rough=f32(rough), mat_urough=f32(uro),
        mat_vrough=f32(vro), mat_eta=f32(eta), mat_metal_eta=f32(meta),
        mat_metal_k=f32(mk_k), mat_sigma=f32(sigma), mat_remap=f32(remap),
        mat_aux=f32(mat_aux),
        tri_face=i32(face),
        mat_sss_d=f32(sss_d),
        clusters=(_build_clusters_maybe(flat, p, e1, e2, with_clusters)),
        mat_fourier_id=i32(fr_id),
        fourier=(fourierlib.densify(fourier_tables)
                 if fourier_tables else None),
        mat_kd_tex=i32(kd_tex), mat_ks_tex=i32(ks_tex),
        mat_sigma_tex=i32(sg_tex), mat_rough_tex=i32(ro_tex),
        textures=tex_table,
        light_kind=i32(lkind), light_L=f32(lL), light_pos=f32(lpos),
        light_dir=f32(ldir), light_cos_total=f32(lct),
        light_cos_falloff=f32(lcf), light_two_sided=f32(l2s),
        light_sphere=i32(lsph), light_tri_off=i32(l_off),
        light_tri_cnt=i32(l_cnt), light_area=f32(l_area),
        light_pdf=f32(lpdf), light_cdf=f32(lcdf), n_lights=i32(nl),
        light_w2l=f32(lw2l), light_img=f32(light_img),
        light_img_id=i32(limg_id), light_proj_ax=f32(lproj_ax),
        light_proj_ay=f32(lproj_ay),
        ltri_p0=f32(ltri_p0), ltri_e1=f32(ltri_e1), ltri_e2=f32(ltri_e2),
        ltri_ng=f32(ltri_ng), ltri_area=f32(ltri_area),
        ltri_cdf=f32(ltri_cdf), ltri_light=i32(ltri_light),
        med_sigma_a=f32(med_a), med_sigma_s=f32(med_s), med_g=f32(med_g),
        med_grid_id=i32(med_gid), med_w2m=f32(med_w2m),
        med_density=f32(med_dens), med_grid_dims=i32(med_dims),
        med_max_density=f32(med_maxd),
        tri_med_in=i32(m_in), tri_med_out=i32(m_out),
        camera_medium=i32(sd.camera_medium), n_media=i32(len(sd.media)),
        env_img=f32(env["img"]), env_marg_cdf=f32(env["marg"]),
        env_cond_cdf=f32(env["cond"]), env_pdf=f32(env["pdf"]),
        env_to_world=f32(env["to_world"]), env_world_to=f32(env["world_to"]),
        has_env_map=i32(env["has"]), env_light_id=i32(env["light_id"]),
        world_min=f32(wmin), world_max=f32(wmax),
        spatial_pdf=f32(spat_pdf), spatial_cdf=f32(spat_cdf),
        spatial_res=i32(spat_res),
        world_radius=f32(wradius),
        tri_uv_density=f32(uv_density), tex_theta=f32(tex_theta),
        tex_cone_o=f32(cone_o),
    )
    if getattr(sd, "accelerator", "bvh") == "kdtree":
        # alternative aggregate (ref: api.cpp MakeAccelerator "kdtree");
        # built over the SAME BVH-ordered triangle arrays so prim ids are
        # shared between the two traversals
        from ..ops import kdtree as kdlib
        kd = kdlib.build_kdtree(p[:, 0], e1, e2)
        ds = ds._replace(
            kd_split=f32(kd.split), kd_meta=i32(kd.meta),
            kd_offset=i32(kd.offset), kd_prims=i32(kd.prims),
            kd_bounds=f32(kd.bounds))
    return ds


def _build_env_map(sd):
    """Latitude-longitude env map + sampling distributions (ref:
    src/lights/infinite.cpp InfiniteAreaLight ctor: Distribution2D over
    sin-theta-weighted luminance; mipmap lookup becomes bilinear)."""
    import os
    out = dict(
        img=np.zeros((1, 1, 3), np.float32),
        marg=np.ones(1, np.float32),
        cond=np.ones((1, 1), np.float32),
        pdf=np.zeros((1, 1), np.float32),
        to_world=np.eye(3, dtype=np.float32),
        world_to=np.eye(3, dtype=np.float32),
        has=0, light_id=-1,
    )
    for li, lrec in enumerate(sd.lights):
        if lrec.kind != apilib.LIGHT_INFINITE or not lrec.map_name:
            continue
        if not os.path.exists(lrec.map_name):
            import sys
            log.warning(f"env map {lrec.map_name} not found; using "
            f"constant color")
            continue
        from . import textures as texlib
        try:
            img = texlib._load_image_any(lrec.map_name)
        except Exception as e:
            import sys
            log.warning(f"env map load failed: {e}")
            continue
        img = img * np.asarray(lrec.L, np.float32)
        if lrec.to_world is not None:
            # orthonormalize (scene files use rotations here)
            q, _ = np.linalg.qr(np.asarray(lrec.to_world, np.float64))
            out["to_world"] = q.astype(np.float32)
            out["world_to"] = q.T.astype(np.float32)
        EH, EW = img.shape[:2]
        lum = img @ np.array([0.212671, 0.715160, 0.072169])
        theta = (np.arange(EH) + 0.5) / EH * np.pi
        w = lum * np.sin(theta)[:, None] + 1e-12
        row_int = w.sum(axis=1)
        marg = np.cumsum(row_int) / row_int.sum()
        cond = np.cumsum(w, axis=1) / w.sum(axis=1, keepdims=True)
        # solid-angle pdf per texel: p(u,v)*HW/(2 pi^2 sin theta)
        p_uv = w / w.sum() * (EH * EW)
        sin_t = np.maximum(np.sin(theta)[:, None], 1e-6)
        pdf = p_uv / (2.0 * np.pi * np.pi * sin_t)
        out.update(img=img.astype(np.float32), marg=marg.astype(np.float32),
                   cond=cond.astype(np.float32), pdf=pdf.astype(np.float32),
                   has=1, light_id=li)
        break
    return out


def _resample_bilinear(img, h, w):
    """Host-side bilinear resample to a fixed (h, w, 3) raster so all
    light maps stack into one device array."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    ih, iw = img.shape[:2]
    fy = (np.arange(h) + 0.5) / h * ih - 0.5
    fx = (np.arange(w) + 0.5) / w * iw - 0.5
    y0 = np.clip(np.floor(fy).astype(np.int64), 0, ih - 1)
    x0 = np.clip(np.floor(fx).astype(np.int64), 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    ay = np.clip(fy - y0, 0.0, 1.0)[:, None, None]
    ax = np.clip(fx - x0, 0.0, 1.0)[None, :, None]
    out = ((1 - ay) * (1 - ax) * img[y0][:, x0]
           + (1 - ay) * ax * img[y0][:, x1]
           + ay * (1 - ax) * img[y1][:, x0]
           + ay * ax * img[y1][:, x1])
    return out.astype(np.float32)


def _smooth_from_geo(p):
    """Zero shading normals -> signals 'use geometric normal'."""
    return np.zeros_like(p)


def _default_uv(n):
    uv = np.zeros((n, 3, 2), np.float32)
    uv[:, 1, 0] = 1.0
    uv[:, 2, 1] = 1.0
    return uv
