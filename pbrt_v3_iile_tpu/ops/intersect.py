"""Wavefront ray-scene intersection.

The XLA walker (`intersect_bvh`) replaces the reference's recursive
per-ray BVH walk (ref: src/accelerators/bvh.cpp:662 Intersect / :702
IntersectP and src/shapes/triangle.cpp:188): the whole wavefront
advances one BVH node per `lax.while_loop` iteration, with per-ray
traversal stacks held as (N, DEPTH) arrays.  It is the CPU traversal,
the plain reference for the GPU cluster kernel
(ops/clusters_pallas.py), and that kernel's overflow fallback.
`default_accel` is the one place that picks a traversal for the
platform.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import vecmath as vm

STACK_DEPTH = 64
MAX_LEAF = 4  # must match ops/bvh.py MAX_LEAF
T_MIN = 0.0   # ray origins are pre-offset (vm.offset_ray_origin)


class Hit(NamedTuple):
    t: jnp.ndarray      # (N,) hit distance (= t_max when miss)
    prim: jnp.ndarray   # (N,) i32: -1 miss, [0,T) triangle, T+s sphere
    b1: jnp.ndarray     # (N,) triangle barycentric u
    b2: jnp.ndarray     # (N,)
    valid: jnp.ndarray  # (N,) bool


def _moller(o, d, p0, e1, e2, t_cur):
    """Möller–Trumbore; returns (valid, t, u, v). All (N,)."""
    pv = jnp.cross(d, e2)
    det = vm.dot(e1, pv)
    inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tv = o - p0
    u = vm.dot(tv, pv) * inv
    qv = jnp.cross(tv, e1)
    v = vm.dot(d, qv) * inv
    t = vm.dot(e2, qv) * inv
    valid = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > T_MIN)
        & (t < t_cur)
    )
    return valid, t, u, v


def intersect_bvh(scene, o, d, t_max, any_hit: bool = False,
                  time=None) -> Hit:
    """Closest-hit (or any-hit) against the triangle BVH.

    o, d: (N,3); t_max: (N,).  Vectorized stack traversal: every loop
    iteration each live ray visits one node.
    time: optional (N,) in [0,1] — object motion blur: leaf triangles are
    lerped between the two stored keyframes at each ray's time (the
    TransformedPrimitive role, ref: core/primitive.h; BVH bounds cover
    the whole shutter, see scene/device.py).
    """
    N = o.shape[0]
    inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / jnp.where(d == 0, 1.0, d),
                      jnp.where(d >= 0, 1e30, -1e30))
    dir_neg = d < 0.0  # (N,3)

    node0 = jnp.zeros(N, jnp.int32)
    stack0 = jnp.zeros((N, STACK_DEPTH), jnp.int32)
    sp0 = jnp.zeros(N, jnp.int32)
    t0 = t_max
    prim0 = jnp.full(N, -1, jnp.int32)
    b1_0 = jnp.zeros(N, jnp.float32)
    b2_0 = jnp.zeros(N, jnp.float32)

    def cond(state):
        node, _, _, _, _, _, _ = state
        return jnp.any(node >= 0)

    def body(state):
        node, stack, sp, t, prim, b1, b2 = state
        active = node >= 0
        nid = jnp.maximum(node, 0)

        # one contiguous-row gather per step (packed i32 layout; float
        # bounds are bitcast back, so int ids never pass through f32)
        nd = jnp.take(scene.nodes_packed, nid, axis=0)  # (N,8) i32
        nmin = jax.lax.bitcast_convert_type(nd[:, 0:3], jnp.float32)
        nmax = jax.lax.bitcast_convert_type(nd[:, 3:6], jnp.float32)
        nright = nd[:, 6]
        meta = nd[:, 7]
        ncount = meta >> 2
        naxis = meta & 3

        # slab test against [0, t]
        tlo = (nmin - o) * inv_d
        thi = (nmax - o) * inv_d
        tnear = jnp.max(jnp.minimum(tlo, thi), axis=-1)
        tfar = jnp.min(jnp.maximum(tlo, thi), axis=-1)
        tfar = tfar * 1.0000004  # pbrt robustness factor (bvh.cpp gamma(3))
        box_hit = active & (tnear <= tfar) & (tnear < t) & (tfar > 0.0)

        is_leaf = ncount > 0
        leaf_hit = box_hit & is_leaf

        # --- leaf: test up to MAX_LEAF triangles (static unroll) ---
        for k in range(MAX_LEAF):
            pid = nright + k
            m = leaf_hit & (k < ncount)
            pidc = jnp.maximum(pid, 0)
            tr = jnp.take(scene.tris_packed, pidc, axis=0)  # (N,12)
            if time is not None:
                # piecewise-linear over M rotation-correct sub-keyframes
                # (ref: transform.h:412 AnimatedTransform::Interpolate;
                # device.py evaluates the slerp at build time)
                Ms = scene.tris_steps_packed.shape[0]
                Tn = scene.tris_steps_packed.shape[1]
                tf = time * (Ms - 1)
                seg = jnp.clip(tf.astype(jnp.int32), 0, Ms - 2)
                tl = tf - seg.astype(jnp.float32)
                flat_steps = scene.tris_steps_packed.reshape(-1, 12)
                tr0 = jnp.take(flat_steps, seg * Tn + pidc, axis=0)
                tr1 = jnp.take(flat_steps, (seg + 1) * Tn + pidc, axis=0)
                tr = tr0 + tl[:, None] * (tr1 - tr0)
            tv, tt, tu, tvv = _moller(o, d, tr[:, 0:3], tr[:, 3:6],
                                      tr[:, 6:9], t)
            upd = m & tv
            t = jnp.where(upd, tt, t)
            prim = jnp.where(upd, pid, prim)
            b1 = jnp.where(upd, tu, b1)
            b2 = jnp.where(upd, tvv, b2)

        # --- interior: descend near child, push far ---
        go_in = box_hit & (~is_leaf)
        neg = jnp.take_along_axis(dir_neg, naxis[:, None], axis=-1)[:, 0]
        first = nid + 1
        near = jnp.where(neg, nright, first)
        far = jnp.where(neg, first, nright)
        # push far
        push_sp = jnp.minimum(sp, STACK_DEPTH - 1)
        stack = jnp.where(
            go_in[:, None]
            & (jnp.arange(STACK_DEPTH)[None, :] == push_sp[:, None]),
            far[:, None],
            stack,
        )
        sp = jnp.where(go_in, push_sp + 1, sp)

        # --- next node: descend or pop ---
        can_pop = sp > 0
        pop_sp = jnp.maximum(sp - 1, 0)
        popped = jnp.take_along_axis(stack, pop_sp[:, None], axis=-1)[:, 0]
        nxt = jnp.where(
            go_in, near, jnp.where(active & can_pop, popped, -1)
        )
        sp = jnp.where(go_in | ~active, sp, jnp.where(can_pop, pop_sp, sp))

        if any_hit:
            done = prim >= 0
            nxt = jnp.where(done, -1, nxt)

        return nxt, stack, sp, t, prim, b1, b2

    node, stack, sp, t, prim, b1, b2 = jax.lax.while_loop(
        cond, body, (node0, stack0, sp0, t0, prim0, b1_0, b2_0)
    )
    return Hit(t=t, prim=prim, b1=b1, b2=b2, valid=prim >= 0)


def intersect_spheres(scene, o, d, hit: Hit) -> Hit:
    """Brute-force analytic sphere pass, merged with the BVH result.

    Spheres are few (emitters only — ref: src/shapes/sphere.cpp:141
    Intersect); an (N, S) quadratic solve is cheaper than divergent BVH
    entries for them.
    """
    S = scene.sph_center.shape[0]
    T = scene.tri_p0.shape[0]
    oc = o[:, None, :] - scene.sph_center[None, :, :]     # (N,S,3)
    b = jnp.sum(oc * d[:, None, :], axis=-1)              # (N,S)
    # robust discriminant: r^2 - |perpendicular component|^2, computed
    # directly instead of b^2 - (|oc|^2 - r^2).  The difference-of-
    # squares form loses ~|oc|*eps absolute accuracy in f32 — at a
    # shadow-ray distance of ~200 units that is ~0.5 units of t error,
    # enough to push the light sphere INSIDE the 0.999*dist shadow
    # interval and self-occlude ~35% of area-sphere NEE samples
    # (measured on killeroo; the reference solves the same problem with
    # a double-precision quadratic, sphere.cpp:141 Quadratic).
    perp = oc - b[..., None] * d[:, None, :]              # (N,S,3)
    disc = (scene.sph_radius[None, :] ** 2
            - jnp.sum(perp * perp, axis=-1))
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    tc = jnp.where(t0 > T_MIN, t0, t1)
    sph_live = jnp.arange(S)[None, :] < scene.n_spheres
    valid = (disc > 0.0) & (tc > T_MIN) & (tc < hit.t[:, None]) & sph_live
    tc = jnp.where(valid, tc, jnp.inf)
    best = jnp.argmin(tc, axis=-1)                        # (N,)
    best_t = jnp.take_along_axis(tc, best[:, None], axis=-1)[:, 0]
    better = jnp.isfinite(best_t)
    return Hit(
        t=jnp.where(better, best_t, hit.t),
        prim=jnp.where(better, T + best.astype(jnp.int32), hit.prim),
        b1=jnp.where(better, 0.0, hit.b1),
        b2=jnp.where(better, 0.0, hit.b2),
        valid=hit.valid | better,
    )


def default_accel(platform: str = None) -> str:
    """The traversal for a JAX platform: the fused cluster kernel on
    "gpu", the XLA walker ("bvh") on "cpu".  Any other platform is an
    error, never a guess."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "clusters"
    if platform == "cpu":
        return "bvh"
    raise RuntimeError(f"no traversal for JAX platform {platform!r}; "
                       "supported: gpu, cpu")


def intersect(scene, o, d, t_max, any_hit: bool = False,
              accel: str = "bvh", time=None, spheres: bool = True,
              presorted: bool = False) -> Hit:
    """Full scene intersection: aggregate triangles + analytic spheres.

    accel selects the aggregate statically ("bvh" | "kdtree" |
    "clusters", ref: api.cpp MakeAccelerator); "clusters" is the fused
    GPU kernel (ops/clusters_pallas.py) and needs scene.clusters.  time
    enables object motion blur and statically selects the XLA walker
    (the only traversal with the keyframe lerp).  spheres=False
    statically skips the analytic sphere pass (sphere-free scenes).
    presorted: rays arrive coherence-sorted (cluster kernel only)."""
    sph = (intersect_spheres if spheres else
           (lambda scene_, o_, d_, h: h))
    if time is not None:
        hit = intersect_bvh(scene, o, d, t_max, any_hit=any_hit, time=time)
    elif accel == "clusters":
        if scene.clusters is None:
            raise ValueError("accel='clusters' needs a scene built with "
                             "cluster tables (with_clusters=True)")
        from . import clusters_pallas as cluster_lib

        def _fb(os_, ds_, ts_):
            return intersect_bvh(scene, os_, ds_, ts_, any_hit=any_hit)

        hit = cluster_lib.intersect_clusters_fused(
            scene.clusters, o, d, t_max, any_hit=any_hit, fallback=_fb,
            world_min=scene.world_min, world_max=scene.world_max,
            tri_p0=scene.tri_p0, tri_e1=scene.tri_e1,
            tri_e2=scene.tri_e2, presorted=presorted)
    elif accel == "kdtree":
        from . import kdtree as kdlib
        hit = kdlib.intersect_kd(scene, o, d, t_max, any_hit=any_hit)
    else:
        hit = intersect_bvh(scene, o, d, t_max, any_hit=any_hit)
    return sph(scene, o, d, hit)


def occluded(scene, o, d, t_max, accel: str = "bvh", time=None,
             spheres: bool = True, presorted: bool = False) -> jnp.ndarray:
    """Shadow-ray IntersectP equivalent (ref: scene.cpp:56)."""
    return intersect(scene, o, d, t_max, any_hit=True, accel=accel,
                     time=time, spheres=spheres,
                     presorted=presorted).valid


class Interaction(NamedTuple):
    """SurfaceInteraction SoA (ref: src/core/interaction.h)."""
    p: jnp.ndarray        # (N,3) hit position
    ng: jnp.ndarray       # (N,3) geometric normal (unit)
    ns: jnp.ndarray       # (N,3) shading normal (unit)
    uv: jnp.ndarray       # (N,2)
    wo: jnp.ndarray       # (N,3) towards viewer
    mat: jnp.ndarray      # (N,) i32
    light: jnp.ndarray    # (N,) i32 area light id or -1
    valid: jnp.ndarray    # (N,) bool
    face: jnp.ndarray = None  # (N,) i32 ptex face index (ref:
                              # SurfaceInteraction::faceIndex)


def make_interaction(scene, o, d, hit: Hit, time=None) -> Interaction:
    T = scene.tri_p0.shape[0]
    is_sph = hit.prim >= T
    tri_id = jnp.clip(hit.prim, 0, T - 1)
    sph_id = jnp.clip(hit.prim - T, 0, scene.sph_center.shape[0] - 1)

    p = o + hit.t[:, None] * d

    # triangle attributes
    ng_t = jnp.take(scene.tri_ng, tri_id, axis=0)
    ns_tri = jnp.take(scene.tri_ns, tri_id, axis=0)       # (N,3,3)
    if time is not None:
        # motion blur: piecewise-lerp normals over the sub-keyframes
        # (matches the interpolated vertex positions; renormalized
        # below / by face_forward)
        Ms = scene.tri_ng_steps.shape[0]
        Tn = scene.tri_ng_steps.shape[1]
        tf = time * (Ms - 1)
        seg = jnp.clip(tf.astype(jnp.int32), 0, Ms - 2)
        tl = tf - seg.astype(jnp.float32)
        ngf = scene.tri_ng_steps.reshape(-1, 3)
        nsf = scene.tri_ns_steps.reshape(-1, 3, 3)
        ng_0 = jnp.take(ngf, seg * Tn + tri_id, axis=0)
        ng_e = jnp.take(ngf, (seg + 1) * Tn + tri_id, axis=0)
        ns_0 = jnp.take(nsf, seg * Tn + tri_id, axis=0)
        ns_e = jnp.take(nsf, (seg + 1) * Tn + tri_id, axis=0)
        ng_t = vm.normalize(ng_0 + tl[:, None] * (ng_e - ng_0))
        ns_tri = ns_0 + tl[:, None, None] * (ns_e - ns_0)
    b0 = 1.0 - hit.b1 - hit.b2
    ns_t = (
        b0[:, None] * ns_tri[:, 0]
        + hit.b1[:, None] * ns_tri[:, 1]
        + hit.b2[:, None] * ns_tri[:, 2]
    )
    ns_len = vm.length(ns_t)
    ns_t = jnp.where((ns_len > 1e-8)[:, None], ns_t / jnp.maximum(ns_len, 1e-8)[:, None], ng_t)
    # shading normal must agree with geometric side (ref: triangle.cpp:
    # shading frame alignment)
    uv_tri = jnp.take(scene.tri_uv, tri_id, axis=0)       # (N,3,2)
    uv_t = (
        b0[:, None] * uv_tri[:, 0]
        + hit.b1[:, None] * uv_tri[:, 1]
        + hit.b2[:, None] * uv_tri[:, 2]
    )
    mat_t = jnp.take(scene.tri_mat, tri_id)
    light_t = jnp.take(scene.tri_light, tri_id)

    # sphere attributes
    ctr = jnp.take(scene.sph_center, sph_id, axis=0)
    ng_s = vm.normalize(p - ctr)
    uv_s = jnp.stack(
        [vm.spherical_phi(ng_s) / (2 * jnp.pi),
         vm.spherical_theta(ng_s) / jnp.pi], axis=-1)
    mat_s = jnp.take(scene.sph_mat, sph_id)
    light_s = jnp.take(scene.sph_light, sph_id)

    is_sph3 = is_sph[:, None]
    ng = jnp.where(is_sph3, ng_s, ng_t)
    ns = jnp.where(is_sph3, ng_s, ns_t)
    return Interaction(
        p=p,
        ng=ng,
        ns=ns,
        uv=jnp.where(is_sph[:, None], uv_s, uv_t),
        wo=-d,
        mat=jnp.where(is_sph, mat_s, mat_t),
        light=jnp.where(is_sph, light_s, light_t),
        valid=hit.valid,
        face=jnp.where(
            is_sph, 0,
            jnp.take(scene.tri_face,
                     jnp.clip(tri_id, 0, scene.tri_face.shape[0] - 1))),
    )
