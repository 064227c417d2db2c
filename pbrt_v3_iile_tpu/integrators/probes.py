"""Hemispherical probe rendering: batched G-buffer generation.

Wavefront replacement for IISPTdIntegrator::RenderView (ref:
src/integrators/iispt_d.cpp:226-461 + Li at :66-224): instead of one
32x32 film rendered single-threaded per probe, a batch of P probes is one
wavefront of P*32*32 rays traced by the shared path integrator with probe
semantics (maxDepth=3 hard-coded as iispt_d.cpp:505, NEE each bounce, no
emitted light at bounce 0 — iispt_d.cpp:116-133) while bounce-0 distance
and camera-space normals are captured (iispt_d.cpp:98-113).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import camera as camlib
from ..ops import samplers as smplr
from ..utils import vecmath as vm
from . import path as pathlib_

HIGHEST = jax.lax.Precision.HIGHEST  # no TF32 in geometry transforms
NO_INTERSECTION_DISTANCE = -1.0  # (ref: iispt_d.cpp:50)
PROBE_MAX_DEPTH = 3              # (ref: iispt_d.cpp:505)


class ProbeGBuffer(NamedTuple):
    intensity: jnp.ndarray   # (P, H, W, 3) radiance (direct+short indirect)
    normals: jnp.ndarray     # (P, H, W, 3) camera-space normals
    distance: jnp.ndarray    # (P, H, W, 1) hit distance (-1 = miss)
    right: jnp.ndarray       # (P, 3) probe camera frame
    up: jnp.ndarray          # (P, 3)
    look: jnp.ndarray        # (P, 3)
    origin: jnp.ndarray      # (P, 3)


def render_probes(scene, positions, normals, key, hemi_size: int = 32,
                  jitter: bool = True, accel: str = "bvh") -> ProbeGBuffer:
    """positions, normals: (P, 3) world-space probe anchors (the normal is
    the already-flipped outward surface normal, ref
    iisptrenderrunner.cpp:300-312)."""
    P = positions.shape[0]
    Hs = hemi_size
    right, up, look = camlib.hemi_frames(positions, normals)

    jit_u = None
    if jitter:
        kj = smplr.wave_key(key, 0, 0, smplr.DIM_HEMI)
        jit_u = smplr.uniform(kj, (P, Hs, Hs, 2))
    o, d = camlib.hemi_generate_rays(positions, normals, Hs, jit_u)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    # offset along the probe normal to avoid re-hitting the anchor surface
    n_rep = jnp.repeat(normals, Hs * Hs, axis=0)
    o = vm.offset_ray_origin(o, n_rep, d)

    cfg = pathlib_.PathConfig(
        max_depth=PROBE_MAX_DEPTH,
        nee=True,
        skip_bounce0_le=True,
        accel=accel,
    )
    kp = smplr.wave_key(key, 0, 0, smplr.DIM_PROBE)
    L, aux = pathlib_.trace_paths(scene, o, d, kp, cfg, collect_aux=True)

    intensity = L.reshape(P, Hs, Hs, 3)
    dist = aux["distance"].reshape(P, Hs, Hs, 1)
    n_world = aux["normal"].reshape(P, Hs, Hs, 3)
    # camera-space normal (ref: iispt_d.cpp:105-107 WorldToCamera applied)
    n_cam = jnp.stack(
        [
            jnp.einsum("phwc,pc->phw", n_world, right, precision=HIGHEST),
            jnp.einsum("phwc,pc->phw", n_world, up, precision=HIGHEST),
            jnp.einsum("phwc,pc->phw", n_world, look, precision=HIGHEST),
        ],
        axis=-1,
    )
    return ProbeGBuffer(
        intensity=intensity, normals=n_cam, distance=dist,
        right=right, up=up, look=look, origin=positions,
    )


def find_first_nonspecular(scene, o, d, key, max_chase: int = 24,
                           accel: str = "bvh"):
    """Specular chase: follow mirror/glass bounces to the first diffuse
    hit, to the reference's full 24-bounce depth
    (ref: iisptrenderrunner.cpp:657-757 find_intersection).

    Returns dict: found (N,), p, n (outward, flipped against ray), wo,
    mat (N,), beta (N,3), background (N,3), emitted (N,3).
    """
    import jax

    N = o.shape[0]
    carry0 = (
        o, d, jnp.ones((N, 3), jnp.float32), jnp.ones(N, bool),
        jnp.zeros(N, bool), jnp.zeros((N, 3), jnp.float32),
        jnp.zeros((N, 3), jnp.float32), jnp.zeros((N, 3), jnp.float32),
        jnp.zeros(N, jnp.int32), jnp.zeros((N, 2), jnp.float32),
        jnp.zeros((N, 3), jnp.float32), jnp.zeros((N, 3), jnp.float32),
    )
    carry, _ = jax.lax.scan(
        lambda c, i: (_chase_body(scene, c, i, key, accel), None),
        carry0, jnp.arange(max_chase))
    (o, d, beta, alive, found, p, n, wo, mat, uv, background,
     emitted) = carry
    return dict(found=found, p=p, n=n, wo=wo, mat=mat, uv=uv, beta=beta,
                background=background, emitted=emitted)


def _chase_body(scene, carry, i, key, accel: str = "bvh"):
    import jax

    from ..ops import bsdf as bsdflib
    from ..ops import intersect as isect
    from ..ops import lights as lightlib
    from ..scene.api import MAT_MIRROR, MAT_GLASS

    if True:
        (o, d, beta, alive, found, p, n, wo, mat, uv, background,
         emitted) = carry
        N = o.shape[0]
        t_max = jnp.where(alive, 1e30, -1.0)
        hit = isect.intersect(scene, o, d, t_max, accel=accel)
        it = isect.make_interaction(scene, o, d, hit)

        esc = alive & (~hit.valid)
        background = jnp.where(
            esc[:, None],
            beta * lightlib.environment_le(scene, d), background)
        # emitted along the specular chain (iisptrenderrunner.cpp:690-694)
        lid = jnp.maximum(it.light, 0)
        le = lightlib.area_light_le(scene, lid, it.ng, it.wo)
        emitted = emitted + jnp.where(
            (alive & hit.valid & (it.light >= 0))[:, None], beta * le, 0.0)

        params = bsdflib.gather_params(scene, jnp.maximum(it.mat, 0),
                                       uv=it.uv, p=it.p)
        is_spec = (params.kind == MAT_MIRROR) | (params.kind == MAT_GLASS)
        stop_here = alive & hit.valid & (~is_spec)

        # record first non-specular hit
        n_out = vm.face_forward(it.ng, -d)
        p = jnp.where(stop_here[:, None], it.p, p)
        n = jnp.where(stop_here[:, None], n_out, n)
        wo = jnp.where(stop_here[:, None], it.wo, wo)
        mat = jnp.where(stop_here, it.mat, mat)
        uv = jnp.where(stop_here[:, None], it.uv, uv)
        found = found | stop_here

        # follow specular bounce
        cont = alive & hit.valid & is_spec
        ns = vm.face_forward(it.ns, it.ng)
        t_f, b_f = vm.coordinate_system(ns)
        wo_l = vm.to_local(it.wo, t_f, b_f, ns)
        ku = smplr.wave_key(key, 1, i, smplr.DIM_BSDF_LOBE)
        u_lobe = smplr.uniform(ku, (N,))
        kd2 = smplr.wave_key(key, 1, i, smplr.DIM_BSDF_DIR)
        u_dir = smplr.uniform(kd2, (N, 2))
        bs = bsdflib.sample(params, wo_l, u_lobe, u_dir)
        wi_w = vm.to_world(bs.wi, t_f, b_f, ns)
        cos_w = vm.absdot(wi_w, ns)
        beta_new = beta * bs.f * (cos_w / jnp.maximum(bs.pdf, 1e-12))[:, None]
        ok = cont & bs.valid
        beta = jnp.where(ok[:, None], beta_new, beta)
        o = jnp.where(ok[:, None],
                      vm.offset_ray_origin(it.p, n_out, wi_w), o)
        d = jnp.where(ok[:, None], wi_w, d)
        alive = ok
        return (o, d, beta, alive, found, p, n, wo, mat, uv, background,
                emitted)
