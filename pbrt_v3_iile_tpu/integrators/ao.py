"""Ambient occlusion integrator (ref: src/integrators/ao.cpp AOIntegrator):
cosine- or uniform-sampled hemisphere visibility at the first hit.
One occlusion sample per pass; the render driver's pass loop provides
progressive accumulation (the reference takes nsamples in one go)."""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import intersect as isect
from ..ops import samplers as smplr
from ..ops import sampling as smp
from ..utils import vecmath as vm


def trace_ao(scene, o, d, key, cos_sample: bool = True):
    N = o.shape[0]
    t_max = jnp.full(N, 1e30, jnp.float32)
    hit = isect.intersect(scene, o, d, t_max)
    it = isect.make_interaction(scene, o, d, hit)

    n = vm.face_forward(it.ng, -d)
    t_f, b_f = vm.coordinate_system(n)
    u = smplr.uniform(smplr.wave_key(key, 0, 0, smplr.DIM_BSDF_DIR), (N, 2))
    if cos_sample:
        w_local = smp.cosine_sample_hemisphere(u)
    else:
        w_local = smp.uniform_sample_hemisphere(u)
    wi = vm.to_world(w_local, t_f, b_f, n)
    o_sh = vm.offset_ray_origin(it.p, n, wi)
    occ = isect.occluded(scene, o_sh, wi, t_max)
    # estimator: cossample -> v*cos/(cos/pi)/pi = v;
    # uniform -> v*cos/(1/2pi)/pi = 2*v*cos (ref: ao.cpp:101-118)
    cosw = jnp.abs(w_local[..., 2])
    val = jnp.where(cos_sample, 1.0, 2.0 * cosw)
    L = jnp.where(hit.valid & (~occ), val, 0.0)
    return jnp.repeat(L[:, None], 3, axis=-1)
