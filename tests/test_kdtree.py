"""kd-tree accelerator tests (ref: src/accelerators/kdtreeaccel.cpp) —
the kd walker must agree with the BVH walker ray-for-ray."""

import numpy as np
import jax.numpy as jnp

from pbrt_v3_iile_tpu.scene import api as apilib
from pbrt_v3_iile_tpu.scene import device as devlib
from pbrt_v3_iile_tpu.ops import intersect as isect
from pbrt_v3_iile_tpu.ops import kdtree as kdlib


def _random_soup_scene(n_tris=120, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, (n_tris, 1, 3))
    v = c + rng.uniform(-0.4, 0.4, (n_tris, 3, 3))
    tris = " ".join(str(float(x)) for x in v.reshape(-1))
    idx = " ".join(str(i) for i in range(3 * n_tris))
    return f"""
    LookAt 0 0 -6  0 0 0  0 1 0
    Camera "perspective" "float fov" [60]
    Film "image" "integer xresolution" [32] "integer yresolution" [32]
    Integrator "path" "integer maxdepth" [2]
    %s
    WorldBegin
    LightSource "point" "color I" [50 50 50] "point from" [0 4 -4]
    Material "matte" "color Kd" [0.6 0.5 0.4]
    Shape "trianglemesh" "point P" [{tris}] "integer indices" [{idx}]
    WorldEnd
    """


def test_kd_matches_bvh_hits():
    """Closest-hit parity on random rays over a random triangle soup."""
    sd = apilib.load_scene_string(_random_soup_scene() % "")
    sd.accelerator = "kdtree"
    scene = devlib.build_device_scene(sd, use_native_bvh=False)

    rng = np.random.default_rng(3)
    N = 4096
    o = jnp.asarray(rng.uniform(-4, 4, (N, 3)), jnp.float32)
    d = rng.normal(size=(N, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True),
                    jnp.float32)
    t_max = jnp.full(N, 1e30, jnp.float32)

    hb = isect.intersect(scene, o, d, t_max)
    hk = kdlib.intersect_kd(scene, o, d, t_max)
    hk = isect.intersect_spheres(scene, o, d, hk)

    assert np.array_equal(np.asarray(hb.valid), np.asarray(hk.valid))
    m = np.asarray(hb.valid)
    np.testing.assert_allclose(np.asarray(hb.t)[m], np.asarray(hk.t)[m],
                               rtol=1e-4, atol=1e-5)
    # same primitive except exact-tie cases
    same = (np.asarray(hb.prim)[m] == np.asarray(hk.prim)[m])
    assert same.mean() > 0.999


def test_kd_any_hit_matches():
    sd = apilib.load_scene_string(_random_soup_scene(seed=7) % "")
    sd.accelerator = "kdtree"
    scene = devlib.build_device_scene(sd, use_native_bvh=False)
    rng = np.random.default_rng(11)
    N = 2048
    o = jnp.asarray(rng.uniform(-4, 4, (N, 3)), jnp.float32)
    d = rng.normal(size=(N, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True),
                    jnp.float32)
    t_max = jnp.full(N, 6.0, jnp.float32)
    ob = isect.occluded(scene, o, d, t_max)
    ok = isect.occluded(scene, o, d, t_max, accel="kdtree")
    assert np.array_equal(np.asarray(ob), np.asarray(ok))


def test_kdtree_render_matches_bvh():
    """End-to-end: Accelerator \"kdtree\" renders the same image as the
    BVH (same sampler streams => identical MC estimates)."""
    from pbrt_v3_iile_tpu.integrators import render as renderlib

    sd_b = apilib.load_scene_string(_random_soup_scene(n_tris=40) % "")
    sd_k = apilib.load_scene_string(
        _random_soup_scene(n_tris=40) % 'Accelerator "kdtree"')
    assert sd_k.accelerator == "kdtree"
    img_b, _ = renderlib.render(sd_b, spp=2, use_native_bvh=False)
    img_k, _ = renderlib.render(sd_k, spp=2, use_native_bvh=False)
    np.testing.assert_allclose(np.asarray(img_k), np.asarray(img_b),
                               rtol=2e-3, atol=2e-4)


def test_build_covers_all_prims():
    rng = np.random.default_rng(5)
    T = 200
    p0 = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    e1 = rng.uniform(-0.2, 0.2, (T, 3)).astype(np.float32)
    e2 = rng.uniform(-0.2, 0.2, (T, 3)).astype(np.float32)
    kd = kdlib.build_kdtree(p0, e1, e2)
    # every triangle appears in at least one leaf
    assert set(np.unique(kd.prims)) == set(range(T))
    # leaves' counts are consistent with the prim array
    leaf = (kd.meta & 3) == 3
    counts = kd.meta[leaf] >> 2
    offs = kd.offset[leaf]
    assert int((offs + counts).max()) <= kd.prims.shape[0]
