"""Intersection correctness: wavefront BVH traversal and the Pallas
packet kernel vs brute force (coverage model: the reference has no BVH
unit test — this is stronger)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrt_v3_iile_tpu.scene import api as apilib, device as devlib
from pbrt_v3_iile_tpu.ops import intersect as isect


@pytest.fixture(scope="module")
def tri_scene():
    sd = apilib.SceneDesc()
    rng = np.random.default_rng(0)
    v0 = rng.uniform(-5, 5, (800, 3))
    e = rng.uniform(-0.4, 0.4, (800, 2, 3))
    tris = np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1).astype(np.float32)
    sd.add_triangles(tris, None, None, 0)
    return devlib.build_device_scene(sd), tris


def _brute(tris, o1, d1):
    p0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    pv = np.cross(d1, e2)
    det = (e1 * pv).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(np.abs(det) > 1e-12, 1 / det, 0)
        tv = o1 - p0
        u = (tv * pv).sum(-1) * inv
        qv = np.cross(tv, e1)
        v = (d1 * qv).sum(-1) * inv
        t = (e2 * qv).sum(-1) * inv
    ok = (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
    t = np.where(ok, t, np.inf)
    i = int(np.argmin(t))
    return (float(t[i]), i) if np.isfinite(t[i]) else (None, -1)


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 8.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_bvh_matches_brute_force(tri_scene):
    scene, tris = tri_scene
    o, d = _rays(256)
    tmax = jnp.full(256, 1e30, jnp.float32)
    hit = jax.jit(lambda s, o, d, t: isect.intersect_bvh(s, o, d, t))(
        scene, jnp.asarray(o), jnp.asarray(d), tmax)
    ht = np.asarray(hit.t)
    hp = np.asarray(hit.prim)
    for i in range(64):
        bt, _ = _brute(tris, o[i], d[i])
        if bt is None:
            assert hp[i] == -1
        else:
            assert hp[i] >= 0
            assert abs(ht[i] - bt) < 1e-3 * max(1.0, bt)


def test_anyhit_occlusion(tri_scene):
    scene, tris = tri_scene
    o, d = _rays(256, seed=3)
    tmax = jnp.full(256, 1e30, jnp.float32)
    occ = np.asarray(isect.occluded(scene, jnp.asarray(o), jnp.asarray(d),
                                    tmax))
    closest = np.asarray(
        isect.intersect_bvh(scene, jnp.asarray(o), jnp.asarray(d),
                            tmax).valid)
    assert (occ == closest).all()  # same visibility, any order


def test_sphere_pass():
    sd = apilib.SceneDesc()
    sd.spheres.append(dict(center=np.array([0.0, 0.0, 0.0]), radius=1.0,
                           mat=0, light=0))
    # one dummy triangle far away
    tri = np.array([[[100, 100, 100], [101, 100, 100], [100, 101, 100]]],
                   np.float32)
    sd.add_triangles(tri, None, None, 0)
    scene = devlib.build_device_scene(sd)
    o = jnp.array([[0.0, 0.0, 5.0], [3.0, 0.0, 5.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    hit = isect.intersect(scene, o, d, jnp.full(2, 1e30))
    it = isect.make_interaction(scene, o, d, hit)
    assert bool(hit.valid[0]) and not bool(hit.valid[1])
    assert abs(float(hit.t[0]) - 4.0) < 1e-4
    assert np.allclose(np.asarray(it.ng[0]), [0, 0, 1], atol=1e-5)
    assert int(it.light[0]) == 0
