"""Fused cluster-traversal kernel tests (ops/clusters_pallas.py, the
Pallas kernel on the Triton route) in interpret mode, vs float64 brute
force and the XLA walker; plus its lowering for CUDA, which needs no
card.  Ref role: accelerators/bvh.cpp:662 Intersect / :702 IntersectP."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrt_v3_iile_tpu.ops import bvh as bvhlib
from pbrt_v3_iile_tpu.ops import clusters_pallas as cpl
from pbrt_v3_iile_tpu.ops import intersect as isect

from test_clusters import _random_soup, _brute_force


def _build(rng, T, scale=1.0):
    p0, e1, e2 = _random_soup(rng, T, scale)
    tri = np.stack([p0, p0 + e1, p0 + e2], axis=1)
    flat = bvhlib.build_bvh(tri, use_native=False)
    op0 = p0[flat.prim_order]
    oe1 = e1[flat.prim_order]
    oe2 = e2[flat.prim_order]
    cp = cpl.build_cluster_pack(flat, op0, oe1, oe2)
    return cp, op0, oe1, oe2


def _rays(rng, N):
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_pack_build_partitions_triangles():
    rng = np.random.default_rng(3)
    cp, *_ = _build(rng, 700)
    off = np.asarray(cp.tri_off)
    cnt = np.asarray(cp.tri_cnt)
    covered = np.zeros(700, bool)
    for o, c in zip(off, cnt):
        assert c <= cpl.C
        assert not covered[o:o + c].any()
        covered[o:o + c] = True
    assert covered.all()
    assert cp.feat.shape[1:] == (cpl.NRS, cpl.C)
    # feature sanity: the plane-normal rows (18:21) of cluster 0 /
    # slot 0 hold the geometric normal of the first BVH-ordered triangle
    cp2, op0, oe1, oe2 = _build(np.random.default_rng(3), 700)
    n_true = np.cross(oe1[np.asarray(cp2.tri_off)[0]],
                      oe2[np.asarray(cp2.tri_off)[0]])
    np.testing.assert_allclose(
        np.asarray(cp2.feat[0, 18:21, 0]), n_true, rtol=1e-5)


@pytest.mark.parametrize("T,N,group", [(300, 640, 32), (2000, 1280, 64),
                                       (500, 1000, 16)])
def test_fused_matches_brute_force(T, N, group):
    """Closest hits against the float64 brute force; N = 1000 with
    group 16 exercises the padded last group."""
    rng = np.random.default_rng(T + N)
    cp, op0, oe1, oe2 = _build(rng, T)
    o, d = _rays(rng, N)
    t_max = jnp.full((N,), 1e30)
    hit = cpl.intersect_clusters_fused(
        cp, o, d, t_max, group=group, max_candidates=64, interpret=True,
        tri_p0=jnp.asarray(op0), tri_e1=jnp.asarray(oe1),
        tri_e2=jnp.asarray(oe2))
    assert hit.t.shape == (N,) and hit.prim.dtype == jnp.int32
    t_ref, prim_ref = _brute_force(op0, oe1, oe2, np.asarray(o),
                                   np.asarray(d), np.asarray(t_max))
    t = np.asarray(hit.t)
    prim = np.asarray(hit.prim)
    agree = np.isclose(t, t_ref, rtol=2e-3, atol=1e-4)
    frac = agree.mean()
    assert frac > 0.995, f"hit-t agreement only {frac:.3f}"
    hit_agree = (prim >= 0) == (prim_ref >= 0)
    assert hit_agree.mean() > 0.995


def test_fused_dead_rays_and_anyhit():
    rng = np.random.default_rng(11)
    cp, op0, oe1, oe2 = _build(rng, 400)
    o, d = _rays(rng, 512)
    t_max = jnp.where(jnp.arange(512) % 2 == 0, 1e30, -1.0)
    hit = cpl.intersect_clusters_fused(cp, o, d, t_max,
                                       max_candidates=64, interpret=True)
    dead = np.asarray(t_max) < 0
    assert not np.asarray(hit.valid)[dead].any(), "dead rays must miss"
    any_hit = cpl.intersect_clusters_fused(cp, o, d, t_max,
                                           max_candidates=64, any_hit=True,
                                           interpret=True)
    # any-hit validity must match closest-hit validity
    np.testing.assert_array_equal(np.asarray(any_hit.valid),
                                  np.asarray(hit.valid))


def test_fused_barycentrics_reconstruct_point():
    rng = np.random.default_rng(5)
    cp, op0, oe1, oe2 = _build(rng, 500)
    o, d = _rays(rng, 512)
    t_max = jnp.full((512,), 1e30)
    hit = cpl.intersect_clusters_fused(
        cp, o, d, t_max, max_candidates=64, interpret=True,
        tri_p0=jnp.asarray(op0), tri_e1=jnp.asarray(oe1),
        tri_e2=jnp.asarray(oe2))
    v = np.asarray(hit.valid)
    assert v.any()
    prim = np.asarray(hit.prim)[v]
    b1 = np.asarray(hit.b1)[v]
    b2 = np.asarray(hit.b2)[v]
    t = np.asarray(hit.t)[v]
    p_hit = np.asarray(o)[v] + t[:, None] * np.asarray(d)[v]
    p_tri = (op0[prim] + b1[:, None] * oe1[prim] + b2[:, None] * oe2[prim])
    err = np.linalg.norm(p_hit - p_tri, axis=1)
    assert np.quantile(err, 0.95) < 5e-3


def test_fused_overflow_fallback():
    """Tiny max_candidates forces overflow; fallback must keep results
    exact (here: brute force as the fallback oracle)."""
    rng = np.random.default_rng(9)
    cp, op0, oe1, oe2 = _build(rng, 1500)
    o, d = _rays(rng, 256)
    t_max = jnp.full((256,), 1e30)

    P0, E1, E2 = (jnp.asarray(x) for x in (op0, oe1, oe2))

    def fb(os_, ds_, ts_):
        # jittable all-pairs Moller oracle (runs inside lax.cond)
        pv = jnp.cross(ds_[:, None], E2[None])
        det = jnp.sum(E1[None] * pv, -1)
        inv = jnp.where(jnp.abs(det) > 1e-12,
                        1.0 / jnp.where(det == 0, 1.0, det), 0.0)
        tv = os_[:, None] - P0[None]
        u = jnp.sum(tv * pv, -1) * inv
        qv = jnp.cross(tv, E1[None])
        v = jnp.sum(ds_[:, None] * qv, -1) * inv
        t = jnp.sum(E2[None] * qv, -1) * inv
        ok = ((jnp.abs(det) > 1e-12) & (u >= 0) & (v >= 0)
              & (u + v <= 1) & (t > 1e-5) & (t < ts_[:, None]))
        t = jnp.where(ok, t, jnp.inf)
        j = jnp.argmin(t, axis=1)
        tb = jnp.take_along_axis(t, j[:, None], 1)[:, 0]
        hitv = jnp.isfinite(tb)
        return isect.Hit(t=jnp.where(hitv, tb, ts_),
                         prim=jnp.where(hitv, j, -1).astype(jnp.int32),
                         b1=jnp.take_along_axis(u, j[:, None], 1)[:, 0],
                         b2=jnp.take_along_axis(v, j[:, None], 1)[:, 0],
                         valid=hitv)

    hit = cpl.intersect_clusters_fused(cp, o, d, t_max, group=64,
                                       max_candidates=2, break_every=2,
                                       fallback=fb, interpret=True)
    t_ref, prim_ref = _brute_force(op0, oe1, oe2, np.asarray(o),
                                   np.asarray(d), np.asarray(t_max))
    agree = np.isclose(np.asarray(hit.t), t_ref, rtol=2e-3, atol=1e-4)
    assert agree.mean() > 0.99


_SCENE = """
LookAt 0 1.5 -5  0 1 0  0 1 0
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [24] "integer yresolution" [24]
WorldBegin
LightSource "point" "color I" [10 10 10] "point from" [0 3 -1]
Material "matte" "color Kd" [0.6 0.3 0.2]
Shape "trianglemesh" "point P" [-5 0 -5 5 0 -5 5 0 5 -5 0 5]
  "integer indices" [0 1 2 2 3 0]
Shape "sphere" "float radius" [0.7]
Translate 1 0.5 0
Shape "trianglemesh" "point P" [-1 0 -1 1 0 -1 0 2 0 0 0 1]
  "integer indices" [0 1 2 1 3 2 3 0 2 0 3 1]
WorldEnd
"""


@pytest.mark.parametrize("any_hit", [False, True])
def test_fused_matches_walker_on_device_scene(any_hit):
    """The kernel on a device scene's own cluster tables agrees with the
    XLA walker, prim ids included (both index BVH-ordered triangles)."""
    from pbrt_v3_iile_tpu.scene import api as apilib
    from pbrt_v3_iile_tpu.scene import device as devlib

    sd = apilib.load_scene_string(_SCENE)
    scene = devlib.build_device_scene(sd, use_native_bvh=False,
                                      with_clusters=True)
    rng = np.random.default_rng(2)
    o = jnp.asarray(rng.uniform(-3, 3, (600, 3)).astype(np.float32)
                    + np.array([0, 2, 0], np.float32))
    d = rng.normal(size=(600, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    tm = jnp.full((600,), 1e30).at[::7].set(-1.0)
    ref = isect.intersect_bvh(scene, o, d, tm, any_hit=any_hit)
    got = cpl.intersect_clusters_fused(
        scene.clusters, o, d, tm, any_hit=any_hit, interpret=True,
        world_min=scene.world_min, world_max=scene.world_max,
        tri_p0=scene.tri_p0, tri_e1=scene.tri_e1, tri_e2=scene.tri_e2,
        fallback=lambda a, b, c: isect.intersect_bvh(scene, a, b, c,
                                                     any_hit=any_hit))
    rv, gv = np.asarray(ref.valid), np.asarray(got.valid)
    assert rv.any() and (rv == gv).mean() > 0.995
    if not any_hit:
        both = rv & gv
        np.testing.assert_allclose(np.asarray(got.t)[both],
                                   np.asarray(ref.t)[both], rtol=1e-4)
        assert (np.asarray(got.prim) == np.asarray(ref.prim))[both].mean() \
            > 0.99


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_lowers_for_cuda(any_hit):
    """The kernel lowers to a Triton call for CUDA (the production route)
    without a card: lowering runs in Python; only PTX needs the GPU."""
    K, Np, G, maxc = 40, 1024, cpl.G_DEFAULT, 8
    Gn = Np // G
    args = (jnp.zeros((K, cpl.NRS, cpl.C)), jnp.zeros((cpl.NF, Np)),
            jnp.zeros((Np,)), jnp.zeros((Gn, maxc), jnp.int32),
            jnp.zeros((Gn, maxc), jnp.int32), jnp.zeros((Gn, maxc)),
            jnp.zeros((Gn,), jnp.int32))
    f = jax.jit(lambda *a: cpl._run_kernel(*a, G=G, bk=4, any_hit=any_hit,
                                           interpret=False))
    text = f.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" in text
