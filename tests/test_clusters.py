"""Dense cluster intersection tests (ops/clusters.py, the plain-XLA
reference of the GPU cluster kernel; ref role: accelerators/bvh.cpp:662
+ triangle.cpp:188)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from pbrt_v3_iile_tpu.ops import bvh as bvhlib
from pbrt_v3_iile_tpu.ops import clusters as cllib


def _random_soup(rng, T, scale=1.0):
    p0 = rng.uniform(-1, 1, (T, 3)) * scale
    e1 = rng.uniform(-0.4, 0.4, (T, 3)) * scale
    e2 = rng.uniform(-0.4, 0.4, (T, 3)) * scale
    return (p0.astype(np.float32), e1.astype(np.float32),
            e2.astype(np.float32))


def _brute_force(p0, e1, e2, o, d, t_max):
    """Reference Moller-Trumbore, all pairs, float64."""
    o = o[:, None].astype(np.float64)
    d = d[:, None].astype(np.float64)
    p0, e1, e2 = (x[None].astype(np.float64) for x in (p0, e1, e2))
    pv = np.cross(d, e2)
    det = (e1 * pv).sum(-1)
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tv = o - p0
    u = (tv * pv).sum(-1) * inv
    qv = np.cross(tv, e1)
    v = (d * qv).sum(-1) * inv
    t = (e2 * qv).sum(-1) * inv
    ok = ((np.abs(det) > 1e-12) & (u >= -1e-7) & (v >= -1e-7)
          & (u + v <= 1 + 1e-7) & (t > 1e-5) & (t < t_max[:, None]))
    t = np.where(ok, t, np.inf)
    j = np.argmin(t, axis=1)
    tb = t[np.arange(len(j)), j]
    return np.where(np.isfinite(tb), tb, t_max), \
        np.where(np.isfinite(tb), j, -1)


def test_subtree_cut_covers_all_triangles():
    rng = np.random.default_rng(0)
    p0, e1, e2 = _random_soup(rng, 500)
    tri = np.stack([p0, p0 + e1, p0 + e2], axis=1)
    flat = bvhlib.build_bvh(tri, use_native=False)
    cs = cllib.build_clusters(flat, p0[flat.prim_order],
                              e1[flat.prim_order], e2[flat.prim_order])
    off = np.asarray(cs.tri_off)
    cnt = np.asarray(cs.tri_cnt)
    covered = np.zeros(500, bool)
    for o, c in zip(off, cnt):
        assert c <= cllib.CLUSTER_SIZE
        assert not covered[o:o + c].any(), "overlapping clusters"
        covered[o:o + c] = True
    assert covered.all(), "clusters must partition the triangle range"


def test_dense_cluster_intersection_matches_brute_force():
    rng = np.random.default_rng(1)
    T = 300
    p0, e1, e2 = _random_soup(rng, T)
    tri = np.stack([p0, p0 + e1, p0 + e2], axis=1)
    flat = bvhlib.build_bvh(tri, use_native=False)
    op = flat.prim_order
    p0o, e1o, e2o = p0[op], e1[op], e2[op]
    cs = cllib.build_clusters(flat, p0o, e1o, e2o)

    N = 256
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(N, 1e30, np.float32)

    t, prim, b1, b2, valid = cllib.intersect_clusters_dense(
        cs, jnp.arange(cs.aabb_min.shape[0]), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max))
    t, prim, valid = np.asarray(t), np.asarray(prim), np.asarray(valid)
    b1, b2 = np.asarray(b1), np.asarray(b2)

    t_ref, j_ref = _brute_force(p0o, e1o, e2o, o, d, t_max)
    hit_ref = j_ref >= 0
    # hit/miss agreement (tiny tolerance band at silhouettes)
    agree = (valid == hit_ref)
    assert agree.mean() > 0.99, f"hit agreement {agree.mean():.3f}"
    both = valid & hit_ref & agree
    assert np.allclose(t[both], t_ref[both], rtol=2e-3, atol=2e-4)
    # same triangle (or an equally-near duplicate)
    same = prim[both] == j_ref[both]
    close_t = np.abs(t[both] - t_ref[both]) < 1e-3
    assert (same | close_t).mean() > 0.999
    # barycentrics reconstruct the hit point
    sel = np.where(both)[0][:50]
    hp = o[sel] + t[sel, None] * d[sel]
    hp2 = (p0o[prim[sel]] + b1[sel, None] * e1o[prim[sel]]
           + b2[sel, None] * e2o[prim[sel]])
    assert np.allclose(hp, hp2, atol=5e-3), np.abs(hp - hp2).max()


def test_cluster_culling_aabbs_are_tight():
    rng = np.random.default_rng(2)
    p0, e1, e2 = _random_soup(rng, 200)
    tri = np.stack([p0, p0 + e1, p0 + e2], axis=1)
    flat = bvhlib.build_bvh(tri, use_native=False)
    op = flat.prim_order
    cs = cllib.build_clusters(flat, p0[op], e1[op], e2[op])
    amin = np.asarray(cs.aabb_min)
    amax = np.asarray(cs.aabb_max)
    off, cnt = np.asarray(cs.tri_off), np.asarray(cs.tri_cnt)
    verts = np.stack([p0[op], p0[op] + e1[op], p0[op] + e2[op]], 1)
    for k in range(cs.aabb_min.shape[0]):
        v = verts[off[k]:off[k] + cnt[k]].reshape(-1, 3)
        assert (v >= amin[k] - 1e-5).all() and (v <= amax[k] + 1e-5).all()


ATRIUM = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes", "atrium.pbrt")


def _atrium_clusters():
    """The atrium's device scene (triangles in BVH order) + a cluster
    set cut from a BVH over those same triangles."""
    from pbrt_v3_iile_tpu.scene import api as apilib
    from pbrt_v3_iile_tpu.integrators import render as renderlib

    sd = apilib.load_scene(ATRIUM)
    scene, cam = renderlib.build(sd)
    p0, e1, e2 = (np.asarray(a) for a in (scene.tri_p0, scene.tri_e1,
                                          scene.tri_e2))
    flat = bvhlib.build_bvh(np.stack([p0, p0 + e1, p0 + e2], axis=1))
    op = flat.prim_order
    cs = cllib.build_clusters(flat, p0[op], e1[op], e2[op])
    return sd, scene, cam, cs


def test_atrium_clusters_match_bvh_walker():
    """Full-scene check: dense cluster intersection reproduces the XLA
    BVH walker's hits on the atrium interior (99k triangles)."""
    from pbrt_v3_iile_tpu.ops import intersect as isect
    from pbrt_v3_iile_tpu.ops import camera as camlib

    sd, scene, cam, cs = _atrium_clusters()
    N = 512
    rng = np.random.default_rng(3)
    px = jnp.asarray(rng.uniform(0, 512, (N, 2)).astype(np.float32))
    o, d = camlib.generate_rays(cam, px)
    tm = jnp.full(N, 1e30)
    hit = isect.intersect_bvh(scene, o, d, tm)

    ids = jnp.arange(cs.aabb_min.shape[0])
    t, valid = [], []
    for c0 in range(0, N, 128):   # ray chunks bound the (N, K, 3C) temps
        tc, _, _, _, vc = cllib.intersect_clusters_dense(
            cs, ids, o[c0:c0 + 128], d[c0:c0 + 128], tm[c0:c0 + 128])
        t.append(np.asarray(tc))
        valid.append(np.asarray(vc))
    t, valid = np.concatenate(t), np.concatenate(valid)
    hv = np.asarray(hit.valid)
    assert hv.mean() > 0.9          # an interior: nearly every ray hits
    assert (valid == hv).mean() > 0.995
    both = valid & hv
    assert np.allclose(t[both], np.asarray(hit.t)[both], rtol=5e-3,
                       atol=5e-4)


def test_grouped_pipeline_matches_walker_atrium():
    """End-to-end grouped pipeline (sort -> cull -> chunked dense) vs
    the XLA walker on atrium primary + incoherent rays."""
    from pbrt_v3_iile_tpu.ops import intersect as isect
    from pbrt_v3_iile_tpu.ops import camera as camlib

    sd, scene, cam, cs = _atrium_clusters()
    rng = np.random.default_rng(5)
    N = 2048
    px = jnp.asarray(rng.uniform(0, 512, (N, 2)).astype(np.float32))
    o, d = camlib.generate_rays(cam, px)
    # add some incoherent rays: random origins in the world box
    wmin = np.asarray(scene.world_min); wmax = np.asarray(scene.world_max)
    o2 = jnp.asarray(rng.uniform(wmin, wmax, (N, 3)).astype(np.float32))
    d2 = rng.normal(size=(N, 3)).astype(np.float32)
    d2 = jnp.asarray(d2 / np.linalg.norm(d2, axis=-1, keepdims=True))
    o = jnp.concatenate([o, o2]); d = jnp.concatenate([d, d2])
    tm = jnp.full(2 * N, 1e30)
    # a few dead rays mixed in
    tm = tm.at[::97].set(-1.0)

    def fallback(os_, ds_, ts_):
        return isect.intersect_bvh(scene, os_, ds_, ts_)

    t, prim, b1, b2, valid = cllib.intersect_grouped(
        cs, o, d, tm, fallback=fallback)
    ref = isect.intersect_bvh(scene, o, d, tm)
    valid = np.asarray(valid); rv = np.asarray(ref.valid)
    assert np.asarray(t).shape == (2 * N,)
    agree = (valid == rv)
    assert agree.mean() > 0.995, f"hit agreement {agree.mean():.4f}"
    both = valid & rv & agree
    assert np.allclose(np.asarray(t)[both], np.asarray(ref.t)[both],
                       rtol=5e-3, atol=5e-4)
    # dead rays stay dead
    assert not valid[::97].any()


def test_group_cull_conservative_axis_aligned():
    """The interval cull must never reject a cluster that a member ray
    hits — including rays with exact-zero direction components
    (ADVICE r2: one-sided zero-touching intervals like [-0.5, 0])."""
    rng = np.random.default_rng(21)
    K = 16
    amin = rng.uniform(-4, 3, (K, 3)).astype(np.float32)
    amax = (amin + rng.uniform(0.2, 1.5, (K, 3))).astype(np.float32)
    G = 32
    Gn = 8
    o = rng.uniform(-5, 5, (Gn * G, 3)).astype(np.float32)
    d = rng.normal(size=(Gn * G, 3)).astype(np.float32)
    # zero out random components so direction intervals touch zero
    zero_mask = rng.uniform(size=(Gn * G, 3)) < 0.4
    d = np.where(zero_mask, 0.0, d)
    keep = np.linalg.norm(d, axis=1) > 1e-6
    d[~keep] = np.array([0.0, 0.0, 1.0])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_alive = np.full(Gn * G, 1e30, np.float32)

    mask = np.asarray(cllib._group_cull(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_alive),
        jnp.asarray(amin), jnp.asarray(amax), G))

    # brute-force per-ray slab test
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d == 0.0, np.where(d >= 0, 1e30, -1e30), 1.0 / d)
    lo = (amin[None] - o[:, None]) * inv[:, None]        # (N,K,3)
    hi = (amax[None] - o[:, None]) * inv[:, None]
    tn = np.maximum(np.minimum(lo, hi).max(-1), 0.0)
    tf = np.maximum(lo, hi).min(-1)
    ray_hits = tn <= tf                                  # (N,K)
    group_hits = ray_hits.reshape(Gn, G, K).any(axis=1)  # (Gn,K)
    missed = group_hits & ~mask
    assert not missed.any(), \
        f"cull rejected {missed.sum()} group/cluster pairs with real hits"
