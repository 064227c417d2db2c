"""Triangle clustering for dense ray x cluster intersection.

Group triangles into fixed-size clusters cut from BVH subtrees, cull
clusters per ray group against their AABBs, and test ray x cluster
pairs DENSELY: the Pluecker side tests are bilinear in (ray features,
triangle features), so one (rays, F) x (F, 3*C) contraction covers a
whole cluster.

Replaces the role of the reference's fine BVH levels + per-leaf tests
(ref: accelerators/bvh.cpp:662 Intersect inner loop,
shapes/triangle.cpp:188).

This module provides the host-side build (cluster cuts, features), the
ray sort key and per-ray cull that the fused GPU kernel
(ops/clusters_pallas.py) uses, and a vectorized jnp evaluator
(`intersect_clusters_dense`, `intersect_grouped`) kept as the
correctness reference.  Its contractions run at Precision.HIGHEST: a
TF32 product would flip side-test signs near triangle edges.

Pluecker ray-triangle test (Shevtsov et al. style, re-derived):
  ray R = (o, d); m = o x d  (moment).
  For an edge from a to b: L = (b - a, a x b).
  side(R, L) = d . (a x b) + m . (b - a)
  The three edge sides w0,w1,w2 share a sign iff the ray passes through
  the triangle; w_i are proportional to the barycentric numerators and
  sum to the (signed) double area projection, so u = w1/sum, v = w2/sum.
  t from the plane: t = (n . p0 - n . o) / (n . d).

  side is BILINEAR: [d, m] (6,) . [a x b, b - a] (6,) — so for a whole
  cluster, W = Rfeat (N,6) @ Efeat (6, 3C).  t needs n.o, n.d: another
  (N,6) @ (6, C) with rays [o,d] against [n*? ...] — packed below.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

CLUSTER_SIZE = 64


class ClusterSet(NamedTuple):
    """Device-side cluster tables (triangles in BVH order)."""
    tri_off: jnp.ndarray      # (K,) i32 first triangle (BVH order)
    tri_cnt: jnp.ndarray      # (K,) i32 triangle count (<= CLUSTER_SIZE)
    aabb_min: jnp.ndarray     # (K,3) f32
    aabb_max: jnp.ndarray     # (K,3) f32
    # dense per-cluster features, padded to CLUSTER_SIZE:
    edge_feat: jnp.ndarray    # (K, 6, 3*C) f32: per edge [axb ; b-a]
    plane_feat: jnp.ndarray   # (K, 8, C) f32: rows [n, n.p0, -n, 0, 0]
                              # so [o,1,d,0] (8,) . col = n.p0 - n.o  and
                              # [0,0,n? ...]  (see ray_features)


def _subtree_ranges(flat, max_tris=CLUSTER_SIZE):
    """Cut the binary BVH into disjoint subtrees of <= max_tris prims.
    Returns list of (prim_offset, prim_count) in BVH prim order."""
    # compute subtree prim ranges by walking: leaves carry
    # (offset, count); interior = union of children (prims are laid out
    # contiguously per subtree by the builder)
    M = flat.node_min.shape[0]
    lo = np.full(M, np.iinfo(np.int32).max, np.int64)
    hi = np.full(M, -1, np.int64)
    # children come after parent; iterate in reverse so children resolve
    # before parents
    first_child = np.arange(M) + 1
    for i in range(M - 1, -1, -1):
        if flat.node_count[i] > 0:
            lo[i] = flat.node_right[i]
            hi[i] = flat.node_right[i] + flat.node_count[i]
        else:
            l, r = first_child[i], flat.node_right[i]
            lo[i] = min(lo[l], lo[r])
            hi[i] = max(hi[l], hi[r])

    out = []

    def cut(i):
        if hi[i] - lo[i] <= max_tris or flat.node_count[i] > 0:
            out.append((int(lo[i]), int(hi[i] - lo[i])))
            return
        cut(first_child[i])
        cut(int(flat.node_right[i]))

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, int(flat.max_depth) * 4 + 100))
    try:
        cut(0)
    finally:
        sys.setrecursionlimit(old)
    return out


def build_clusters(flat, tri_p0, tri_e1, tri_e2,
                   max_tris: int = CLUSTER_SIZE) -> ClusterSet:
    """Host-side build from the flattened BVH + triangle soup (all in
    BVH prim order).  tri_*: (T,3) float arrays."""
    ranges = _subtree_ranges(flat, max_tris)
    K = len(ranges)
    C = max_tris
    off = np.zeros(K, np.int32)
    cnt = np.zeros(K, np.int32)
    amin = np.zeros((K, 3), np.float32)
    amax = np.zeros((K, 3), np.float32)
    ef = np.zeros((K, 6, 3 * C), np.float32)
    pf = np.zeros((K, 8, C), np.float32)

    p0 = np.asarray(tri_p0, np.float64)
    e1 = np.asarray(tri_e1, np.float64)
    e2 = np.asarray(tri_e2, np.float64)
    p1 = p0 + e1
    p2 = p0 + e2
    n = np.cross(e1, e2)

    for k, (o, c) in enumerate(ranges):
        off[k] = o
        cnt[k] = c
        pts = np.concatenate([p0[o:o + c], p1[o:o + c], p2[o:o + c]])
        amin[k] = pts.min(0)
        amax[k] = pts.max(0)
        for j in range(c):
            t = o + j
            verts = (p0[t], p1[t], p2[t])
            for e in range(3):
                a, b = verts[e], verts[(e + 1) % 3]
                ef[k, 0:3, e * C + j] = np.cross(a, b)
                ef[k, 3:6, e * C + j] = b - a
            pf[k, 0:3, j] = n[t]
            pf[k, 3, j] = np.dot(n[t], p0[t])
            pf[k, 4:7, j] = n[t]
    return ClusterSet(
        tri_off=jnp.asarray(off), tri_cnt=jnp.asarray(cnt),
        aabb_min=jnp.asarray(amin), aabb_max=jnp.asarray(amax),
        edge_feat=jnp.asarray(ef), plane_feat=jnp.asarray(pf))


def ray_features(o, d):
    """(N,3),(N,3) -> (r6 (N,6) pluecker [d ; o x d], r8 (N,8) plane
    [-o ; 1 ; d ; 0])."""
    m = jnp.cross(o, d)
    r6 = jnp.concatenate([d, m], axis=-1)
    r8 = jnp.concatenate(
        [-o, jnp.ones(o.shape[:-1] + (1,), o.dtype), d,
         jnp.zeros(o.shape[:-1] + (1,), o.dtype)], axis=-1)
    return r6, r8


def intersect_clusters_dense(cs: ClusterSet, cluster_ids, o, d, t_max,
                             precision=jax.lax.Precision.HIGHEST):
    """Test every ray against every listed cluster, densely.

    cluster_ids: (Kc,) i32.  o, d: (N,3).  Returns (t, prim, b1, b2,
    valid) with prim a GLOBAL BVH-order triangle index.  The heavy ops
    are two matmuls per call: (N,6)@(6,3C*Kc) and (N,8)@(8,C*Kc)."""
    C = cs.edge_feat.shape[2] // 3
    ef = jnp.take(cs.edge_feat, cluster_ids, axis=0)   # (Kc,6,3C)
    pf = jnp.take(cs.plane_feat, cluster_ids, axis=0)  # (Kc,8,C)
    offs = jnp.take(cs.tri_off, cluster_ids)           # (Kc,)
    cnts = jnp.take(cs.tri_cnt, cluster_ids)
    Kc = ef.shape[0]

    r6, r8 = ray_features(o, d)
    W = jnp.einsum("nf,kfe->nke", r6, ef,
                   precision=precision)                # (N,Kc,3C)
    W = W.reshape(W.shape[0], Kc, 3, C)
    w0, w1, w2 = W[:, :, 0], W[:, :, 1], W[:, :, 2]
    # plane terms: r8 . [n, n.p0, n, 0] -> num = n.p0 - n.o ; den = n.d
    P = jnp.einsum("nf,kfc->nkc", r8[:, :4], pf[:, :4],
                   precision=precision)                # num (N,Kc,C)
    D = jnp.einsum("nf,kfc->nkc", r8[:, 4:7], pf[:, 4:7],
                   precision=precision)                # n.d (via d rows)
    t = P / jnp.where(jnp.abs(D) > 1e-12, D, jnp.where(D >= 0, 1e-12,
                                                       -1e-12))
    s = w0 + w1 + w2
    same_side = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | \
        ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))
    lane = jnp.arange(C)[None, None, :]
    ok = (same_side & (jnp.abs(s) > 1e-12) & (jnp.abs(D) > 1e-12)
          & (t > 1e-5) & (t < t_max[:, None, None])
          & (lane < cnts[None, :, None]))
    t_ok = jnp.where(ok, t, jnp.inf)
    flat = t_ok.reshape(t_ok.shape[0], -1)
    best = jnp.argmin(flat, axis=1)
    tbest = jnp.take_along_axis(flat, best[:, None], axis=1)[:, 0]
    kbest = best // C
    jbest = best % C
    valid = jnp.isfinite(tbest)
    prim = jnp.where(valid, jnp.take(offs, kbest) + jbest, -1)
    # barycentrics from the side terms of the winning triangle
    wsel = lambda w: jnp.take_along_axis(
        w.reshape(w.shape[0], -1), best[:, None], axis=1)[:, 0]
    ssel = wsel(s)
    inv_s = jnp.where(jnp.abs(ssel) > 1e-12, 1.0 / ssel, 0.0)
    b1 = jnp.abs(wsel(w2) * inv_s)
    b2 = jnp.abs(wsel(w0) * inv_s)
    return (jnp.where(valid, tbest, t_max), prim, b1, b2, valid)


# ---------------------------------------------------------------------------
# Grouped pipeline: sort rays -> cull clusters per group -> chunked dense
# intersection.  Pure XLA (batched matmuls + elementwise), no pallas.
# ---------------------------------------------------------------------------

def _morton10(x):
    """Interleave 10 bits of x (i32 in [0,1024)) with two zero bits."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def sort_key(o, d, world_min, world_max):
    """Coherence sort key: direction octant (high bits) then origin
    Morton code — rays in one group share sign AND locality."""
    oc = ((d[:, 0] < 0).astype(jnp.int32)
          + 2 * (d[:, 1] < 0).astype(jnp.int32)
          + 4 * (d[:, 2] < 0).astype(jnp.int32))
    ext = jnp.maximum(world_max - world_min, 1e-9)
    q = jnp.clip(((o - world_min[None]) / ext[None] * 1024.0)
                 .astype(jnp.int32), 0, 1023)
    m = (_morton10(q[:, 0]) | (_morton10(q[:, 1]) << 1)
         | (_morton10(q[:, 2]) << 2))
    return (oc << 27) | (m >> 3)   # keep within positive i32


def sort_key6(o, d, world_min, world_max, obits: int = 8,
              dbits: int = 4, o_lead: int = 3):
    """6D coherence key: octant (3 bits), then interleaved origin- and
    direction-Morton levels (o_lead leading origin levels, then
    alternating o/d levels).  Bounce waves have wide direction spread
    at nearby origins; giving the key direction bits below the first
    few origin levels makes ray groups direction-tight too, which
    shrinks their candidate-cluster unions.  3 + 3 *
    (obits + dbits) must stay < 31."""
    oc = ((d[:, 0] < 0).astype(jnp.int32)
          + 2 * (d[:, 1] < 0).astype(jnp.int32)
          + 4 * (d[:, 2] < 0).astype(jnp.int32))
    ext = jnp.maximum(world_max - world_min, 1e-9)
    qo = jnp.clip(((o - world_min[None]) / ext[None] * (1 << obits))
                  .astype(jnp.int32), 0, (1 << obits) - 1)
    qd = jnp.clip((jnp.abs(d) * (1 << dbits)).astype(jnp.int32),
                  0, (1 << dbits) - 1)
    key = oc
    oi, di = obits, dbits
    sched = ["o"] * o_lead
    for i in range(max(obits - o_lead, dbits)):
        if i < dbits:
            sched.append("d")
        if i < obits - o_lead:
            sched.append("o")
    for s in sched:
        if s == "o":
            oi -= 1
            b = (((qo[:, 0] >> oi) & 1) | (((qo[:, 1] >> oi) & 1) << 1)
                 | (((qo[:, 2] >> oi) & 1) << 2))
        else:
            di -= 1
            b = (((qd[:, 0] >> di) & 1) | (((qd[:, 1] >> di) & 1) << 1)
                 | (((qd[:, 2] >> di) & 1) << 2))
        key = (key << 3) | b
    return key


def per_ray_cull(o, d, t_alive, amin, amax, group, chunk_groups=64):
    """EXACT per-ray slab cull, reduced per group.

    o, d: (N,3) sorted rays, N divisible by `group`.  Returns
    (need (Gn,K) bool, tnear (Gn,K) f32): need[g,k] iff SOME live ray
    of group g enters cluster k's AABB within its [0, t_max]; tnear is
    the min entry distance over those rays (a valid lower bound for the
    fused kernel's front-to-back order + exact early break).

    For diffuse bounce waves an interval-arithmetic group bound
    degenerates (the group's direction box spans the octant), while
    exact per-ray tests leave about one cluster per ray.  Work is
    O(N*K) slab tests, chunked over groups to bound the (B,G,K)
    intermediates."""
    G = group
    N = o.shape[0]
    Gn = N // G
    K = amin.shape[0]
    B = min(chunk_groups, Gn)
    pad_g = (-Gn) % B
    S = (Gn + pad_g) // B
    og = o.reshape(Gn, G, 3)
    dg = d.reshape(Gn, G, 3)
    tg = t_alive.reshape(Gn, G)
    if pad_g:
        og = jnp.concatenate([og, jnp.zeros((pad_g, G, 3), og.dtype)])
        dg = jnp.concatenate(
            [dg, jnp.ones((pad_g, G, 3), dg.dtype)])
        tg = jnp.concatenate([tg, jnp.full((pad_g, G), -1.0, tg.dtype)])
    og = og.reshape(S, B, G, 3)
    dg = dg.reshape(S, B, G, 3)
    tg = tg.reshape(S, B, G)
    big = jnp.float32(3.0e38)

    def step(_, blk):
        oo, dd, tt = blk
        inv = jnp.where(jnp.abs(dd) > 1e-12,
                        1.0 / jnp.where(dd == 0, 1.0, dd),
                        jnp.where(dd >= 0, 1e30, -1e30))    # (B,G,3)
        live = tt > 0.0                                     # (B,G)
        # accumulate per-axis to keep peak memory at (B,G,K)
        tn = jnp.zeros((B, G, K), jnp.float32)
        tf = jnp.full((B, G, K), big)
        for ax in range(3):
            lo = (amin[None, None, :, ax] - oo[:, :, None, ax]) \
                * inv[:, :, None, ax]                       # (B,G,K)
            hi = (amax[None, None, :, ax] - oo[:, :, None, ax]) \
                * inv[:, :, None, ax]
            tn = jnp.maximum(tn, jnp.minimum(lo, hi))
            tf = jnp.minimum(tf, jnp.maximum(lo, hi))
        tf = tf * 1.0000004          # pbrt slab robustness (gamma(3))
        hit = (tn <= tf) & (tf > 0.0) & (tn <= tt[:, :, None]) \
            & live[:, :, None]
        need = jnp.any(hit, axis=1)                         # (B,K)
        tnear = jnp.min(jnp.where(hit, jnp.maximum(tn, 0.0), big),
                        axis=1)                             # (B,K)
        return None, (need, tnear)

    _, (need, tnear) = jax.lax.scan(step, None, (og, dg, tg))
    return need.reshape(S * B, K)[:Gn], tnear.reshape(S * B, K)[:Gn]


def _group_cull(o, d, t_alive, amin, amax, group):
    """Conservative group-vs-cluster AABB test (mask only)."""
    return group_cull_tnear(o, d, t_alive, amin, amax, group)[0]


def group_cull_tnear(o, d, t_alive, amin, amax, group):
    """Conservative group-vs-cluster AABB test via interval slabs.

    o, d: (N,3) sorted rays; group size G divides N.  Returns
    (mask (Gn,K) bool, tnear (Gn,K) f32) — tnear is a conservative
    LOWER bound on any member ray's entry distance into the cluster
    (the fused kernel's front-to-back order + early-break key).
    Interval arithmetic over the group's origin box and direction
    box: the slab interval using extremal (origin, direction) pairs
    contains every member ray's interval, so a rejected cluster is
    rejected for every ray in the group.  The cull also rejects
    clusters entirely beyond every live ray's t_max (shadow rays)."""
    G = group
    N = o.shape[0]
    Gn = N // G
    og = o.reshape(Gn, G, 3)
    dg = d.reshape(Gn, G, 3)
    live = (t_alive.reshape(Gn, G) > 0.0)[..., None]
    big = jnp.float32(3.4e38)
    olo = jnp.min(jnp.where(live, og, big), axis=1)     # (Gn,3)
    ohi = jnp.max(jnp.where(live, og, -big), axis=1)
    dlo = jnp.min(jnp.where(live, dg, big), axis=1)
    dhi = jnp.max(jnp.where(live, dg, -big), axis=1)
    any_live = (t_alive.reshape(Gn, G) > 0.0).any(axis=1)

    # interval reciprocal of direction: the axis can only cull when the
    # whole direction interval is strictly one-signed and bounded away
    # from zero; an interval touching [-eps, eps] (including one-sided
    # zero-touching like [-0.5, 0]) is treated as mixed -> no cull.
    # 1/x is monotone decreasing on a one-signed interval, so
    # [dlo, dhi] -> [1/dhi, 1/dlo] for both the positive and negative
    # cases.  (ADVICE r2: the old sign/±1e30 formulation was
    # non-conservative for zero-touching intervals.)
    eps = 1e-9
    one_signed = (dlo >= eps) | (dhi <= -eps)
    sign_mix = jnp.logical_not(one_signed)
    safe_hi = jnp.where(one_signed, dhi, 1.0)
    safe_lo = jnp.where(one_signed, dlo, 1.0)
    inv_lo = 1.0 / safe_hi                              # (Gn,3)
    inv_hi = 1.0 / safe_lo

    # per (group, cluster, axis): extremal slab times
    blo = amin[None, :, :]                              # (1,K,3)
    bhi = amax[None, :, :]
    # distances from origin box to slab planes (intervals)
    lo1 = blo - ohi[:, None, :]                         # (Gn,K,3) min dist
    lo2 = blo - olo[:, None, :]
    hi1 = bhi - ohi[:, None, :]
    hi2 = bhi - olo[:, None, :]

    def interval_mul_min(p1, p2, q1, q2):
        a = jnp.stack([p1 * q1, p1 * q2, p2 * q1, p2 * q2], 0)
        return jnp.min(a, 0), jnp.max(a, 0)

    tmin_ax = jnp.full(lo1.shape, -3.4e38)
    tmax_ax = jnp.full(lo1.shape, 3.4e38)
    # entry/exit per axis: [lo,hi] x inv interval; conservative bounds
    e1lo, e1hi = interval_mul_min(lo1, lo2, inv_lo[:, None, :],
                                  inv_hi[:, None, :])
    e2lo, e2hi = interval_mul_min(hi1, hi2, inv_lo[:, None, :],
                                  inv_hi[:, None, :])
    near = jnp.minimum(e1lo, e2lo)
    far = jnp.maximum(e1hi, e2hi)
    mix = sign_mix[:, None, :]
    tmin_ax = jnp.where(mix, tmin_ax, near)
    tmax_ax = jnp.where(mix, tmax_ax, far)
    tnear = jnp.maximum(jnp.max(tmin_ax, -1), 0.0)      # (Gn,K)
    tfar = jnp.min(tmax_ax, -1)
    # clusters beyond every live ray's t_max can never matter (bounded
    # shadow rays; 1e30 primaries are unaffected)
    t_hi = jnp.max(jnp.where(live[..., 0], t_alive.reshape(Gn, G), 0.0),
                   axis=1)                               # (Gn,)
    mask = ((tnear <= tfar) & (tnear <= t_hi[:, None])
            & any_live[:, None])
    return mask, tnear


def intersect_grouped(cs: ClusterSet, o, d, t_max, *, group: int = 256,
                      max_candidates: int = 128, chunk: int = 8,
                      world_min=None, world_max=None,
                      precision=jax.lax.Precision.HIGHEST,
                      fallback=None):
    """Full-scene intersection via sort + cull + dense cluster tests.

    Returns (t, prim, b1, b2, valid) in the ORIGINAL ray order; prim is
    a BVH-order triangle id.  Groups whose candidate count exceeds
    max_candidates fall back to `fallback(o, d, t_alive)` (the packet /
    XLA walker) for exactness; rays of non-overflowing groups are dead
    (t_max<0) in that call, which the walkers price at ~zero."""
    N = o.shape[0]
    G = group
    pad = (-N) % G
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        d = jnp.concatenate([d, jnp.tile(jnp.asarray([[1.0, 0, 0]],
                                                     d.dtype), (pad, 1))])
        t_max = jnp.concatenate([t_max, jnp.full((pad,), -1.0,
                                                 t_max.dtype)])
    Np = N + pad
    wmin = (jnp.min(cs.aabb_min, 0) if world_min is None else world_min)
    wmax = (jnp.max(cs.aabb_max, 0) if world_max is None else world_max)
    key = sort_key(o, d, wmin, wmax)
    # dead rays sort to the back so they concentrate in few groups
    key = jnp.where(t_max > 0.0, key, jnp.int32(0x7FFFFFFF))
    perm = jnp.argsort(key)
    inv_perm = jnp.argsort(perm)
    os_, ds_, ts_ = o[perm], d[perm], t_max[perm]

    Gn = Np // G
    K = cs.aabb_min.shape[0]
    mask = _group_cull(os_, ds_, ts_, cs.aabb_min, cs.aabb_max, G)
    n_cand = jnp.sum(mask, axis=1)                       # (Gn,)
    MAXC = min(max_candidates, K)
    # first MAXC candidate ids per group (cluster id order ~ tree order)
    cand = jnp.argsort(jnp.where(mask, 0, 1), axis=1,
                       stable=True)[:, :MAXC]            # (Gn, MAXC)
    cand_valid = jnp.take_along_axis(mask, cand, axis=1)

    C = cs.edge_feat.shape[2] // 3
    ogr = os_.reshape(Gn, G, 3)
    dgr = ds_.reshape(Gn, G, 3)
    tgr = ts_.reshape(Gn, G)
    r6, r8 = ray_features(ogr, dgr)                      # (Gn,G,6/8)

    n_chunks = -(-MAXC // chunk)
    lane = jnp.arange(C)[None, None, None, :]

    def chunk_body(carry, ci):
        best_t, best_flat = carry
        ids = jax.lax.dynamic_slice_in_dim(cand, ci * chunk, chunk, 1)
        idv = jax.lax.dynamic_slice_in_dim(cand_valid, ci * chunk,
                                           chunk, 1)     # (Gn,ch)
        ef = cs.edge_feat[ids]                           # (Gn,ch,6,3C)
        pf = cs.plane_feat[ids]                          # (Gn,ch,8,C)
        cnts = cs.tri_cnt[ids]                           # (Gn,ch)
        W = jnp.einsum("gnf,gcfe->gnce", r6, ef,
                       precision=precision)              # (Gn,G,ch,3C)
        W = W.reshape(Gn, G, chunk, 3, C)
        w0, w1, w2 = W[..., 0, :], W[..., 1, :], W[..., 2, :]
        Pn = jnp.einsum("gnf,gcfe->gnce", r8[..., :4], pf[..., :4, :],
                        precision=precision)             # (Gn,G,ch,C)
        Dn = jnp.einsum("gnf,gcfe->gnce", r8[..., 4:7], pf[..., 4:7, :],
                        precision=precision)
        t = Pn / jnp.where(jnp.abs(Dn) > 1e-12, Dn,
                           jnp.where(Dn >= 0, 1e-12, -1e-12))
        s = w0 + w1 + w2
        same = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | \
            ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))
        ok = (same & (jnp.abs(s) > 1e-12) & (jnp.abs(Dn) > 1e-12)
              & (t > 1e-5) & (t < tgr[..., None, None])
              & (lane < cnts[:, None, :, None])
              & idv[:, None, :, None])
        t_ok = jnp.where(ok, t, jnp.inf)
        tf = t_ok.reshape(Gn, G, -1)
        j = jnp.argmin(tf, axis=-1)
        tb = jnp.take_along_axis(tf, j[..., None], -1)[..., 0]
        # encode (chunk-local cluster, tri, w0, w2) of the winner
        kb = j // C
        jb = j % C
        offb = jnp.take_along_axis(ids, kb, 1)
        prim = jnp.take(cs.tri_off, offb) + jb
        w0b = jnp.take_along_axis(w0.reshape(Gn, G, -1), j[..., None],
                                  -1)[..., 0]
        w2b = jnp.take_along_axis(w2.reshape(Gn, G, -1), j[..., None],
                                  -1)[..., 0]
        sb = jnp.take_along_axis(s.reshape(Gn, G, -1), j[..., None],
                                 -1)[..., 0]
        upd = tb < best_t
        best_t = jnp.where(upd, tb, best_t)
        new_flat = jnp.stack([prim.astype(jnp.float32), w0b, w2b, sb], -1)
        best_flat = jnp.where(upd[..., None], new_flat, best_flat)
        return (best_t, best_flat), None

    init = (jnp.full((Gn, G), jnp.inf),
            jnp.zeros((Gn, G, 4)))
    (best_t, best_flat), _ = jax.lax.scan(chunk_body, init,
                                          jnp.arange(n_chunks))

    valid = jnp.isfinite(best_t)
    prim = jnp.where(valid, best_flat[..., 0].astype(jnp.int32), -1)
    inv_s = jnp.where(jnp.abs(best_flat[..., 3]) > 1e-12,
                      1.0 / best_flat[..., 3], 0.0)
    b1 = jnp.abs(best_flat[..., 2] * inv_s)
    b2 = jnp.abs(best_flat[..., 1] * inv_s)
    t_out = jnp.where(valid, best_t, tgr)

    # overflow groups -> exact fallback
    overflow = n_cand > MAXC                             # (Gn,)
    if fallback is not None:
        ovr = jnp.repeat(overflow, G)                    # (Np,)
        t_fb = jnp.where(ovr & (ts_ > 0), ts_, -1.0)
        fb = fallback(os_, ds_, t_fb)
        use = ovr.reshape(Gn, G) & fb.valid.reshape(Gn, G)
        miss_fb = ovr.reshape(Gn, G) & ~fb.valid.reshape(Gn, G)
        t_out = jnp.where(use, fb.t.reshape(Gn, G), t_out)
        t_out = jnp.where(miss_fb, tgr, t_out)
        prim = jnp.where(use, fb.prim.reshape(Gn, G), prim)
        prim = jnp.where(miss_fb, -1, prim)
        b1 = jnp.where(use, fb.b1.reshape(Gn, G), b1)
        b2 = jnp.where(use, fb.b2.reshape(Gn, G), b2)
        valid = jnp.where(ovr.reshape(Gn, G), fb.valid.reshape(Gn, G),
                          valid)

    flat = lambda x: x.reshape(Np)[inv_perm][:N]
    return (flat(t_out), flat(prim), flat(b1), flat(b2), flat(valid))
