"""Fused cluster-traversal kernel for NVIDIA GPUs (Pallas, Triton route).

Triangles are cut from BVH subtrees into clusters of at most C = 128
(ops/clusters.py keeps the plain-XLA evaluator that this kernel is
checked against).  One wave of rays is intersected in three steps:

- XLA sorts the rays by a 6D coherence key and groups them G at a time;
- an exact per-ray slab cull (ops/clusters.per_ray_cull) lists, per
  group, the clusters some live member ray enters, sorted front to back
  by the entry distance;
- ONE Triton program per group walks its candidate list, testing all G
  rays against all C triangles of a cluster as a (G, C) tile of fp32
  FMAs, and stops as soon as every ray's best hit is nearer than the
  next cluster's entry bound (an exact early break).

Feature packing (per cluster, (NRS=22, C) f32), ray feature vector
r = [d(3), o x d(3), -o(3), 1]:
  row [q*6 + 0:3] = a x b, [q*6 + 3:6] = b - a for edge q of triangle j
             (side = d.(a x b) + (o x d).(b - a), Shevtsov-style)
  rows 18:21 = n, row 21 = n.p0 (plane numerator; the denominator n.d
  equals the side sum s exactly, so it needs no rows)
  so t = num/s, and the side signs agree iff the ray crosses the
  triangle.

The side tests are elementwise fp32 FMAs rather than a dot: a TF32
tensor-core product would flip the sign tests near edges.

Replaces the reference renderer's hot loop
(ref: src/accelerators/bvh.cpp:662 BVHAccel::Intersect,
src/shapes/triangle.cpp:188 Triangle::Intersect).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .intersect import Hit
from . import clusters as cluster_lib

C = 128          # triangles per cluster (the kernel's lane width)
NF = 10          # ray features: d, o x d, -o, 1
NRS = 22         # feature rows per cluster: 3x6 edge-side rows +
                 # 3 plane-normal rows + 1 plane-offset row
G_DEFAULT = 32   # rays per group (one Triton program each)
MAXC_DEFAULT = 192
BK_DEFAULT = 4   # clusters per early-break check (the pipelined loop)
NUM_WARPS = 8   # G = 32 with 8 warps was the fastest configuration timed
NUM_STAGES = 2  # on an H100 (PERF.md, Findings)


class ClusterPack(NamedTuple):
    """Device tables for the fused kernel (triangles in BVH order)."""
    feat: jnp.ndarray      # (K, NRS, C) f32 packed features
    tri_off: jnp.ndarray   # (K,) i32 first triangle id
    tri_cnt: jnp.ndarray   # (K,) i32 valid triangles (<= C)
    aabb_min: jnp.ndarray  # (K,3) f32
    aabb_max: jnp.ndarray  # (K,3) f32


def build_cluster_pack(flat, tri_p0, tri_e1, tri_e2,
                       max_tris: int = C) -> ClusterPack:
    """Vectorized host-side build (no per-triangle Python loop).

    flat: ops/bvh.FlatBVH; tri_*: (T,3) BVH-ordered triangle soup."""
    ranges = cluster_lib._subtree_ranges(flat, max_tris)
    K = len(ranges)
    off = np.asarray([r[0] for r in ranges], np.int32)
    cnt = np.asarray([r[1] for r in ranges], np.int32)
    order = np.argsort(off, kind="stable")
    off, cnt = off[order], cnt[order]
    T = int(cnt.sum())

    p0 = np.asarray(tri_p0, np.float64)[:T]
    e1 = np.asarray(tri_e1, np.float64)[:T]
    e2 = np.asarray(tri_e2, np.float64)[:T]
    p1 = p0 + e1
    p2 = p0 + e2
    n = np.cross(e1, e2)

    k_of = np.repeat(np.arange(K), cnt)           # (T,) cluster per tri
    j_of = np.arange(T) - off[k_of]               # (T,) slot in cluster

    feat = np.zeros((K, NRS, max_tris), np.float32)
    rows3 = np.arange(3)
    for q, (a, b) in enumerate(((p0, p1), (p1, p2), (p2, p0))):
        feat[k_of[:, None], q * 6 + rows3[None, :], j_of[:, None]] = \
            np.cross(a, b).astype(np.float32)
        feat[k_of[:, None], q * 6 + 3 + rows3[None, :], j_of[:, None]] = \
            (b - a).astype(np.float32)
    feat[k_of[:, None], 18 + rows3[None, :], j_of[:, None]] = \
        n.astype(np.float32)
    feat[k_of, 21, j_of] = np.einsum("td,td->t", n,
                                     p0).astype(np.float32)
    # no plane-denominator row: n.d == w0+w1+w2 exactly
    # (a x b + b x c + c x a = e1 x e2 = n)

    # per-cluster AABBs via segment reductions over contiguous ranges
    v = np.stack([p0, p1, p2], 1)                 # (T,3,3)
    amin = np.minimum.reduceat(v.min(1), off)[:K].astype(np.float32)
    amax = np.maximum.reduceat(v.max(1), off)[:K].astype(np.float32)

    return ClusterPack(
        feat=jnp.asarray(feat), tri_off=jnp.asarray(off),
        tri_cnt=jnp.asarray(cnt), aabb_min=jnp.asarray(amin),
        aabb_max=jnp.asarray(amax))


def _traverse_group_kernel(rays_ref, tmax_ref, cand_ref, pk_ref, ctn_ref,
                           ncand_ref, feat_ref, t_out, prim_out, *,
                           G: int, maxc: int, bk: int, any_hit: bool):
    """One program = one ray group against its candidate clusters.

    Candidates arrive sorted by conservative entry distance (ctn_ref);
    the loop exits as soon as every ray's best hit is nearer than the
    next cluster's entry bound — exact occlusion culling, the analogue
    of the BVH walker's near-child-first descent.  Each cluster is
    reduced to a per-ray best right away (a min over the C lanes), so
    the carried state is two (G,) vectors."""
    g = pl.program_id(0)
    rows = pl.ds(g * G, G)
    r = [rays_ref[k, rows] for k in range(NF)]       # NF x (G,)
    tmax = tmax_ref[rows]
    n = ncand_ref[g]
    lane = jax.lax.broadcasted_iota(jnp.int32, (G, C), 1)
    big = jnp.float32(3.0e38)

    def one_cluster(i, carry):
        bt, bp = carry
        cid = cand_ref[g, i]
        pk = pk_ref[g, i]
        cnt = pk & 255
        off = pk >> 8

        def contract(row0, cols):
            acc = None
            for k, rc in enumerate(cols):
                f = feat_ref[cid, row0 + k, :]       # (C,)
                term = r[rc][:, None] * f[None, :]
                acc = term if acc is None else acc + term
            return acc                               # (G, C)

        e6 = (0, 1, 2, 3, 4, 5)
        w0 = contract(0, e6)
        w1 = contract(6, e6)
        w2 = contract(12, e6)
        num = contract(18, (6, 7, 8, 9))
        s = w0 + w1 + w2
        nz = jnp.abs(s) > 1e-12
        t = num / jnp.where(nz, s, 1.0)
        # all three pairwise products, so one zero side cannot mask a
        # disagreement between the other two
        same = (w0 * w1 >= 0) & (w1 * w2 >= 0) & (w0 * w2 >= 0)
        ok = (same & nz & (t > 1e-5) & (t < bt[:, None]) & (lane < cnt))
        tm = jnp.where(ok, t, big)
        tmin = jnp.min(tm, axis=1)
        # smallest lane at the minimum: deterministic ties
        j = jnp.min(jnp.where(tm == tmin[:, None], lane, C), axis=1)
        upd = tmin < bt
        return jnp.where(upd, tmin, bt), jnp.where(upd, off + j, bp)

    def cond(st):
        b, done, _, _ = st
        return (b * bk < n) & (done == 0)

    def body(st):
        b, _, bt, bp = st
        bt, bp = jax.lax.fori_loop(b * bk, b * bk + bk, one_cluster,
                                   (bt, bp))
        # exact early break: every later candidate enters no nearer
        # than this one, so a ray whose best t is below it is final.
        # Dead rays (bt = -big) always are; unhit live rays keep
        # bt = t_max, which bounds shadow rays.
        nxt = ctn_ref[g, jnp.minimum((b + 1) * bk, maxc - 1)]
        fin = bt <= nxt
        if any_hit:
            fin = fin | (bt < tmax)
        done = jnp.min(fin.astype(jnp.int32))
        return b + 1, done, bt, bp

    # dead rays match nothing
    bt0 = jnp.where(tmax > 0.0, tmax, jnp.float32(-3.0e38))
    bp0 = jnp.full((G,), -1, jnp.int32)
    _, _, bt, bp = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.int32(0), bt0, bp0))
    t_out[rows] = jnp.where(bp >= 0, bt, tmax)
    prim_out[rows] = bp


def _run_kernel(feat, rays, tmax, cand, packed, ctn, ncand, *, G: int,
                bk: int, any_hit: bool, interpret: bool):
    Np = tmax.shape[0]
    Gn = Np // G
    kern = functools.partial(_traverse_group_kernel, G=G,
                             maxc=cand.shape[1], bk=bk, any_hit=any_hit)
    whole = pl.no_block_spec
    return pl.pallas_call(
        kern,
        grid=(Gn,),
        in_specs=[whole] * 7,
        out_specs=[whole, whole],
        out_shape=[jax.ShapeDtypeStruct((Np,), jnp.float32),
                   jax.ShapeDtypeStruct((Np,), jnp.int32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=NUM_STAGES),
        interpret=interpret,
        name="cluster_traverse",
    )(rays, tmax, cand, packed, ctn, ncand, feat)


def intersect_clusters_fused(cp: ClusterPack, o, d, t_max, *,
                             any_hit: bool = False, group: int = G_DEFAULT,
                             max_candidates: int = MAXC_DEFAULT,
                             break_every: int = BK_DEFAULT,
                             world_min=None, world_max=None,
                             fallback=None, interpret: bool = False,
                             tri_p0=None, tri_e1=None, tri_e2=None,
                             presorted: bool = False) -> Hit:
    """Full-scene closest-hit (or any-hit) via the fused cluster kernel.

    Sort -> exact per-ray cull -> front-to-back candidate lists ->
    Triton kernel; groups whose candidate count exceeds max_candidates
    are traced by `fallback(o, d, t_alive)` (the XLA walker) for
    exactness.  Returns Hit in the original ray order with BVH-order
    triangle ids.  interpret=True runs the kernel in the Pallas
    interpreter (tests on the CPU).

    presorted=True: the caller guarantees rays already arrive
    coherence-sorted (dead rays last) — the internal sort AND the
    result unsort are skipped (the compacted-wavefront pipeline sorts
    the whole path state once per bounce instead)."""
    N = o.shape[0]
    G = group
    pad = (-N) % G
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        d = jnp.concatenate(
            [d, jnp.tile(jnp.asarray([[1.0, 0, 0]], d.dtype), (pad, 1))])
        t_max = jnp.concatenate([t_max, jnp.full((pad,), -1.0, t_max.dtype)])
    Np = N + pad
    Gn = Np // G
    K = cp.aabb_min.shape[0]
    bk = break_every
    # a whole number of early-break bundles
    MAXC = min(max_candidates, -(-K // bk) * bk)
    MAXC = -(-MAXC // bk) * bk

    wmin = jnp.min(cp.aabb_min, 0) if world_min is None else world_min
    wmax = jnp.max(cp.aabb_max, 0) if world_max is None else world_max
    if presorted:
        os_, ds_, ts_ = o, d, t_max
        inv_perm = None
    else:
        key = cluster_lib.sort_key6(o, d, wmin, wmax)
        key = jnp.where(t_max > 0.0, key, jnp.int32(0x7FFFFFFF))
        # ONE multi-operand sort carries the ray data and its index
        ridx = jnp.arange(Np, dtype=jnp.int32)
        (_, ox, oy, oz, dx, dy, dz, ts_, perm) = jax.lax.sort(
            (key, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
             t_max, ridx), dimension=0, num_keys=1)
        os_ = jnp.stack([ox, oy, oz], axis=1)
        ds_ = jnp.stack([dx, dy, dz], axis=1)
        # inverse permutation: inv[perm[i]] = i (one scatter)
        inv_perm = jnp.zeros_like(perm).at[perm].set(
            jnp.arange(perm.shape[0], dtype=perm.dtype))

    # exact per-ray slab cull reduced per group: a cluster is a
    # candidate iff some live member ray enters its AABB within
    # [0, t_max]
    mask, tnear = cluster_lib.per_ray_cull(
        os_, ds_, ts_, cp.aabb_min, cp.aabb_max, G)
    n_cand = jnp.sum(mask, axis=1)

    # front-to-back candidate order by conservative entry distance (the
    # kernel's early-break key: monotone, so the break is exact); the
    # sort carries the cluster id and its packed (tri_off, tri_cnt)
    big_t = jnp.float32(3.0e38)
    order_key = jnp.where(mask, tnear, big_t)
    cid_row = jnp.arange(K, dtype=jnp.int32)
    packed_row = cp.tri_off * jnp.int32(256) + cp.tri_cnt   # cnt <= C < 256
    ctn, cand, packed = (x[:, :MAXC] for x in jax.lax.sort(
        (order_key, jnp.broadcast_to(cid_row, (Gn, K)),
         jnp.broadcast_to(packed_row, (Gn, K))), dimension=1, num_keys=1))
    padc = MAXC - ctn.shape[1]
    if padc > 0:  # K smaller than a whole number of bundles
        cand = jnp.concatenate(
            [cand, jnp.zeros((Gn, padc), jnp.int32)], axis=1)
        ctn = jnp.concatenate(
            [ctn, jnp.full((Gn, padc), big_t)], axis=1)
        packed = jnp.concatenate(
            [packed, jnp.zeros((Gn, padc), jnp.int32)], axis=1)
    # zero the count byte of invalid slots (the kernel masks on cnt)
    packed = jnp.where(ctn < big_t, packed, 0)
    ncand = jnp.minimum(n_cand, MAXC).astype(jnp.int32)

    r6, r8 = cluster_lib.ray_features(os_, ds_)          # (Np,6),(Np,8)
    rays = jnp.concatenate([r6, r8[:, :4]], axis=1).T    # (NF, Np)

    t, prim = _run_kernel(cp.feat, rays, ts_, cand, packed, ctn, ncand,
                          G=G, bk=bk, any_hit=any_hit, interpret=interpret)
    valid = prim >= 0

    # barycentrics post-hoc (ONE row gather + a 2x2 solve)
    if tri_p0 is not None:
        pid = jnp.clip(prim, 0, tri_p0.shape[0] - 1)
        P0 = jnp.take(tri_p0, pid, axis=0)
        E1 = jnp.take(tri_e1, pid, axis=0)
        E2 = jnp.take(tri_e2, pid, axis=0)
        q = os_ + t[:, None] * ds_ - P0
        a11 = jnp.sum(E1 * E1, -1)
        a12 = jnp.sum(E1 * E2, -1)
        a22 = jnp.sum(E2 * E2, -1)
        q1 = jnp.sum(E1 * q, -1)
        q2 = jnp.sum(E2 * q, -1)
        det = a11 * a22 - a12 * a12
        inv = jnp.where(jnp.abs(det) > 1e-20, 1.0 / jnp.where(
            det == 0, 1.0, det), 0.0)
        b1 = jnp.clip((a22 * q1 - a12 * q2) * inv, 0.0, 1.0)
        b2 = jnp.clip((a11 * q2 - a12 * q1) * inv, 0.0, 1.0)
        b1 = jnp.where(valid, b1, 0.0)
        b2 = jnp.where(valid, b2, 0.0)
    else:
        b1 = jnp.zeros(Np)
        b2 = jnp.zeros(Np)

    overflow = n_cand > MAXC                             # (Gn,)
    if fallback is not None:
        ovr = jnp.repeat(overflow, G)                    # (Np,)

        def _run_fb(_):
            t_fb = jnp.where(ovr & (ts_ > 0), ts_, -1.0)
            return fallback(os_, ds_, t_fb)

        def _no_fb(_):
            return Hit(t=ts_, prim=jnp.full((Np,), -1, jnp.int32),
                       b1=jnp.zeros(Np), b2=jnp.zeros(Np),
                       valid=jnp.zeros(Np, bool))

        # the fallback only runs for waves where some group overflowed
        fb = jax.lax.cond(jnp.any(overflow), _run_fb, _no_fb, None)
        use = ovr & fb.valid
        miss_fb = ovr & ~fb.valid
        t = jnp.where(use, fb.t, jnp.where(miss_fb, ts_, t))
        prim = jnp.where(use, fb.prim, jnp.where(miss_fb, -1, prim))
        b1 = jnp.where(use, fb.b1, b1)
        b2 = jnp.where(use, fb.b2, b2)
        valid = jnp.where(ovr, fb.valid, valid)

    unp = ((lambda x: x[:N]) if presorted else
           (lambda x: x[inv_perm][:N]))
    return Hit(t=unp(t), prim=unp(prim), b1=unp(b1), b2=unp(b2),
               valid=unp(valid))
