"""kd-tree accelerator — the reference's alternative aggregate.

Parity target: src/accelerators/kdtreeaccel.{h,cpp} (KdTreeAccel: SAH
build with edge candidates, isectCost=80/traversalCost=1/emptyBonus=0.5,
KdAccelNode 8-byte packing, tmin/tmax todo-stack traversal
kdtreeaccel.cpp::Intersect).

Wavefront restructuring: the build stays on the host (numpy, once per
scene) and emits flat SoA arrays; traversal is a vectorized
`lax.while_loop` where every live ray advances one node per iteration,
with per-ray (node, tmin, tmax) stacks — the same wavefront pattern as
the BVH walker (ops/intersect.py), so the two accelerators are drop-in
interchangeable behind `Accelerator "kdtree"`.

The BVH remains the production path (the cluster kernel on GPUs, the
walker on the CPU); the kd-tree exists for aggregate parity and as a
second correctness oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import vecmath as vm

ISECT_COST = 80.0
TRAV_COST = 1.0
EMPTY_BONUS = 0.5
MAX_PRIMS = 8           # leaf budget (static unroll width in traversal)
STACK_DEPTH = 48
T_MIN = 1e-4


class KdTree(NamedTuple):
    split: np.ndarray    # (K,) f32 split plane (leaf: unused)
    meta: np.ndarray     # (K,) i32: low 2 bits axis, 3 = leaf;
                         # leaf: count << 2
    offset: np.ndarray   # (K,) i32: interior = above-child index;
                         # leaf = offset into prims
    prims: np.ndarray    # (P,) i32 triangle ids
    bounds: np.ndarray   # (2,3) f32 world bounds


def build_kdtree(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                 max_prims: int = MAX_PRIMS) -> KdTree:
    """Host-side SAH build (ref: kdtreeaccel.cpp KdTreeAccel ctor +
    ::buildTree).  Edge-candidate SAH on the largest axes with retries,
    bad-refine cutoff, empty bonus — the reference's cost model."""
    T = p0.shape[0]
    v0, v1, v2 = p0, p0 + e1, p0 + e2
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)
    wb_lo = lo.min(axis=0) if T else np.zeros(3)
    wb_hi = hi.max(axis=0) if T else np.ones(3)
    max_depth = int(round(8 + 1.3 * np.log2(max(T, 1)))) if T else 1

    split_l, meta_l, offset_l = [], [], []
    prim_out = []

    def make_leaf(idx):
        node = len(split_l)
        split_l.append(0.0)
        meta_l.append(3 | (len(idx) << 2))
        offset_l.append(len(prim_out))
        prim_out.extend(int(i) for i in idx)
        return node

    def rec(idx, nb_lo, nb_hi, depth, bad_refines):
        if len(idx) <= max_prims or depth == 0:
            return make_leaf(idx)
        d = nb_hi - nb_lo
        inv_sa = 1.0 / max(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]),
                           1e-30)
        old_cost = ISECT_COST * len(idx)
        best = (None, None, np.inf)  # (axis, split, cost)
        axes = np.argsort(-d)        # try largest extent first
        for axis in axes:
            elo = lo[idx, axis]
            ehi = hi[idx, axis]
            # edge events: (pos, is_start)
            pos = np.concatenate([elo, ehi])
            typ = np.concatenate([np.zeros(len(idx)), np.ones(len(idx))])
            order = np.lexsort((typ, pos))
            pos, typ = pos[order], typ[order]
            n_below = np.cumsum(typ == 0)           # after passing starts
            n_above = len(idx) - np.cumsum(typ == 1)
            o1, o2 = (axis + 1) % 3, (axis + 2) % 3
            inside = (pos > nb_lo[axis]) & (pos < nb_hi[axis])
            below = np.where(typ == 0, n_below - 1, n_below)
            above = n_above
            pb = np.where(inside,
                          2.0 * (d[o1] * d[o2] + (pos - nb_lo[axis])
                                 * (d[o1] + d[o2])) * inv_sa, 0.0)
            pa = np.where(inside,
                          2.0 * (d[o1] * d[o2] + (nb_hi[axis] - pos)
                                 * (d[o1] + d[o2])) * inv_sa, 0.0)
            eb = np.where((below == 0) | (above == 0), EMPTY_BONUS, 0.0)
            cost = TRAV_COST + ISECT_COST * (1.0 - eb) * (pb * below
                                                          + pa * above)
            cost = np.where(inside, cost, np.inf)
            if cost.size:
                k = int(np.argmin(cost))
                if cost[k] < best[2]:
                    best = (int(axis), float(pos[k]), float(cost[k]))
            if best[0] is not None:
                break  # largest-extent axis produced a candidate
        axis, split, cost = best
        if axis is None:
            return make_leaf(idx)
        if cost > old_cost:
            bad_refines += 1
        if (cost > 4.0 * old_cost and len(idx) < 16) or bad_refines == 3:
            return make_leaf(idx)
        lmask = lo[idx, axis] < split
        rmask = hi[idx, axis] > split
        li = idx[lmask | (~lmask & ~rmask)]  # degenerate flat prims: below
        ri = idx[rmask]
        node = len(split_l)
        split_l.append(split)
        meta_l.append(axis)
        offset_l.append(0)  # patched after the below subtree is built
        b_hi = nb_hi.copy()
        b_hi[axis] = split
        rec(li, nb_lo, b_hi, depth - 1, bad_refines)
        above = len(split_l)
        offset_l[node] = above
        b_lo = nb_lo.copy()
        b_lo[axis] = split
        rec(ri, b_lo, nb_hi, depth - 1, bad_refines)
        return node

    if T:
        rec(np.arange(T), wb_lo.copy(), wb_hi.copy(), max_depth, 0)
    else:
        make_leaf(np.zeros(0, np.int64))

    return KdTree(
        split=np.asarray(split_l, np.float32),
        meta=np.asarray(meta_l, np.int32),
        offset=np.asarray(offset_l, np.int32),
        prims=np.asarray(prim_out if prim_out else [0], np.int32),
        bounds=np.stack([wb_lo, wb_hi]).astype(np.float32),
    )


def intersect_kd(scene, o, d, t_max, any_hit: bool = False):
    """Wavefront kd-tree traversal (ref: kdtreeaccel.cpp::Intersect —
    the todo[] stack of (node, tMin, tMax) becomes per-ray SoA stacks).

    Returns a Hit compatible with ops/intersect.intersect_bvh."""
    from . import intersect as isectlib

    N = o.shape[0]
    inv_d = jnp.where(jnp.abs(d) > 1e-12,
                      1.0 / jnp.where(d == 0, 1.0, d),
                      jnp.where(d >= 0, 1e30, -1e30))

    # clip to world bounds (ref: kdtreeaccel.cpp bounds.IntersectP entry)
    blo = scene.kd_bounds[0][None, :]
    bhi = scene.kd_bounds[1][None, :]
    tlo = (blo - o) * inv_d
    thi = (bhi - o) * inv_d
    tmin0 = jnp.maximum(jnp.max(jnp.minimum(tlo, thi), axis=-1), 0.0)
    tmax0 = jnp.minimum(jnp.min(jnp.maximum(tlo, thi), axis=-1) * 1.0000004,
                        t_max)
    enter = tmin0 <= tmax0

    node0 = jnp.where(enter, 0, -1).astype(jnp.int32)
    stack_n0 = jnp.zeros((N, STACK_DEPTH), jnp.int32)
    stack_lo0 = jnp.zeros((N, STACK_DEPTH), jnp.float32)
    stack_hi0 = jnp.zeros((N, STACK_DEPTH), jnp.float32)
    sp0 = jnp.zeros(N, jnp.int32)
    t0 = t_max
    prim0 = jnp.full(N, -1, jnp.int32)

    def cond(st):
        return jnp.any(st[0] >= 0)

    def body(st):
        (node, smin, smax, stack_n, stack_lo, stack_hi, sp,
         t, prim, b1, b2) = st
        active = node >= 0
        nid = jnp.maximum(node, 0)
        meta = jnp.take(scene.kd_meta, nid)
        axis = meta & 3
        is_leaf = axis == 3
        count = meta >> 2
        off = jnp.take(scene.kd_offset, nid)
        split = jnp.take(scene.kd_split, nid)

        # early out: closest hit already nearer than this subtree
        active = active & (smin <= t)

        # ---- leaf: unrolled prim tests through the id indirection ----
        leaf_hit = active & is_leaf
        for k in range(MAX_PRIMS):
            m = leaf_hit & (k < count)
            pidx = jnp.clip(off + k, 0, scene.kd_prims.shape[0] - 1)
            pid = jnp.take(scene.kd_prims, pidx)
            tr = jnp.take(scene.tris_packed, pid, axis=0)
            tv, tt, tu, tvv = isectlib._moller(o, d, tr[:, 0:3],
                                               tr[:, 3:6], tr[:, 6:9], t)
            upd = m & tv
            t = jnp.where(upd, tt, t)
            prim = jnp.where(upd, pid, prim)
            b1 = jnp.where(upd, tu, b1)
            b2 = jnp.where(upd, tvv, b2)

        # ---- interior: plane test, pick near/far ----
        interior = active & ~is_leaf
        ax = jnp.clip(axis, 0, 2)
        o_ax = jnp.take_along_axis(o, ax[:, None], axis=-1)[:, 0]
        inv_ax = jnp.take_along_axis(inv_d, ax[:, None], axis=-1)[:, 0]
        d_ax = jnp.take_along_axis(d, ax[:, None], axis=-1)[:, 0]
        tplane = (split - o_ax) * inv_ax
        below_first = (o_ax < split) | ((o_ax == split) & (d_ax <= 0))
        first = jnp.where(below_first, nid + 1, off)
        second = jnp.where(below_first, off, nid + 1)
        # NB: pbrt's ordered if/else — the "near only" test wins when both
        # hold (tplane <= 0 also satisfies tplane < smin for smin >= 0)
        only_near = (tplane > smax) | (tplane <= 0.0)
        only_far = (tplane < smin) & ~only_near
        both = interior & ~only_near & ~only_far
        # push far child with (tplane, smax)
        push_sp = jnp.minimum(sp, STACK_DEPTH - 1)
        lane = jnp.arange(STACK_DEPTH)[None, :] == push_sp[:, None]
        stack_n = jnp.where(both[:, None] & lane, second[:, None], stack_n)
        stack_lo = jnp.where(both[:, None] & lane, tplane[:, None], stack_lo)
        stack_hi = jnp.where(both[:, None] & lane, smax[:, None], stack_hi)
        sp = jnp.where(both, push_sp + 1, sp)

        nxt_int = jnp.where(only_far, second, first)
        nmax_int = jnp.where(both, tplane, smax)

        # ---- advance: interior descends; leaf (or done) pops ----
        need_pop = active & (is_leaf | ~active)
        can_pop = sp > 0
        pop_sp = jnp.maximum(sp - 1, 0)
        pn = jnp.take_along_axis(stack_n, pop_sp[:, None], axis=-1)[:, 0]
        plo = jnp.take_along_axis(stack_lo, pop_sp[:, None], axis=-1)[:, 0]
        phi = jnp.take_along_axis(stack_hi, pop_sp[:, None], axis=-1)[:, 0]

        pop_now = (active & is_leaf) | (~active & (node >= 0))
        nxt = jnp.where(interior, nxt_int,
                        jnp.where(pop_now & can_pop, pn, -1))
        smin = jnp.where(interior, smin, jnp.where(pop_now & can_pop,
                                                   plo, smin))
        smax = jnp.where(interior, nmax_int,
                         jnp.where(pop_now & can_pop, phi, smax))
        sp = jnp.where(pop_now & can_pop, pop_sp, sp)
        del need_pop

        if any_hit:
            nxt = jnp.where(prim >= 0, -1, nxt)

        return (nxt, smin, smax, stack_n, stack_lo, stack_hi, sp,
                t, prim, b1, b2)

    st = (node0, tmin0, tmax0, stack_n0, stack_lo0, stack_hi0, sp0,
          t0, prim0, jnp.zeros(N, jnp.float32), jnp.zeros(N, jnp.float32))
    st = jax.lax.while_loop(cond, body, st)
    t, prim, b1, b2 = st[7], st[8], st[9], st[10]
    return isectlib.Hit(t=t, prim=prim, b1=b1, b2=b2, valid=prim >= 0)
