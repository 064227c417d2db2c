"""Sharded render + training steps over the device mesh.

Mappings (SURVEY §2.6):
  P1 tile data-parallelism   -> image rows sharded over AXIS_TILE
  P3 CNN child processes     -> in-graph net, batch over AXIS_DP
  P7 shared mutable film     -> per-shard film rows, no mutation
  P8 training data-parallel  -> batch over mesh, grads all-reduced (psum
                                inserted by XLA from shardings)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import camera as camlib
from ..ops import samplers as smplr
from . import mesh as meshlib
from ..integrators import path as pathlib_


def sharded_render_pass(sd, mesh, cfg=None):
    """Returns jitted f(scene, cam, key, pass_idx) -> (L (H,W,3),
    jitter (H,W,2)) with the pixel wavefront sharded over EVERY mesh
    device (dp x tile) and the scene replicated.  Each device traces its
    own row block; the gather back to the full image is the only
    cross-device movement (disjoint tiles -- no reduction, ref P1/P7).

    Wave generation and keying go through render.make_wave_prep with
    row0 = the shard's first row, so a device's rows are sampled
    IDENTICALLY to the single-device chunked driver with
    chunk_rows = H/n_devices -- sharded == unsharded, bit for bit
    (tests/test_multichip.py asserts this)."""
    from ..integrators import render as renderlib

    H, W = sd.film.y_resolution, sd.film.x_resolution
    if cfg is None:
        cfg = renderlib.make_integrator_config(sd)
    n_dev = mesh.devices.size
    assert H % n_dev == 0, f"image rows {H} must divide over {n_dev} devices"
    CH = H // n_dev
    prep, is_realistic = renderlib.make_wave_prep(sd, chunk_rows=CH)

    axes = (meshlib.AXIS_DP, meshlib.AXIS_TILE)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axes)),
        out_specs=(P(axes), P(axes)),
        check_vma=False)
    def pass_rows(scene, cam, key, pass_idx, rows):
        # rows: (CH,) absolute row indices for this shard (contiguous)
        o, d, w, jitter, k, ctx, rtime = prep(cam, key, pass_idx, rows[0])
        beta0 = (jnp.broadcast_to(w[:, None], (w.shape[0], 3))
                 if is_realistic else None)
        L, _ = pathlib_.trace_paths(scene, o, d, k, cfg, beta0=beta0,
                                    sample_ctx=ctx, time=rtime)
        return L.reshape(CH, W, 3), jitter.reshape(CH, W, 2)

    def run(scene, cam, key, pass_idx):
        rows = jnp.arange(H, dtype=jnp.int32)
        return pass_rows(scene, cam, key, jnp.int32(pass_idx), rows)

    return jax.jit(run)


# ---------------------------------------------------------------------------
# sharded training step (U-Net, data-parallel over the mesh)
# ---------------------------------------------------------------------------

def make_train_step(net, optimizer, mesh, loss: str = "l1"):
    """Data-parallel train step: batch sharded over (dp, tile), params
    replicated, gradient all-reduce inserted by XLA (P8).

    loss: 'l1' (reference default, ml/main_train.py:23), 'rel_l1' or
    'rel_mse' (ref: ml/iispt_loss.py)."""
    from ..ml import losses as losslib

    batch_sharding = meshlib.shard_batch(mesh)
    rep = meshlib.replicated(mesh)
    loss_f = losslib.get(loss)

    def loss_fn(params, batch_stats, x, y):
        out, updates = net.apply(
            {"params": params, "batch_stats": batch_stats}, x, train=True,
            mutable=["batch_stats"])
        return loss_f(out, y), updates["batch_stats"]

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def step(params, batch_stats, opt_state, x, y):
        x = jax.lax.with_sharding_constraint(x, batch_sharding)
        y = jax.lax.with_sharding_constraint(y, batch_sharding)
        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, batch_stats, x, y)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        params = jax.lax.with_sharding_constraint(params, rep)
        return params, new_stats, opt_state, loss

    return step


# ---------------------------------------------------------------------------
# geometry sharding: scenes larger than one device's memory
# ---------------------------------------------------------------------------

def shard_scene_geometry(scene, mesh):
    """Partition the triangle set over the mesh for scenes whose BVH
    exceeds one device's HBM (SURVEY §5 'long-context analogue': BVH
    sharding).  Device k gets every triangle t with t % n_dev == k (the
    reference's MOD/MATCH sharding, iispt.cpp:479-505, applied to
    geometry instead of pixels) and builds its own sub-BVH; lights,
    materials and textures stay replicated.

    Returns per-device stacked DeviceScene arrays (leading axis n_dev)
    suitable for sharded_geometry_intersect."""
    import numpy as np

    from ..scene import device as devlib
    from ..ops import bvh as bvhlib

    n_dev = mesh.devices.size
    T = int(scene.tri_p0.shape[0])
    p0 = np.asarray(scene.tri_p0)
    e1 = np.asarray(scene.tri_e1)
    e2 = np.asarray(scene.tri_e2)
    tri_p = np.stack([p0, p0 + e1, p0 + e2], axis=1)  # (T,3,3)

    shards = []
    Tn = max(1, -(-T // n_dev))
    for k in range(n_dev):
        ids = np.arange(k, T, n_dev)
        sub_p = tri_p[ids] if ids.size else np.zeros((1, 3, 3), np.float32)
        gids = ids if ids.size else np.zeros(1, np.int64)
        flat = bvhlib.build_bvh(sub_p, use_native=False)
        order = flat.prim_order
        sub_p = sub_p[order]
        gids = gids[order]
        M = flat.node_min.shape[0]
        nodes_packed = np.zeros((M, 8), np.int32)
        nodes_packed[:, 0:3] = flat.node_min.astype(np.float32).view(np.int32)
        nodes_packed[:, 3:6] = flat.node_max.astype(np.float32).view(np.int32)
        nodes_packed[:, 6] = flat.node_right.astype(np.int32)
        nodes_packed[:, 7] = ((flat.node_count.astype(np.int32) << 2)
                              | flat.node_axis.astype(np.int32))
        tris_packed = np.zeros((sub_p.shape[0], 12), np.float32)
        tris_packed[:, 0:3] = sub_p[:, 0]
        tris_packed[:, 3:6] = sub_p[:, 1] - sub_p[:, 0]
        tris_packed[:, 6:9] = sub_p[:, 2] - sub_p[:, 0]
        shards.append(dict(nodes_packed=nodes_packed,
                           tris_packed=tris_packed,
                           global_id=gids.astype(np.int32)))

    # pad shards to equal sizes for stacking
    Mm = max(s["nodes_packed"].shape[0] for s in shards)
    Tm = max(s["tris_packed"].shape[0] for s in shards)
    import numpy as np

    def pad(a, n):
        out = np.zeros((n,) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        return out

    nodes = jnp.asarray(np.stack(
        [pad(s["nodes_packed"], Mm) for s in shards]))
    tris = jnp.asarray(np.stack(
        [pad(s["tris_packed"], Tm) for s in shards]))
    gids = jnp.asarray(np.stack(
        [pad(s["global_id"], Tm) for s in shards]))
    return dict(nodes_packed=nodes, tris_packed=tris, global_id=gids)


def sharded_geometry_intersect(scene, geo, mesh):
    """Returns jitted f(o, d, t_max) -> Hit against geometry sharded over
    the mesh: every device traverses the FULL ray wavefront against its
    triangle shard, then the closest hit is reduced across devices with a
    min-t argmin (an all-reduce across devices — the communication pattern of
    distributed-geometry ray tracing).  Hit.prim is the global triangle
    id, so make_interaction works against the replicated full scene."""
    from ..ops import intersect as isectlib

    axes = (meshlib.AXIS_DP, meshlib.AXIS_TILE)
    n_dev = mesh.devices.size

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axes), P(axes), P(axes), P(), P(), P()),
        out_specs=P(),
        check_vma=False)
    def walk(nodes, tris, gids, o, d, t_max):
        # local shard arrays come in with a leading length-1 axis
        sub = scene._replace(nodes_packed=nodes[0], tris_packed=tris[0])
        hit = isectlib.intersect_bvh(sub, o, d, t_max)
        gid = jnp.take(gids[0], jnp.maximum(hit.prim, 0))
        t = jnp.where(hit.valid, hit.t, jnp.inf)
        # closest-hit all-reduce: min over the device axis
        packed = jnp.stack([t, gid.astype(jnp.float32),
                            hit.b1, hit.b2], axis=-1)
        all_hits = jax.lax.all_gather(packed, axes, axis=0)  # (n_dev, N, 4)
        best = jnp.argmin(all_hits[..., 0], axis=0)          # (N,)
        sel = jnp.take_along_axis(all_hits, best[None, :, None],
                                  axis=0)[0]
        t_best = sel[:, 0]
        valid = jnp.isfinite(t_best)
        return isectlib.Hit(
            t=jnp.where(valid, t_best, t_max),
            prim=jnp.where(valid, sel[:, 1].astype(jnp.int32), -1),
            b1=sel[:, 2], b2=sel[:, 3], valid=valid)

    def run(o, d, t_max):
        return walk(geo["nodes_packed"], geo["tris_packed"],
                    geo["global_id"], o, d, t_max)

    return jax.jit(run)
