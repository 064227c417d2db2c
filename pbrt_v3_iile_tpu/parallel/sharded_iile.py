"""Mesh-sharded IILE pipeline (BASELINE config 5: progressive IILE,
multi-host tile-sharded).

Decomposition per schedule task (SURVEY P1/P2/P4 + the probe
halo-exchange called out in SURVEY §5 "long-context analogue"):

  stage               sharding                      collective
  ------------------- ----------------------------- -------------------------
  probe G-buffers     probe batch over (dp, tile)   —
  CNN inference       probe batch over (dp, tile)   —
  probe maps/frames   replicated after gather       all_gather over the mesh
                                                    (the halo exchange: every
                                                    pixel needs its 4 probe
                                                    neighbors, which live on
                                                    other shards)
  pixel MIS           pixels over (dp, tile)        —
  film accumulation   scatter-add per shard         psum at task end

The direct progressive passes reuse parallel/sharded.py's row-sharded
path pass.  Reference analogue: iispt.cpp:358-453 render_normal_2 with
the MOD/MATCH multi-process sharding of iispt.cpp:479-505 replaced by
mesh axes + collectives.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..integrators import iispt as iisptlib
from ..integrators import path as pathlib_
from ..integrators import probes as probelib
from ..integrators import schedule as schedlib
from ..ops import camera as camlib
from ..ops import film as filmlib
from ..ops import samplers as smplr
from ..utils import vecmath as vm
from . import mesh as meshlib
from . import sharded as shardedlib


def _pad_to(x, n, fill=0):
    p = n - x.shape[0]
    if p <= 0:
        return x
    pad_width = [(0, p)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=fill)


@functools.lru_cache(maxsize=8)
def _task_fn_cache(key):
    return {}


def _probe_stage(scene, cam, net, net_vars, key, coords, hemi_size,
                 cam_kind):
    """Probe shard body (shared by the shard_map task and the serial
    oracle — the per-shard keying depends only on the DATA slice, never
    on the axis index, so slice-for-slice serial execution reproduces
    the mesh execution bitwise)."""
    kj = smplr.wave_key(key, 2, 0, smplr.DIM_PIXEL_JITTER)
    kj = jax.random.fold_in(kj, coords[0, 0] * 7919 + coords[0, 1])
    jit_p = smplr.uniform(kj, coords.shape)
    p_film = coords.astype(jnp.float32) + jit_p
    o, d = camlib.generate_rays(cam, p_film, kind=cam_kind)
    fi = probelib.find_first_nonspecular(scene, o, d, key)
    probe_valid_l = fi["found"] & (vm.luminance(fi["beta"]) > 0.0)
    gb = probelib.render_probes(scene, fi["p"], fi["n"], key,
                                hemi_size)
    from ..models import transforms as nnx
    x_in, aux = nnx.probe_to_network_input(gb.intensity, gb.normals,
                                           gb.distance)
    y_out = net.apply(net_vars, x_in, train=False)
    R_l = nnx.network_output_to_radiance(y_out, aux)
    R_l = jnp.where(probe_valid_l[:, None, None, None], R_l, 0.0)
    return R_l, probe_valid_l, gb


def _pixel_stage(scene, cam, key, R, probe_valid, g_right, g_up, g_look,
                 g_origin, coords_all, fx, fy, n_ids, in_img, ts,
                 hemi_size, cam_kind, W, H):
    """Pixel shard body (same sharing contract as _probe_stage)."""
    kpj = smplr.wave_key(key, 3, 0, smplr.DIM_PIXEL_JITTER)
    kpj = jax.random.fold_in(kpj, fx[0] * 31 + fy[0])
    jit_f = smplr.uniform(kpj, (fx.shape[0], 2))
    pf = jnp.stack([fx, fy], axis=-1).astype(jnp.float32) + jit_f
    fo, fd = camlib.generate_rays(cam, pf, kind=cam_kind)
    kf = jax.random.fold_in(key, fx[0] * 131 + fy[0])
    ff = probelib.find_first_nonspecular(scene, fo, fd, kf)
    rgb, valid = iisptlib._mis_stage(
        scene, cam, R, probe_valid, g_look, g_origin, g_right, g_up,
        g_look, coords_all, n_ids, fx, fy, in_img,
        ff["found"], ff["beta"], ff["p"], ff["n"], ff["wo"],
        ff["mat"], ff["uv"], jax.random.fold_in(kf, 9),
        ts, hemi_size)
    flat_idx = jnp.where(in_img, fy * W + fx, W * H)
    return flat_idx, rgb, valid


def task_serial_oracle(sd, hemi_size, net, scene, cam, net_vars, key,
                       coords, fx, fy, n_ids, in_img, ts, n_shards):
    """Single-device oracle for make_sharded_task_fn: processes the same
    shard slices sequentially with the identical data-derived keys, so
    its outputs match the mesh execution bitwise (tests/test_multichip
    per-pixel equality; SURVEY P1/P6 determinism contract)."""
    W, H = sd.film.x_resolution, sd.film.y_resolution
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    Pp = coords.shape[0] // n_shards
    Px = fx.shape[0] // n_shards
    Rs, vs, gbs = [], [], []
    for i in range(n_shards):
        R_l, pv_l, gb = _probe_stage(
            scene, cam, net, net_vars, key,
            coords[i * Pp:(i + 1) * Pp], hemi_size, cam_kind)
        Rs.append(R_l)
        vs.append(pv_l)
        gbs.append(gb)
    R = jnp.concatenate(Rs)
    probe_valid = jnp.concatenate(vs)
    g_right = jnp.concatenate([g.right for g in gbs])
    g_up = jnp.concatenate([g.up for g in gbs])
    g_look = jnp.concatenate([g.look for g in gbs])
    g_origin = jnp.concatenate([g.origin for g in gbs])
    coords_all = coords.astype(jnp.float32)
    outs = []
    for i in range(n_shards):
        sl = slice(i * Px, (i + 1) * Px)
        outs.append(_pixel_stage(
            scene, cam, key, R, probe_valid, g_right, g_up, g_look,
            g_origin, coords_all, fx[sl], fy[sl], n_ids[sl], in_img[sl],
            ts, hemi_size, cam_kind, W, H))
    return tuple(jnp.concatenate([o[j] for o in outs]) for j in range(3))


def make_sharded_task_fn(sd, mesh, hemi_size: int, net):
    """Returns f(scene, cam, net_vars, key, coords, fx, fy, n_ids, in_img,
    ts) -> (flat_idx, rgb, valid) with probes AND pixels sharded over the
    whole mesh and an explicit all_gather halo exchange between the two
    stages.  coords: (Pp, 2) probe anchors (padded to a multiple of the
    device count); fx/fy/n_ids/in_img: (Npix,) pixel work list (padded).
    """
    W, H = sd.film.x_resolution, sd.film.y_resolution
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    axes = (meshlib.AXIS_DP, meshlib.AXIS_TILE)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axes), P(axes), P(axes),
                  P(axes), P(axes), P()),
        out_specs=(P(axes), P(axes), P(axes)),
        check_vma=False)
    def task_shard(scene, cam, net_vars, key, coords, fx, fy, n_ids,
                   in_img, ts):
        # ---- probe stage (local probe shard) ----
        R_l, probe_valid_l, gb = _probe_stage(
            scene, cam, net, net_vars, key, coords, hemi_size,
            cam_kind)

        # ---- halo exchange: gather ALL probes to every shard ----
        def gather(x):
            x = jax.lax.all_gather(x, meshlib.AXIS_TILE, axis=0, tiled=True)
            return jax.lax.all_gather(x, meshlib.AXIS_DP, axis=0, tiled=True)

        R = gather(R_l)
        probe_valid = gather(probe_valid_l)
        g_right, g_up, g_look = (gather(gb.right), gather(gb.up),
                                 gather(gb.look))
        g_origin = gather(gb.origin)
        coords_all = gather(coords).astype(jnp.float32)

        # ---- pixel stage (local pixel shard) ----
        return _pixel_stage(
            scene, cam, key, R, probe_valid, g_right, g_up, g_look,
            g_origin, coords_all, fx, fy, n_ids, in_img, ts, hemi_size,
            cam_kind, W, H)

    return jax.jit(task_shard)


def render_iile_sharded(sd, mesh, net_vars=None, seed: int = 0,
                        indirect_tasks: int = 4, direct_samples: int = 4,
                        hemi_size: int = 16, radius_start: float = 100.0,
                        report=None):
    """Full IILE render with every heavy stage sharded over the mesh.
    Semantics match integrators/iispt.py render_iile (same schedule, same
    estimator); sampling streams differ in shard-local shapes so the
    output is statistically (not bitwise) equal to the single-device
    render.  Returns (combined, direct, indirect, stats)."""
    import time

    from ..integrators import render as renderlib
    from ..models import iisptnet

    scene, cam = renderlib.build(sd, accel="bvh")
    W, H = sd.film.x_resolution, sd.film.y_resolution
    nd = mesh.devices.size
    key = jax.random.PRNGKey(seed)

    net = iisptnet.IISPTNet()
    if net_vars is None:
        net_vars = net.init(jax.random.PRNGKey(42),
                            jnp.zeros((1, hemi_size, hemi_size, 7)),
                            train=False)

    t0 = time.time()
    task_fn = make_sharded_task_fn(sd, mesh, hemi_size, net)
    tasks = schedlib.compute_schedule(W, H, indirect_tasks,
                                      radius_start=radius_start)
    G = schedlib.NUMBER_TILES + 1
    Pp = ((G * G + nd - 1) // nd) * nd  # probe count padded to mesh

    ind_rgb = jnp.zeros((W * H + 1, 3), jnp.float32)
    ind_cnt = jnp.zeros((W * H + 1,), jnp.float32)
    for task in tasks:
        tkey = jax.random.fold_in(key, 1000 + task.task_number)
        ts = task.tilesize
        task_size = schedlib.NUMBER_TILES * ts
        coords = iisptlib.task_probe_coords(
            jnp.int32(task.x0), jnp.int32(task.y0), ts, W, H)
        coords = _pad_to(coords, Pp)
        # pixel work list: only the task's in-image rectangle, padded to
        # the device count (host-side layout, device-side trace)
        x1 = min(task.x0 + task_size, W)
        y1 = min(task.y0 + task_size, H)
        wx = max(x1 - task.x0, 1)
        wy = max(y1 - task.y0, 1)
        npix = ((wx * wy + nd - 1) // nd) * nd
        li = np.arange(npix)
        lx = li % wx
        ly = np.minimum(li // wx, wy - 1)
        fx = np.asarray(task.x0 + lx, np.int32)
        fy = np.asarray(task.y0 + ly, np.int32)
        in_img = (fx < x1) & (fy < y1) & (li < wx * wy)
        gi = np.clip(lx // ts, 0, G - 2)
        gj = np.clip(ly // ts, 0, G - 2)
        n_ids = np.stack([
            gj * G + gi, (gj + 1) * G + gi + 1,
            gj * G + gi + 1, (gj + 1) * G + gi,
        ], axis=-1).astype(np.int32)
        idx, rgb, valid = task_fn(
            scene, cam, net_vars, tkey, coords, jnp.asarray(fx),
            jnp.asarray(fy), jnp.asarray(n_ids), jnp.asarray(in_img),
            jnp.int32(ts))
        ind_rgb = ind_rgb.at[idx].add(rgb)
        ind_cnt = ind_cnt.at[idx].add(valid.astype(jnp.float32))
        if report is not None:
            report("indirect", task.task_number + 1, len(tasks))

    # ---- direct progressive passes, row-sharded over the mesh ----
    dcfg = pathlib_.PathConfig(
        max_depth=sd.integrator.max_depth, nee=True, nee_all=True,
        direct_only=True)
    drun = shardedlib.sharded_render_pass(sd, mesh, cfg=dcfg)
    dir_film = filmlib.new_film(H, W)
    for p in range(direct_samples):
        L, jitter = drun(scene, cam, jax.random.fold_in(key, 5000), p)
        dir_film = filmlib.add_sample_image(dir_film, L, jitter)
        if report is not None:
            report("direct", p + 1, direct_samples)

    ind_img = (ind_rgb[:W * H] / jnp.maximum(ind_cnt[:W * H, None], 1.0)
               ).reshape(H, W, 3)
    dir_img = filmlib.resolve(dir_film)
    combined = dir_img + ind_img
    return (np.asarray(combined), np.asarray(dir_img),
            np.asarray(ind_img),
            dict(seconds=time.time() - t0, tasks=len(tasks)))
