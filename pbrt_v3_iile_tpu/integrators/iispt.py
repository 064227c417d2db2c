"""The IILE / IISPT integrator: one-shot neural indirect + progressive
direct lighting.

Wavefront re-architecture of IISPTIntegrator::render_normal_2 and
IisptRenderRunner (ref: src/integrators/iispt.cpp:358-453,
iisptrenderrunner.cpp):

reference (CPU threads + python child pipes)     this module (one device graph)
------------------------------------------------ ------------------------------
ThreadPool of runners pulling mutex'd tasks       precomputed schedule, one
                                                  jitted launch per task
per-probe 32x32 RenderView, single-threaded       batched probe wavefront
stdio float32 pipe to per-thread PyTorch child    in-graph U-Net call
4-neighbor weight + MIS loop per pixel            vectorized (Npix, 4, S)
                                                  slot tensor ops
mutex'd IisptFilmMonitor.add_n_samples            scatter-add into flat film

Estimator parity: the per-pixel hemisphere MIS estimate reproduces
estimate_direct / sample_hemisphere (iisptrenderrunner.cpp:16-178)
including lightPdf = 1/6.28, the empirical BSDF_RATIO = 0.4394 /
EM_RATIO = 1.098 constants, HEMISPHERIC_IMPORTANCE_SAMPLES = 16 attempts
per neighbor camera, and the sin(theta) map Jacobian
(intensityfilm.cpp:60-66).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..models import iisptnet
from ..models import transforms as nnx
from ..ops import bsdf as bsdflib
from ..ops import camera as camlib
from ..ops import film as filmlib
from ..ops import samplers as smplr
from ..ops import sampling as smp
from ..utils import vecmath as vm
from . import path as pathlib_
from . import probes as probelib
from . import schedule as schedlib

HEMISPHERIC_IMPORTANCE_SAMPLES = 16   # (ref: iisptrenderrunner.h:33)
LIGHT_PDF = 1.0 / 6.28                # (ref: iisptrenderrunner.cpp:31)
BSDF_RATIO = 0.4394                   # (ref: iisptrenderrunner.cpp:33)
EM_RATIO = 1.098                      # (ref: iisptrenderrunner.cpp:34)


# ---------------------------------------------------------------------------
# per-task probe grid
# ---------------------------------------------------------------------------

def task_probe_coords(x0, y0, ts: int, width: int, height: int):
    """(G+1)^2 probe pixel coordinates for a task anchored at (x0, y0)
    with tilesize ts (static); positions are multiples of ts clamped to
    the task/image edge (ref: iisptrenderrunner.cpp:380-420 tile
    advance with min(x + tilesize, x1 - 1))."""
    G = schedlib.NUMBER_TILES + 1
    i = jnp.arange(G)
    xs = jnp.minimum(x0 + i * ts, jnp.minimum(x0 + schedlib.NUMBER_TILES * ts,
                                              width) - 1)
    ys = jnp.minimum(y0 + i * ts, jnp.minimum(y0 + schedlib.NUMBER_TILES * ts,
                                              height) - 1)
    gx, gy = jnp.meshgrid(xs, ys)  # (G, G)
    return jnp.stack([gx, gy], axis=-1).reshape(-1, 2)  # (G*G, 2)


# ---------------------------------------------------------------------------
# hemisphere radiance lookup helpers
# ---------------------------------------------------------------------------

def _map_lookup_jacobian(R, probe_id, x, y, hemi_size):
    """R: (P,H,W,3); returns R[probe, y, x] * sin(pi*(y+.5)/H)
    (ref: intensityfilm.cpp get_camera_coord_jacobian)."""
    v = R[probe_id, y, x]
    theta = jnp.pi * (y.astype(jnp.float32) + 0.5) / hemi_size
    return v * jnp.sin(theta)[..., None]


def _pixel_to_dir(x, y, right, up, look, hemi_size):
    """Probe pixel -> world direction (ref: hemispheric.cpp:89-105)."""
    theta = jnp.pi * (y.astype(jnp.float32) + 0.5) / hemi_size
    phi = jnp.pi * (x.astype(jnp.float32) + 0.5) / hemi_size
    st = jnp.sin(theta)
    dc = jnp.stack([st * jnp.cos(phi), jnp.cos(theta), st * jnp.sin(phi)],
                   axis=-1)
    return (dc[..., 0:1] * right + dc[..., 1:2] * up + dc[..., 2:3] * look)


# ---------------------------------------------------------------------------
# per-task indirect estimation
# ---------------------------------------------------------------------------

_ANCHOR_CACHE = {}
_DFN_CACHE = {}


def _anchor_fns(sd, hemi_size, net):
    """Cached jitted sub-stages shared by all tasks (shapes vary only in
    the pixel-chunk dimension, handled by jit's shape cache).  The cache
    is PROCESS-LEVEL, keyed on (film dims, hemi, camera kind, net): a
    fresh render_iile call with the same configuration reuses the jitted
    closures instead of recompiling the whole probe pipeline (observed
    ~10 min per 512^2 sweep entry without it)."""
    W, H = sd.film.x_resolution, sd.film.y_resolution
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    ckey = (W, H, hemi_size, cam_kind, net)
    if ckey in _ANCHOR_CACHE:
        return _ANCHOR_CACHE[ckey]

    @jax.jit
    def probe_rays(cam, key, coords):
        kj = smplr.wave_key(key, 2, 0, smplr.DIM_PIXEL_JITTER)
        jit_p = smplr.uniform(kj, coords.shape)
        p_film = coords.astype(jnp.float32) + jit_p
        return camlib.generate_rays(cam, p_film, kind=cam_kind)

    @jax.jit
    def cnn(net_vars, intensity, normals, distance, probe_valid):
        x_in, aux = nnx.probe_to_network_input(intensity, normals, distance)
        y_out = net.apply(net_vars, x_in, train=False)
        R = nnx.network_output_to_radiance(y_out, aux)
        return jnp.where(probe_valid[:, None, None, None], R, 0.0)

    @jax.jit
    def pixel_rays(cam, key, fx, fy):
        kpj = smplr.wave_key(key, 3, 0, smplr.DIM_PIXEL_JITTER)
        jit_f = smplr.uniform(kpj, (fx.shape[0], 2))
        pf = jnp.stack([fx, fy], axis=-1).astype(jnp.float32) + jit_f
        return camlib.generate_rays(cam, pf, kind=cam_kind)

    fns = dict(probe_rays=probe_rays, cnn=cnn, pixel_rays=pixel_rays)
    _ANCHOR_CACHE[ckey] = fns
    return fns


@functools.partial(jax.jit, static_argnames=("hemi_size",))
def _mis_stage(scene, cam, R, probe_valid, cam_look, cam_orig, right, up,
               look, coords_f, n_ids, fx, fy, in_img, ff_found, ff_beta,
               ff_p, ff_n, ff_wo, ff_mat, ff_uv, key, ts, hemi_size):
    """Per-pixel-chunk hemisphere MIS estimation (the vectorized
    sample_hemisphere/estimate_direct, ref iisptrenderrunner.cpp:16-178).
    All probe data comes in as arrays; ts is traced (no recompile per
    radius)."""
    Np = fx.shape[0]
    S = HEMISPHERIC_IMPORTANCE_SAMPLES
    px_valid = in_img & ff_found & (vm.luminance(ff_beta) > 0.0)

    n_px = coords_f[n_ids]                        # (Np, 4, 2)
    cam_valid_n = probe_valid[n_ids]              # (Np, 4)
    cam_look_n = cam_look[n_ids]                  # (Np, 4, 3)
    cam_orig_n = cam_orig[n_ids]                  # (Np, 4, 3)

    # ---- weights (ref: compute_fpixel_weights :961-1037) ----
    fpix = jnp.stack([fx, fy], axis=-1).astype(jnp.float32)[:, None, :]
    pdist = jnp.sqrt(jnp.sum((fpix - n_px) ** 2, axis=-1))
    wdpos = jnp.clip(pdist / ts.astype(jnp.float32), 0.0, 1.0)
    ndot = jnp.sum(ff_n[:, None, :] * cam_look_n, axis=-1)
    wdnor = jnp.where(cam_valid_n,
                      jnp.where(ndot < 0.0, 1.0, 1.0 - ndot), 0.0)
    cam_o = camlib.camera_position(cam)
    d_isect = jnp.sqrt(jnp.sum((ff_p - cam_o) ** 2, axis=-1))
    d_probe = jnp.sqrt(jnp.sum((cam_orig_n - cam_o) ** 2, axis=-1))
    rel_err = jnp.abs(d_isect[:, None] - d_probe) / jnp.maximum(
        d_isect[:, None], 1e-10)
    wdd = jnp.where(cam_valid_n & (d_isect[:, None] >= 1e-10),
                    jnp.clip(1.0 - rel_err, 0.0, 1.0), 0.0)
    wod = wdpos * wdnor + wdpos * wdd + wdpos
    w_raw = jnp.maximum(0.0, 2.0 - wod) + 0.001
    w_prob = w_raw / jnp.maximum(jnp.sum(w_raw, axis=-1, keepdims=True),
                                 1e-12)

    # ---- shading data ----
    params = bsdflib.gather_params(scene, jnp.maximum(ff_mat, 0),
                                   uv=ff_uv, p=ff_p)
    ns = ff_n
    t_f, b_f = vm.coordinate_system(ns)
    wo_l = vm.to_local(ff_wo, t_f, b_f, ns)

    # ---- MIS sampling slots (Np, 4, S) ----
    ku = smplr.wave_key(key, 4, 0, smplr.DIM_HEMI)
    u_sel = smplr.uniform(ku, (Np, 4, S))
    selected = u_sel < w_prob[:, :, None]
    kxy = smplr.wave_key(key, 4, 1, smplr.DIM_HEMI)
    u_xy = smplr.uniform(kxy, (Np, 4, S, 2))
    rx = jnp.minimum((u_xy[..., 0] * hemi_size).astype(jnp.int32),
                     hemi_size - 1)
    ry = jnp.minimum((u_xy[..., 1] * hemi_size).astype(jnp.int32),
                     hemi_size - 1)
    kbs = smplr.wave_key(key, 4, 2, smplr.DIM_BSDF_DIR)
    u_bs = smplr.uniform(kbs, (Np, 4, S, 2))
    kbl = smplr.wave_key(key, 4, 3, smplr.DIM_BSDF_LOBE)
    u_bl = smplr.uniform(kbl, (Np, 4, S))

    probe_ids = jnp.broadcast_to(n_ids[:, :, None], (Np, 4, S))
    pr = right[probe_ids]
    pu = up[probe_ids]
    pl = look[probe_ids]

    # --- strategy 1: hemisphere-map sampling ---
    Li1 = _map_lookup_jacobian(R, probe_ids, rx, ry, hemi_size)
    wi1_w = _pixel_to_dir(rx, ry, pr, pu, pl, hemi_size)
    wi1_l = vm.to_local(wi1_w,
                        t_f[:, None, None, :], b_f[:, None, None, :],
                        ns[:, None, None, :])
    params_b = jax.tree.map(
        lambda a: a[:, None, None] if a.ndim == 1 else a[:, None, None, :],
        params)
    f1, pdf1 = bsdflib.evaluate(params_b,
                                jnp.broadcast_to(wo_l[:, None, None, :],
                                                 wi1_l.shape), wi1_l)
    cos1 = jnp.abs(wi1_l[..., 2])
    w1 = smp.power_heuristic(1.0, LIGHT_PDF, 1.0, pdf1)
    c1 = EM_RATIO * f1 * Li1 * (cos1 * w1 / LIGHT_PDF)[..., None]
    c1 = jnp.where((vm.luminance(Li1) > 0.0)[..., None], c1, 0.0)

    # --- strategy 2: bsdf sampling + map lookup ---
    bs = bsdflib.sample(params_b,
                        jnp.broadcast_to(wo_l[:, None, None, :],
                                         wi1_l.shape),
                        u_bl, u_bs)
    wi2_w = vm.to_world(bs.wi, t_f[:, None, None, :],
                        b_f[:, None, None, :], ns[:, None, None, :])
    x2, y2, ok2 = camlib.hemi_dir_to_pixel(wi2_w, pr, pu, pl, hemi_size)
    Li2 = _map_lookup_jacobian(R, probe_ids, jnp.clip(x2, 0, hemi_size - 1),
                               jnp.clip(y2, 0, hemi_size - 1), hemi_size)
    Li2 = jnp.where(ok2[..., None], Li2, 0.0)
    cos2 = jnp.abs(bs.wi[..., 2])
    w2 = jnp.where(bs.is_specular, 1.0,
                   smp.power_heuristic(1.0, bs.pdf, 1.0, LIGHT_PDF))
    c2 = BSDF_RATIO * bs.f * Li2 * (cos2 * w2 / jnp.maximum(
        bs.pdf, 1e-12))[..., None]
    c2 = jnp.where((bs.valid & (vm.luminance(Li2) > 0.0))[..., None],
                   c2, 0.0)

    contrib = jnp.where(selected[..., None], c1 + c2, 0.0)
    taken = jnp.sum(selected, axis=(1, 2))
    Lh = jnp.sum(contrib, axis=(1, 2)) / jnp.maximum(
        taken, 1)[:, None].astype(jnp.float32)
    Lh = jnp.where((taken > 0)[:, None], Lh, 0.0)

    rgb = ff_beta * Lh
    rgb = jnp.where(jnp.isfinite(rgb), rgb, 0.0)
    return jnp.where(px_valid[:, None], rgb, 0.0), px_valid


PIXEL_CHUNK = 65536


@functools.lru_cache(maxsize=16)
def _ff_fn(accel: str):
    """Cached jitted specular-chase wrapper: calling
    find_first_nonspecular eagerly would re-lower its 24-step lax.scan
    on every task and pixel chunk."""
    @jax.jit
    def f(scene, o, d, key):
        return probelib.find_first_nonspecular(scene, o, d, key,
                                               accel=accel)
    return f


@functools.lru_cache(maxsize=16)
def _probes_fn(hemi_size: int, accel: str):
    """Cached jitted probe G-buffer render (same reason as _ff_fn)."""
    @jax.jit
    def f(scene, positions, normals, key):
        return probelib.render_probes(scene, positions, normals, key,
                                      hemi_size, accel=accel)
    return f


def run_task(scene, cam, sd, net, net_vars, fns, key, task,
             hemi_size: int = 32, accel: str = "bvh"):
    """Execute one schedule task: probes -> CNN -> per-pixel MIS.
    Host-driven stages (small device programs); returns
    (flat_idx (Np,), rgb (Np,3), valid (Np,)) as device arrays."""
    W, H = sd.film.x_resolution, sd.film.y_resolution
    G = schedlib.NUMBER_TILES + 1
    ts = task.tilesize
    task_size = schedlib.NUMBER_TILES * ts

    # ---- probe anchors ----
    coords = task_probe_coords(jnp.int32(task.x0), jnp.int32(task.y0),
                               ts, W, H)
    o, d = fns["probe_rays"](cam, key, coords)
    fi = _ff_fn(accel)(scene, o, d, key)
    probe_valid = fi["found"] & (vm.luminance(fi["beta"]) > 0.0)

    # ---- probe render + CNN ----
    gb = _probes_fn(hemi_size, accel)(scene, fi["p"], fi["n"], key)
    R = fns["cnn"](net_vars, gb.intensity, gb.normals, gb.distance,
                   probe_valid)

    # ---- pixels, chunked (only the task's in-image rectangle; a task
    # whose nominal task_size overhangs the image edge must not spend
    # waves on out-of-image pixels) ----
    coords_f = coords.astype(jnp.float32)
    x1 = min(task.x0 + task_size, W)
    y1 = min(task.y0 + task_size, H)
    wx = max(x1 - task.x0, 1)
    wy = max(y1 - task.y0, 1)
    idx_all, rgb_all, val_all = [], [], []
    npix = wx * wy
    # chunk shape from a FIXED ladder (overhang masked by in_img): a
    # varying tail size would recompile every jitted pixel stage per
    # task, while one giant fixed chunk wastes 20x+ compute on the
    # small late-schedule tasks
    chunk = next(c for c in (8192, 16384, 32768, PIXEL_CHUNK)
                 if c >= min(npix, PIXEL_CHUNK))
    for c0 in range(0, npix, chunk):
        li = jnp.arange(c0, c0 + chunk)
        lx = (li % wx)
        ly = jnp.minimum(li // wx, wy - 1)
        fx = task.x0 + lx
        fy = task.y0 + ly
        in_img = (fx < x1) & (fy < y1) & (li < npix)
        fo, fd = fns["pixel_rays"](cam, jax.random.fold_in(key, 7 + c0),
                                   fx, fy)
        ff = _ff_fn(accel)(scene, fo, fd, jax.random.fold_in(key, 8 + c0))
        gi = jnp.clip(lx // ts, 0, G - 2)
        gj = jnp.clip(ly // ts, 0, G - 2)
        n_ids = jnp.stack([
            gj * G + gi,            # S (ref ordering, iisptrenderrunner:434)
            (gj + 1) * G + gi + 1,  # E
            gj * G + gi + 1,        # R
            (gj + 1) * G + gi,      # B
        ], axis=-1)
        rgb, valid = _mis_stage(
            scene, cam, R, probe_valid, gb.look, gb.origin, gb.right,
            gb.up, gb.look, coords_f, n_ids, fx, fy, in_img,
            ff["found"], ff["beta"], ff["p"], ff["n"], ff["wo"],
            ff["mat"], ff["uv"], jax.random.fold_in(key, 9 + c0),
            jnp.int32(ts), hemi_size)
        flat_idx = jnp.where(in_img, fy * W + fx, W * H)
        idx_all.append(flat_idx)
        rgb_all.append(rgb)
        val_all.append(valid)
    return (jnp.concatenate(idx_all), jnp.concatenate(rgb_all),
            jnp.concatenate(val_all))


# ---------------------------------------------------------------------------
# full IILE render
# ---------------------------------------------------------------------------

def render_iile(sd, net_vars=None, seed: int = 0,
                indirect_tasks: int = 16, direct_samples: int = 16,
                hemi_size: int = 32, use_native_bvh: bool = True,
                radius_start: float = 100.0, report=None):
    """Full IILE render (ref: iispt.cpp render_normal_2).

    Returns (combined, direct, indirect) images (H,W,3) numpy + stats.
    """
    import time
    from . import render as renderlib

    accel = renderlib.resolve_accel(sd)
    scene, cam = renderlib.build(sd, use_native_bvh=use_native_bvh,
                                 accel=accel)
    W, H = sd.film.x_resolution, sd.film.y_resolution
    key = jax.random.PRNGKey(seed)

    net = iisptnet.IISPTNet()
    if net_vars is None:
        # the committed pretrained model is the default (the reference
        # always ships/loads iispt_model.tch, ml/config.py:1); random
        # weights are a last resort and produce garbage indirect light
        import os as _os
        from ..ml import train as _trainlib
        ckpt = _trainlib.default_pretrained_path()
        if _os.path.exists(ckpt):
            net_vars = _trainlib.load_pretrained(ckpt)
        else:
            import warnings
            warnings.warn(
                "render_iile: no trained IISPTNet checkpoint found at "
                f"{ckpt} — falling back to RANDOM weights; the indirect "
                "pass will be meaningless. Train one with "
                "scripts/train_demo.py or pass net_vars=.")
            net_vars = net.init(jax.random.PRNGKey(42),
                                jnp.zeros((1, hemi_size, hemi_size, 7)),
                                train=False)

    t0 = time.time()
    # ---------- indirect ----------
    tasks = schedlib.compute_schedule(W, H, indirect_tasks,
                                      radius_start=radius_start)
    ind_rgb = jnp.zeros((W * H + 1, 3), jnp.float32)
    ind_cnt = jnp.zeros((W * H + 1,), jnp.float32)
    fns = _anchor_fns(sd, hemi_size, net)
    for task in tasks:
        tkey = jax.random.fold_in(key, 1000 + task.task_number)
        idx, rgb, valid = run_task(scene, cam, sd, net, net_vars, fns,
                                   tkey, task, hemi_size=hemi_size,
                                   accel=accel)
        ind_rgb = ind_rgb.at[idx].add(rgb)
        ind_cnt = ind_cnt.at[idx].add(valid.astype(jnp.float32))
        if report is not None:
            report("indirect", task.task_number + 1, indirect_tasks)

    # ---------- direct (progressive 1spp passes) ----------
    dcfg = pathlib_.PathConfig(
        max_depth=sd.integrator.max_depth, nee=True, nee_all=True,
        direct_only=True, accel=accel,
        # direct-only paths die after one non-specular bounce: shrink
        # the wave aggressively (unbiased budget RR, path.py)
        compact_schedule=(1.0, 0.5, 0.25, 0.25) if accel == "clusters"
        else ())
    # direct-pass fn cache: render_pass_fn + jit rebuilt per call
    # otherwise recompile the whole compacted pipeline every sweep entry
    dkey = (W, H, getattr(sd.sampler, "kind", "random"),
            sd.film.filter_name, dcfg)
    dfn = _DFN_CACHE.get(dkey)
    if dfn is None:
        dfn = jax.jit(renderlib.render_pass_fn(sd, dcfg))
        _DFN_CACHE[dkey] = dfn
    dir_film = filmlib.new_film(H, W)
    add = jax.jit(filmlib.add_sample_image)
    for p in range(direct_samples):
        L, jitter, _ = dfn(scene, cam, jax.random.fold_in(key, 5000), p)
        dir_film = add(dir_film, L, jitter)
        if report is not None:
            report("direct", p + 1, direct_samples)

    # ---------- merge (ref: iisptfilmmonitor.cpp:231-276) ----------
    ind_img = (ind_rgb[:W * H] / jnp.maximum(ind_cnt[:W * H, None], 1.0)
               ).reshape(H, W, 3)
    dir_img = filmlib.resolve(dir_film)
    combined = dir_img + ind_img
    dt = time.time() - t0
    return (np.asarray(combined), np.asarray(dir_img), np.asarray(ind_img),
            dict(seconds=dt, tasks=len(tasks)))
