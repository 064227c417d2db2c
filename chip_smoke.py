"""Smoke check of the renderer on NVIDIA GPUs, through its own entry points.

Run from the root of a checkout:

    python chip_smoke.py          # one GPU: phases (a)-(d)
    python chip_smoke.py --four   # four GPUs: phase (a), then (e) only

Phases:
  (a) device: JAX's devices and the card's name and power limit (read by
      nvidia-smi in a child process that does not import JAX); anything
      but a GPU platform fails.
  (b) traversal: the cluster kernel, compiled for the card, on a 512^2
      primary wave and its first diffuse bounce of scenes/atrium.pbrt,
      against the XLA BVH walker; plus the dense plain-XLA cluster
      evaluator at default (TF32) and HIGHEST matmul precision.
  (c) path render: render.render (the CLI's call) on the atrium at 512^2,
      depth 6, 4 spp, against the committed oracle ground truth.
  (d) IILE: render_iile with the committed pretrained K=64 net, hemi 32,
      and the U-Net on one real probe batch on the GPU and on the CPU.
  (e) (--four) the mesh-sharded path pass and IILE on a (dp, tile) mesh
      of 4 GPUs against the single-device renders of the same scene/key.

Any failed check exits non-zero.  The last line of standard output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(HERE, "scenes", "atrium.pbrt")
ORACLE = os.path.join(HERE, "tests", "golden",
                      "atrium_gt_oracle_path320_512.npz")

# tolerances, each with its reason
HIT_AGREE_MIN = 0.999   # hit/miss may differ only for rays grazing edges
T_RTOL = 1e-3           # fp32 Pluecker vs Moller-Trumbore t
T_AGREE_MIN = 0.999     # share of common hits whose t is within T_RTOL
PRIM_EXACT_MIN = 0.99   # shared edges and coplanar duplicates tie
PATH_MEAN_RTOL = 0.10   # 4-spp global mean vs the 320-spp oracle mean
PATH_PSNR_MIN = 17.0    # 4 spp vs oracle (noise-bound, about 20 dB)
IILE_PSNR_MIN = 22.0    # 4 tasks + 4 direct passes (about 26 dB)
NET_HIGHEST_RTOL = 1e-3  # U-Net GPU vs CPU at HIGHEST: sum order only
NET_DEFAULT_RTOL = 5e-2  # U-Net GPU (TF32 convolutions) vs CPU
SHARD_PIX_AGREE_MIN = 0.99  # sharded vs single-device pass, per pixel
SHARD_MEAN_RTOL = 1e-3      # ... and its global mean
SHARD_IILE_MEAN_RTOL = 0.15  # sharded IILE: other sampling streams


class CheckFailed(Exception):
    pass


def check(cond, what):
    print(f"  [{'ok' if cond else 'FAIL'}] {what}", flush=True)
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` from a child process."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise CheckFailed(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def load_atrium():
    from pbrt_v3_iile_tpu.scene import api as apilib

    sd = apilib.load_scene(SCENE)
    check(sd.film.x_resolution == 512 and sd.film.y_resolution == 512
          and sd.integrator.max_depth == 6, "atrium is 512^2, depth 6")
    return sd


def oracle():
    return np.load(ORACLE)["img"].astype(np.float32)


def timed(fn, *args, reps=3):
    """(result, best warm seconds); the first call compiles."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


def compare_hits(name, hk, hw, live):
    hk = {k: np.asarray(v) for k, v in hk._asdict().items()}
    hw = {k: np.asarray(v) for k, v in hw._asdict().items()}
    live = np.asarray(live)
    agree = (hk["valid"] == hw["valid"])[live].mean()
    both = hk["valid"] & hw["valid"]
    t_ok = (np.abs(hk["t"] - hw["t"])
            <= T_RTOL * np.maximum(np.abs(hw["t"]), 1e-6))[both].mean()
    prim = (hk["prim"] == hw["prim"])[both].mean()
    print(f"  {name}: {live.sum()} live rays, hit share "
          f"{hw['valid'][live].mean():.4f}, hit/miss agreement {agree:.6f}, "
          f"t within {T_RTOL:g} rel {t_ok:.6f}, exact prim {prim:.6f}")
    check(agree >= HIT_AGREE_MIN, f"{name} hit/miss agreement >= "
          f"{HIT_AGREE_MIN}")
    check(t_ok >= T_AGREE_MIN, f"{name} t agreement >= {T_AGREE_MIN}")
    check(prim >= PRIM_EXACT_MIN, f"{name} exact prim >= {PRIM_EXACT_MIN}")


def phase_traversal(sd):
    import jax
    import jax.numpy as jnp

    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.ops import bvh as bvhlib
    from pbrt_v3_iile_tpu.ops import clusters as cllib
    from pbrt_v3_iile_tpu.ops import intersect as isect
    from pbrt_v3_iile_tpu.ops import sampling as smp
    from pbrt_v3_iile_tpu.utils import vecmath as vm

    print("(b) traversal: cluster kernel vs XLA walker", flush=True)
    t0 = time.perf_counter()
    scene, cam = renderlib.build(sd, accel="clusters")
    K = scene.clusters.aabb_min.shape[0]
    print(f"  scene build {time.perf_counter() - t0:.2f} s: "
          f"{scene.tri_p0.shape[0]} triangles, {K} clusters")
    prep, _ = renderlib.make_wave_prep(sd)
    o, d, *_ = jax.jit(prep)(cam, jax.random.PRNGKey(0), jnp.int32(0),
                             jnp.int32(0))
    N = o.shape[0]
    tmax = jnp.full((N,), 1e30, jnp.float32)

    kern = jax.jit(lambda s, o, d, t: isect.intersect(
        s, o, d, t, accel="clusters", spheres=False))
    walk = jax.jit(lambda s, o, d, t: isect.intersect(
        s, o, d, t, accel="bvh", spheres=False))
    mem = kern.lower(scene, o, d, tmax).compile().memory_analysis()
    print(f"  cluster traversal memory_analysis: {mem}")

    hk, tk = timed(kern, scene, o, d, tmax)
    hw, tw = timed(walk, scene, o, d, tmax)
    print(f"  primary wave ({N} rays): kernel {tk * 1e3:.3f} ms, "
          f"walker {tw * 1e3:.3f} ms")
    compare_hits("primary", hk, hw, tmax > 0)

    # first diffuse bounce from the walker's primary hits
    it = isect.make_interaction(scene, o, d, hw)
    n = vm.face_forward(it.ns, -d)
    tb, bb = vm.coordinate_system(n)
    u = jax.random.uniform(jax.random.PRNGKey(1), (N, 2))
    d2 = vm.to_world(smp.cosine_sample_hemisphere(u), tb, bb, n)
    o2 = vm.offset_ray_origin(it.p, vm.face_forward(it.ng, d2), d2)
    t2 = jnp.where(hw.valid, 1e30, -1.0)
    hk2, tk2 = timed(kern, scene, o2, d2, t2)
    hw2, tw2 = timed(walk, scene, o2, d2, t2)
    print(f"  bounce wave ({int(hw.valid.sum())} live rays): kernel "
          f"{tk2 * 1e3:.3f} ms, walker {tw2 * 1e3:.3f} ms")
    compare_hits("bounce", hk2, hw2, t2 > 0)

    # the dense plain-XLA evaluator at both matmul precisions (256 rays
    # against every cluster): TF32 side tests misclassify edge rays
    p0, e1, e2 = (np.asarray(a) for a in (scene.tri_p0, scene.tri_e1,
                                          scene.tri_e2))
    flat = bvhlib.build_bvh(np.stack([p0, p0 + e1, p0 + e2], 1))
    op = flat.prim_order
    cs = cllib.build_clusters(flat, p0[op], e1[op], e2[op])
    sel = jnp.arange(0, N, N // 256)[:256]
    ids = jnp.arange(cs.aabb_min.shape[0])
    for prec in ("default", "highest"):
        dense = jax.jit(lambda o_, d_, t_, p=prec:
                        cllib.intersect_clusters_dense(
                            cs, ids, o_, d_, t_, precision=p))
        td, _, _, _, vd = dense(o[sel], d[sel], tmax[sel])
        vd, vw = np.asarray(vd), np.asarray(hw.valid[sel])
        both = vd & vw
        err = np.abs(np.asarray(td) - np.asarray(hw.t[sel]))[both]
        rel = err / np.maximum(np.asarray(hw.t[sel])[both], 1e-6)
        print(f"  dense evaluator precision={prec}: hit/miss agreement "
              f"{(vd == vw).mean():.4f}, max rel t error "
              f"{rel.max() if rel.size else 0.0:.3e}")
        if prec == "highest":
            check((vd == vw).mean() >= 0.99,
                  "dense evaluator at HIGHEST agrees with the walker")
    return dict(primary_ms=(tk * 1e3, tw * 1e3),
                bounce_ms=(tk2 * 1e3, tw2 * 1e3))


def phase_path(sd, card):
    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.utils import metrics

    print("(c) path render: render.render, atrium 512^2, depth 6, 4 spp",
          flush=True)
    img, st = renderlib.render(sd, spp=4, seed=0)
    ref = oracle()
    H, W = sd.film.y_resolution, sd.film.x_resolution
    check(img.shape == (H, W, 3), f"image is {H}x{W}x3")
    check(bool(np.isfinite(img).all()), "image is finite")
    rel = abs(float(img.mean()) - float(ref.mean())) / float(ref.mean())
    p = metrics.psnr(img, ref)
    print(f"  mean {img.mean():.5f} vs oracle {ref.mean():.5f} "
          f"(rel {rel:.4f}); PSNR {p:.2f} dB; {st['seconds']:.2f} s "
          f"total; warm {st['mrays_per_s']:.3f} Mrays/s [{card}]")
    check(rel <= PATH_MEAN_RTOL, f"global mean within {PATH_MEAN_RTOL}")
    check(p >= PATH_PSNR_MIN, f"PSNR >= {PATH_PSNR_MIN} dB")
    return st


def phase_iile(sd):
    import jax
    import jax.numpy as jnp

    from pbrt_v3_iile_tpu.integrators import iispt as iisptlib
    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.integrators import schedule as schedlib
    from pbrt_v3_iile_tpu.ml import train as trainlib
    from pbrt_v3_iile_tpu.models import iisptnet
    from pbrt_v3_iile_tpu.models import transforms as nnx
    from pbrt_v3_iile_tpu.utils import metrics

    print("(d) IILE: render_iile, pretrained K=64, hemi 32, 4 tasks, "
          "4 direct passes", flush=True)
    sd.integrator.kind = "iispt"
    t0 = time.perf_counter()
    comb, direct, ind, st = iisptlib.render_iile(
        sd, indirect_tasks=4, direct_samples=4, hemi_size=32)
    dt = time.perf_counter() - t0
    ref = oracle()
    for name, im in (("combined", comb), ("direct", direct),
                     ("indirect", ind)):
        check(bool(np.isfinite(im).all()), f"{name} image is finite")
    p = metrics.psnr(comb, ref)
    print(f"  {dt:.2f} s (compile included); PSNR vs oracle {p:.2f} dB; "
          f"mean {comb.mean():.5f} vs {ref.mean():.5f}")
    check(p >= IILE_PSNR_MIN, f"IILE PSNR >= {IILE_PSNR_MIN} dB")

    # one real probe batch through the U-Net on the GPU and the CPU
    net = iisptnet.IISPTNet()
    nv = trainlib.load_pretrained(trainlib.default_pretrained_path())
    accel = renderlib.resolve_accel(sd)
    scene, cam = renderlib.build(sd, accel=accel)
    W, H = sd.film.x_resolution, sd.film.y_resolution
    task = schedlib.compute_schedule(W, H, 4)[0]
    key = jax.random.PRNGKey(3)
    fns = iisptlib._anchor_fns(sd, 32, net)
    coords = iisptlib.task_probe_coords(jnp.int32(task.x0),
                                        jnp.int32(task.y0), task.tilesize,
                                        W, H)
    po, pd = fns["probe_rays"](cam, key, coords)
    fi = iisptlib._ff_fn(accel)(scene, po, pd, key)
    gb = iisptlib._probes_fn(32, accel)(scene, fi["p"], fi["n"], key)
    x, _ = nnx.probe_to_network_input(gb.intensity, gb.normals,
                                      gb.distance)
    apply = jax.jit(lambda v, x_: net.apply(v, x_))
    cpu = jax.devices("cpu")[0]
    y_cpu = np.asarray(apply(jax.device_put(nv, cpu),
                             jax.device_put(x, cpu)))
    y_def = np.asarray(apply(nv, x))
    with jax.default_matmul_precision("highest"):
        y_hi = np.asarray(jax.jit(lambda v, x_: net.apply(v, x_))(nv, x))
    scale = max(float(np.abs(y_cpu).max()), 1e-6)
    e_def = float(np.abs(y_def - y_cpu).max()) / scale
    e_hi = float(np.abs(y_hi - y_cpu).max()) / scale
    print(f"  U-Net on {x.shape[0]} probes {tuple(x.shape[1:])}: max |GPU - "
          f"CPU| / max|CPU| = {e_def:.3e} at default precision, "
          f"{e_hi:.3e} at HIGHEST")
    check(bool(np.isfinite(y_def).all()), "U-Net output is finite")
    check(e_hi <= NET_HIGHEST_RTOL, f"HIGHEST error <= {NET_HIGHEST_RTOL}")
    check(e_def <= NET_DEFAULT_RTOL, f"default error <= {NET_DEFAULT_RTOL}")


def phase_four(sd):
    import jax
    import jax.numpy as jnp

    from pbrt_v3_iile_tpu.integrators import iispt as iisptlib
    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.parallel import mesh as meshlib
    from pbrt_v3_iile_tpu.parallel import sharded, sharded_iile
    from pbrt_v3_iile_tpu.utils import metrics

    print("(e) four GPUs: sharded path pass and IILE vs one device",
          flush=True)
    check(len(jax.devices()) >= 4, "four devices")
    mesh = meshlib.make_mesh(4)
    print(f"  mesh {dict(mesh.shape)}")
    H = sd.film.y_resolution
    scene, cam = renderlib.build(sd)
    key = jax.random.PRNGKey(3)
    run = sharded.sharded_render_pass(sd, mesh)
    (L, J), t4 = timed(run, scene, cam, key, 0, reps=2)
    run1 = jax.jit(renderlib.render_pass_fn(sd, chunk_rows=H // 4))
    parts = [run1(scene, cam, key, 0, r0) for r0 in range(0, H, H // 4)]
    L1 = np.concatenate([np.asarray(p[0]) for p in parts])
    J1 = np.concatenate([np.asarray(p[1]) for p in parts])
    L = np.asarray(L)
    check(np.array_equal(np.asarray(J), J1), "pixel jitter identical")
    check(bool(np.isfinite(L).all()), "sharded pass is finite")
    agree = (np.abs(L - L1) <= 1e-3 * (1.0 + np.abs(L1))).all(-1).mean()
    rel = abs(L.mean() - L1.mean()) / max(L1.mean(), 1e-9)
    print(f"  path pass: {t4 * 1e3:.2f} ms on 4 GPUs; pixel agreement "
          f"{agree:.5f}; mean {L.mean():.5f} vs {L1.mean():.5f}")
    check(agree >= SHARD_PIX_AGREE_MIN,
          f"pixel agreement >= {SHARD_PIX_AGREE_MIN}")
    check(rel <= SHARD_MEAN_RTOL, f"mean within {SHARD_MEAN_RTOL}")

    sd.integrator.kind = "iispt"
    kw = dict(indirect_tasks=2, direct_samples=2, hemi_size=32, seed=0)
    comb, direct, ind, st = sharded_iile.render_iile_sharded(sd, mesh, **kw)
    comb1, dir1, ind1, _ = iisptlib.render_iile(sd, **kw)
    ref = oracle()
    check(bool(np.isfinite(comb).all()), "sharded IILE is finite")
    rel = abs(comb.mean() - comb1.mean()) / max(comb1.mean(), 1e-9)
    print(f"  IILE: sharded {st['seconds']:.2f} s; mean {comb.mean():.5f} "
          f"vs single-device {comb1.mean():.5f}; PSNR vs oracle "
          f"{metrics.psnr(comb, ref):.2f} / {metrics.psnr(comb1, ref):.2f}"
          f" dB")
    check(rel <= SHARD_IILE_MEAN_RTOL,
          f"IILE mean within {SHARD_IILE_MEAN_RTOL}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-GPU sharded phase only")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    platform, kind = devs[0].platform, devs[0].device_kind
    print(f"(a) devices: {devs}", flush=True)
    print(f"  platform {platform}, device_kind {kind!r}, count {len(devs)}")
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {platform!r}",
              file=sys.stderr)
        return 2

    from pbrt_v3_iile_tpu.utils import compile_cache

    try:
        card = card_line()
        print(f"  card: {card}")
        print(f"  compile cache: {compile_cache.enable()}")
        sd = load_atrium()
        if args.four:
            phase_four(sd)
        else:
            phase_traversal(load_atrium())
            phase_path(load_atrium(), card)
            phase_iile(sd)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
