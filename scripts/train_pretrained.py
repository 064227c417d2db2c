"""Train the committed IISPTNet pretrained checkpoint at real scale.

The reference workflow (render_reference -> main_train.py ->
iispt_model.tch, ref: tools/training_batch_generate.py, ml/config.py:1)
run on-device: probe G-buffers + high-spp hemispherical ground truth
from 3 randomized interiors (scripts/make_interiors.py) + killeroo + a
cornell-style box, trained with the standard recipe (Adam 6e-5, L1,
batch 32).  The atrium interior is HELD OUT for quality evaluation.

Ground-truth accumulation loops on the host (one moderate device
program per 1spp probe render), which bounds each program's size.

Resumable: dataset shards and the model are checkpointed to --workdir.

Usage:
  python scripts/train_pretrained.py [--gt-spp 128] [--grid 14]
      [--steps 1500] [--out pbrt_v3_iile_tpu/ml/pretrained/iispt_pretrained.npz]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gen_scene_examples(tag, sd, grid, reps, gt_spp, hemi, workdir,
                       accel):
    """Generate raw probe examples for one scene, shard-resumable."""
    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.integrators import probes as probelib
    from pbrt_v3_iile_tpu.ops import camera as camlib
    from pbrt_v3_iile_tpu.ops import samplers as smplr

    shard_path = os.path.join(workdir, f"ds_{tag}.npz")
    if os.path.exists(shard_path):
        z = np.load(shard_path)
        n = int(z["n"])
        out = [{k: z[f"{k}{i}"] for k in "pdnz"} for i in range(n)]
        print(f"[{tag}] resumed {n} examples from {shard_path}",
              flush=True)
        return out

    scene, cam = renderlib.build(sd)
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    W, H = sd.film.x_resolution, sd.film.y_resolution

    gx = np.linspace(W * 0.05, W * 0.95, grid).astype(np.int32)
    gy = np.linspace(H * 0.05, H * 0.95, grid).astype(np.int32)
    mx, my = np.meshgrid(gx, gy)
    base_coords = np.stack([mx, my], -1).reshape(-1, 2)

    @jax.jit
    def probe_rays(cam, key, coords):
        kj = smplr.wave_key(key, 9, 0, smplr.DIM_PIXEL_JITTER)
        jit_p = smplr.uniform(kj, coords.shape)
        p_film = coords.astype(jnp.float32) + jit_p
        return camlib.generate_rays(cam, p_film, kind=cam_kind)

    out = []
    key = jax.random.PRNGKey(hash(tag) % (2 ** 31))
    t0 = time.time()
    for rep in range(reps):
        krep = jax.random.fold_in(key, rep)
        coords = jnp.asarray(base_coords + rep * 2)
        o, d = probe_rays(cam, krep, coords)
        fi = probelib.find_first_nonspecular(scene, o, d, krep,
                                             accel=accel)
        gb = probelib.render_probes(scene, fi["p"], fi["n"],
                                    jax.random.fold_in(krep, 1), hemi,
                                    accel=accel)
        acc = jnp.zeros_like(gb.intensity)
        for i in range(gt_spp):
            g = probelib.render_probes(scene, fi["p"], fi["n"],
                                       jax.random.fold_in(krep, 100 + i),
                                       hemi, accel=accel)
            acc = acc + g.intensity
        p_maps = np.asarray(acc / gt_spp)
        valid = np.asarray(fi["found"])
        d_in = np.asarray(gb.intensity)
        n_in = np.asarray(gb.normals)
        z_in = np.asarray(gb.distance)
        for i in range(coords.shape[0]):
            if valid[i] and np.isfinite(p_maps[i]).all():
                out.append(dict(p=p_maps[i], d=d_in[i], n=n_in[i],
                                z=z_in[i]))
        print(f"[{tag}] rep {rep + 1}/{reps}: {len(out)} examples "
              f"({time.time() - t0:.0f}s)", flush=True)

    blob = {"n": np.int32(len(out))}
    for i, ex in enumerate(out):
        for k in "pdnz":
            blob[f"{k}{i}"] = ex[k].astype(np.float16)
    np.savez_compressed(shard_path, **blob)
    print(f"[{tag}] saved {len(out)} examples -> {shard_path}", flush=True)
    return out


DEMO_BOX = None  # filled from train_demo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt-spp", type=int, default=128)
    ap.add_argument("--grid", type=int, default=14)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--hemi", type=int, default=32)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--workdir", default="/tmp/iispt_train")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "pbrt_v3_iile_tpu", "ml", "pretrained",
        "iispt_pretrained.npz"))
    ap.add_argument("--scenes",
                    default="interior_v1,interior_v2,interior_v3,"
                            "killeroo,box")
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)

    from pbrt_v3_iile_tpu.scene import api as apilib
    from pbrt_v3_iile_tpu.ml import train as trainlib
    import scripts.train_demo as demo

    from pbrt_v3_iile_tpu.ops import intersect as isect
    from pbrt_v3_iile_tpu.utils import compile_cache
    compile_cache.enable()
    accel = isect.default_accel()
    print("backend:", jax.default_backend(), "accel:", accel, flush=True)

    raws = []
    wanted = args.scenes.split(",")
    if "atrium" in wanted:
        sd = apilib.load_scene(os.path.join(ROOT, "scenes", "atrium.pbrt"))
        sd.film.x_resolution = sd.film.y_resolution = 384
        raws += gen_scene_examples("atrium", sd, args.grid, args.reps,
                                   args.gt_spp, args.hemi, args.workdir,
                                   accel)
    for name in wanted:
        # randomized interiors (scripts/make_interiors.py) — the
        # multi-scene corpus; atrium stays OUT as the held-out
        # quality-evaluation interior
        if not name.startswith("interior_"):
            continue
        path = os.path.join(ROOT, "scenes", f"{name}.pbrt")
        if not os.path.exists(path):
            import subprocess
            subprocess.run([sys.executable,
                            os.path.join(ROOT, "scripts",
                                         "make_interiors.py"), "3"],
                           check=True)
        sd = apilib.load_scene(path)
        raws += gen_scene_examples(name, sd, args.grid, args.reps,
                                   args.gt_spp, args.hemi, args.workdir,
                                   accel)
    if "killeroo" in wanted:
        sd = apilib.load_scene(
            "/root/reference/scenes/killeroo-simple.pbrt")
        raws += gen_scene_examples("killeroo", sd, args.grid, args.reps,
                                   args.gt_spp, args.hemi, args.workdir,
                                   accel)
    if "box" in wanted:
        sd = apilib.load_scene_string(demo.DEMO_SCENE)
        raws += gen_scene_examples("box", sd, args.grid, args.reps,
                                   args.gt_spp, args.hemi, args.workdir,
                                   accel)
    print(f"dataset: {len(raws)} examples total", flush=True)

    # ---- train ----
    key = jax.random.PRNGKey(11)
    state = trainlib.init_training(jax.random.PRNGKey(1),
                                   hemi_size=args.hemi)
    resume = os.path.join(args.workdir, "model_resume.ckpt")
    if os.path.exists(resume):
        blob = trainlib.load_checkpoint(resume)
        state = dict(state, params=blob["params"],
                     batch_stats=blob["batch_stats"])
        print("resumed model from", resume, flush=True)

    losses = []
    t0 = time.time()
    while len(losses) < args.steps:
        state, ls = trainlib.train(
            raws, state, jax.random.fold_in(key, len(losses)),
            max_epochs=1, time_budget_s=1e9, log_every=50)
        if not ls:
            break
        losses += ls
        trainlib.save_checkpoint(resume, state)
        print(f"steps {len(losses)}: loss {np.mean(ls[-20:]):.5f} "
              f"({time.time() - t0:.0f}s)", flush=True)
    print(f"loss first {np.mean(losses[:20]):.5f} -> "
          f"last {np.mean(losses[-20:]):.5f}", flush=True)

    trainlib.save_pretrained(args.out, state)
    print("saved pretrained ->", args.out, flush=True)


if __name__ == "__main__":
    main()
