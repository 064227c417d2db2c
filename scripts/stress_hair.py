"""Hair-at-scale stress test (VERDICT r3 missing #3): generate a 10k-
strand cyhair groom, convert with cli/cyhair2pbrt, build, and report
geometry amplification + a small render timing.

Run on CPU (JAX_PLATFORMS=cpu) for the build numbers; pass --render to
also trace one 256^2 pass."""
import os
import struct
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def write_cyhair(path, n_strands=10000, segs=4, seed=0):
    rng = np.random.default_rng(seed)
    roots = rng.uniform(-1, 1, (n_strands, 3)).astype(np.float32)
    roots[:, 1] = 0.0
    pts = []
    for s in range(n_strands):
        p = roots[s]
        strand = [p]
        d = np.float32([0, 1, 0]) + 0.2 * rng.standard_normal(3)
        for k in range(segs):
            d = d + 0.3 * rng.standard_normal(3).astype(np.float32)
            d = d / np.linalg.norm(d)
            p = p + 0.08 * d
            strand.append(p.astype(np.float32))
        pts.append(np.stack(strand))
    pts = np.concatenate(pts)
    with open(path, "wb") as f:
        f.write(b"HAIR")
        # num_strands, total_points, flags (bit1 points), default segs,
        # default thickness, default transparency, default color, info
        f.write(struct.pack("<IIII", n_strands, pts.shape[0], 0b10, segs))
        f.write(struct.pack("<fff", 0.002, 0.0, 0.3))
        f.write(struct.pack("<f", 0.2) + struct.pack("<f", 0.1))
        f.write(b"\x00" * 88)
        f.write(pts.astype("<f4").tobytes())
    return pts.shape[0]


def main():
    from pbrt_v3_iile_tpu.cli import cyhair2pbrt
    from pbrt_v3_iile_tpu.scene import api as apilib
    from pbrt_v3_iile_tpu.integrators import render as renderlib

    n_strands = int(os.environ.get("HAIR_STRANDS", "10000"))
    hair = "/tmp/stress.hair"
    out = "/tmp/stress_hair_curves.pbrt"
    npts = write_cyhair(hair, n_strands)
    print(f"cyhair: {n_strands} strands, {npts} points", flush=True)
    t0 = time.time()
    cyhair2pbrt.main([hair, out])
    print(f"convert: {time.time()-t0:.1f}s", flush=True)

    scene_text = f"""
LookAt 0 1.2 -4  0 0.35 0  0 1 0
Camera "perspective" "float fov" [35]
Film "image" "integer xresolution" [256] "integer yresolution" [256]
Sampler "random" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [4]
WorldBegin
LightSource "distant" "point from" [2 5 -4] "rgb L" [3 3 3]
Material "matte" "rgb Kd" [0.4 0.4 0.45]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
Include "{out}"
WorldEnd
"""
    sp = "/tmp/stress_hair.pbrt"
    with open(sp, "w") as f:
        f.write(scene_text)
    t0 = time.time()
    sd = apilib.load_scene(sp)
    t_parse = time.time() - t0
    t0 = time.time()
    scene, cam = renderlib.build(sd, with_clusters=True)
    t_build = time.time() - t0
    T = int(scene.tri_p0.shape[0])
    K = int(scene.clusters.aabb_min.shape[0]) if scene.clusters else 0
    n_seg = sum(1 for s in sd.shapes if s.get("kind") == "curve") \
        if hasattr(sd, "shapes") else -1
    print(f"parse {t_parse:.1f}s build {t_build:.1f}s; triangles={T} "
          f"clusters={K} "
          f"(amplification ~{T / max(n_strands * 4, 1):.1f} tri/seg)",
          flush=True)
    if "--render" in sys.argv:
        cfg = renderlib.make_integrator_config(sd)
        import jax, jax.numpy as jnp
        run = jax.jit(renderlib.render_pass_fn(sd, cfg))
        key = jax.random.PRNGKey(0)
        L, _, aux = run(scene, cam, key, 0)
        float(jnp.sum(L))
        t0 = time.time()
        L, _, aux = run(scene, cam, key, 1)
        float(jnp.sum(L))
        dt = time.time() - t0
        print(f"pass: {dt:.2f}s rays={int(aux['rays'])} "
              f"-> {int(aux['rays'])/dt/1e6:.2f} Mrays/s", flush=True)


if __name__ == "__main__":
    main()
