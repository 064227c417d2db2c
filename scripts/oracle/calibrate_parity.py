"""Render our side of each oracle parity fixture and print the
global / regional / blurred-structural deltas, to set the
tests/test_oracle_parity.py tolerance matrix from data.

Run on the chip: python scripts/oracle/calibrate_parity.py
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np

GOLDEN = os.path.join(ROOT, "tests", "golden")
KILLEROO = "/root/reference/scenes/killeroo-simple.pbrt"

CASES = [
    ("killeroo_ref_path128_175.npy", KILLEROO, "path", 175, 32),
    ("killeroo_ref_direct64_175.npy", KILLEROO, "directlighting", 175, 32),
    ("killeroo_ref_bdpt32_175.npy", KILLEROO, "bdpt", 175, 16),
    ("atrium_ref_path96_128.npy",
     os.path.join(ROOT, "scenes", "atrium.pbrt"), "path", 128, 64),
    ("atrium_ref_direct96_128.npy",
     os.path.join(ROOT, "scenes", "atrium.pbrt"), "directlighting",
     128, 64),
    ("interior1_ref_path96_128.npy",
     os.path.join(ROOT, "scenes", "interior_v1.pbrt"), "path", 128, 64),
]


def blur4(x):
    n = x.shape[0] // 4 * 4
    return x[:n, :n].reshape(n // 4, 4, n // 4, 4, 3).mean((1, 3))


def main():
    from pbrt_v3_iile_tpu.scene import api as apilib
    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.utils import compile_cache

    compile_cache.enable()

    for fx, scene, integ, res, spp in CASES:
        path = os.path.join(GOLDEN, fx)
        if not os.path.exists(path):
            print(f"{fx}: MISSING fixture")
            continue
        ref = np.load(path)
        sd = apilib.load_scene(scene)
        sd.integrator.kind = integ
        sd.film.x_resolution = sd.film.y_resolution = res
        t0 = time.time()
        img, _ = renderlib.render(sd, spp=spp, seed=3)
        img = np.asarray(img)
        dt = time.time() - t0
        g = (img.mean() - ref.mean()) / ref.mean()
        h = res // 3
        regs = []
        for lo, hi in ((0, h), (h, 2 * h), (2 * h, res)):
            m, r = img[lo:hi].mean(), ref[lo:hi].mean()
            regs.append((m - r) / max(r, 1e-3))
        bm, br = blur4(img), blur4(ref)
        rel = np.abs(bm - br).mean() / br.mean()
        print(f"{fx}: {integ}@{spp}spp {dt:.0f}s  global {g*100:+.2f}%  "
              f"regions [{', '.join(f'{x*100:+.2f}%' for x in regs)}]  "
              f"blur4relL1 {rel*100:.2f}%", flush=True)


if __name__ == "__main__":
    main()
