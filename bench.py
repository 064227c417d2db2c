"""Benchmark: warm path-tracing rate of one scene on one GPU.

    python bench.py [--scene scenes/atrium.pbrt] [--spp 9]
                    [--accel clusters bvh] [--rounds 2]

Each measurement is one `render.render` call (the CLI's own call) at the
scene file's resolution and depth.  Its first pass compiles and is
excluded; the remaining passes are timed on the host clock up to a
`block_until_ready` on the film.  Rays count path segments and shadow
rays.  With several --accel values the traversals run in turn in this
one process, in the order A B B A ... over the rounds, so that they
share the card's state.

Prints one JSON line per measurement, with the device as JAX reports
it and the card's name and power limit from nvidia-smi.  Needs a GPU:
on any other platform it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default=os.path.join(HERE, "scenes",
                                                    "atrium.pbrt"))
    ap.add_argument("--spp", type=int, default=9,
                    help="passes per render; the first one compiles")
    ap.add_argument("--accel", nargs="+", default=[None],
                    help="traversals to compare (default: the platform's)")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2

    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.scene import api as apilib
    from pbrt_v3_iile_tpu.utils import compile_cache

    compile_cache.enable()
    card = card_line()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    sd = apilib.load_scene(args.scene)
    sd.integrator.kind = "path"
    order = []
    for r in range(args.rounds):
        order += args.accel if r % 2 == 0 else args.accel[::-1]
    for accel in order:
        img, st = renderlib.render(sd, spp=args.spp, accel=accel)
        warm_passes = args.spp - 1
        print(json.dumps({
            "metric": "path_mrays_per_s",
            "value": st["mrays_per_s"],
            "unit": "Mrays/s",
            "accel": renderlib.resolve_accel(sd, accel),
            "scene": os.path.basename(args.scene),
            "resolution": [sd.film.x_resolution, sd.film.y_resolution],
            "max_depth": sd.integrator.max_depth,
            "warm_passes": warm_passes,
            "warm_pass_ms": 1e3 * st["warm_seconds"] / max(warm_passes, 1),
            "seconds_total": st["seconds"],
            "rays": st["rays"],
            "device": device,
            "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
