"""pbrt-compatible command line renderer.

Mirrors the reference launcher's flag surface (ref: bin/pbrt:1-273 and
main/pbrt.cpp:106-186): scene file + IILE knobs --iileIndirect /
--iileDirect / --iispt_hemi_size, plus --outfile, --quick, --seed.
Progressive previews (--iileControl <dir>) write out_direct /
out_indirect / out_combined images the way directoryControlThread does
(ref: iispt.cpp:749-787).

Usage:
  python -m pbrt_v3_iile_tpu.cli.main scene.pbrt [out.exr] [flags]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def write_output(path: str, img: np.ndarray):
    from ..utils import image as imglib

    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        imglib.write_pfm(path, img)
    elif ext == ".png":
        imglib.write_png_tonemapped(path, img)
    elif ext == ".exr":
        imglib.write_exr(path, img)
    else:
        imglib.write_exr(path + ".exr", img)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pbrt-iile",
        description="Differentiable wavefront path tracer with neural "
                    "indirect lighting (capabilities of pbrt-v3-IILE)")
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("outfile", nargs="?", default=None)
    ap.add_argument("--spp", type=int, default=None,
                    help="override sampler pixelsamples")
    ap.add_argument("--integrator", default=None,
                    help="override integrator (path|directlighting|iispt)")
    ap.add_argument("--iileIndirect", "--iileIndirectTasks", type=int,
                    default=16, dest="iile_indirect",
                    help="IILE indirect tasks (ref --iileIndirect)")
    ap.add_argument("--iileDirect", "--iileDirectSamples", type=int,
                    default=16, dest="iile_direct",
                    help="IILE progressive direct passes")
    ap.add_argument("--iispt_hemi_size", type=int, default=32)
    ap.add_argument("--iileControl", default=None,
                    help="control directory for progressive previews")
    ap.add_argument("--checkpoint", default=None,
                    help="IISPTNet checkpoint (for iispt integrator)")
    ap.add_argument("--quick", action="store_true",
                    help="quarter resolution, 1/4 samples")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--verbose", action="store_true",
                    help="verbose logging (glog FLAGS_v role)")
    ap.add_argument("--quiet", action="store_true",
                    help="errors only (ref --quiet)")
    ap.add_argument("--filmCheckpoint", default=None,
                    help="film checkpoint file for resumable renders")
    ap.add_argument("--checkpointEvery", type=int, default=16)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--accel", default=None,
                    choices=["bvh", "kdtree", "clusters"],
                    help="aggregate override (default: scene file / auto —"
                    " the cluster kernel on a GPU, the BVH walker on CPU)")
    ap.add_argument("--compact", action="store_true",
                    help="compacted-wavefront path loop (budget RR + "
                         "per-bounce coherence sort; cluster accel only)")
    ap.add_argument("--multihost", action="store_true",
                    help="initialize the cross-host process group "
                    "(PBRT_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID)")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from ..utils import compile_cache
    compile_cache.enable()

    from ..scene import api as apilib
    from ..integrators import render as renderlib
    from ..utils import image as imglib

    if args.multihost:
        from ..parallel import distributed
        multi = distributed.maybe_initialize()
        print(f"multihost: {distributed.process_info()}"
              if multi else "multihost: single process", flush=True)
    from ..utils import log as loglib
    if args.verbose:
        loglib.set_verbosity(loglib.VERBOSE)
    elif args.quiet:
        loglib.set_verbosity(loglib.ERROR)
    if args.stats:
        # per-stage wall-time + counter collection (the stats.h role;
        # forces device sync per stage, so off by default)
        from ..utils import stats as statslib
        statslib.enable(True)
    sd = apilib.load_scene(args.scene)
    if args.integrator:
        sd.integrator.kind = args.integrator
    if args.quick:
        sd.film.x_resolution = max(64, sd.film.x_resolution // 4)
        sd.film.y_resolution = max(64, sd.film.y_resolution // 4)
        sd.sampler.pixel_samples = max(1, sd.sampler.pixel_samples // 4)

    out = args.outfile or sd.film.filename

    control = args.iileControl
    if control:
        os.makedirs(control, exist_ok=True)

    if sd.integrator.kind == "iispt":
        from ..integrators import iispt as iisptlib
        from ..ml import train as trainlib

        net_vars = None
        if args.checkpoint:
            net_vars = trainlib.inference_variables(
                trainlib.load_checkpoint(args.checkpoint))

        def report(phase, done, total):
            token = ("#INDPROGRESS!" if phase == "indirect"
                     else "#DIRECTPROGRESS!")
            print(f"{token}{done / total}", flush=True)

        combined, direct, indirect, stats = iisptlib.render_iile(
            sd, net_vars=net_vars, seed=args.seed,
            indirect_tasks=args.iile_indirect,
            direct_samples=args.iile_direct,
            hemi_size=args.iispt_hemi_size,
            report=report)
        # side outputs as the reference writes them (iispt.cpp:431-446)
        base = os.path.dirname(os.path.abspath(out)) or "."
        imglib.write_exr(os.path.join(base, "iispt_direct.exr"), direct)
        imglib.write_exr(os.path.join(base, "iispt_indirect.exr"), indirect)
        if control:
            imglib.write_pfm(os.path.join(control, "out_direct.pfm"), direct)
            imglib.write_pfm(os.path.join(control, "out_indirect.pfm"),
                             indirect)
            imglib.write_pfm(os.path.join(control, "out_combined.pfm"),
                             combined)
            print("#REFRESH!", flush=True)
        write_output(out, combined)
        print("#FINISH!", flush=True)
        if args.stats:
            print(json.dumps(stats), file=sys.stderr)
    else:
        img, stats = renderlib.render(
            sd, spp=args.spp, seed=args.seed,
            checkpoint=args.filmCheckpoint,
            checkpoint_every=args.checkpointEvery,
            accel=args.accel, compact=args.compact)
        write_output(out, img)
        if args.stats:
            print(json.dumps(stats), file=sys.stderr)
    if args.stats:
        from ..utils import stats as statslib
        print(statslib.report(), file=sys.stderr)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
