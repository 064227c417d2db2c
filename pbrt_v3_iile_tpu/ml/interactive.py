"""Interactive training-view backend.

Parity target: ml/main_interactive_view.py in the reference — a
stdin-driven per-example predictor behind the Express/WebSocket training
viewer (tools/interactive_training_view).  Protocol (tokens on stdout):

  startup  -> "#LOADCOMPLETE <n_examples>"
  stdin    <- one example index per line
  per index: writes interactive{Expected,Result,Normals,Distance,Low,
             Blurred}.png into --outdir, then emits
             "#LOWL1 v" "#LOWSS v" "#GAUSSL1 v" "#GAUSSSS v"
             "#RESL1 v" "#RESSS v" "#NAME p" "#EVALUATECOMPLETE"

The CNN runs in-graph (jitted apply) instead of torch; images are
loaded with the reference PFM directory layout ({p,d,n,z}_x_y.pfm,
ml/iispt_dataset.py semantics) via ml/dataset.load_pfm_dataset.

Usage:
  python -m pbrt_v3_iile_tpu.ml.interactive --dataset DIR [DIR...]
         [--checkpoint ckpt.npz] [--outdir .]
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

GAMMA = 1.8


def _say(s):
    print(s, flush=True)


def _autoexposure(img):
    """Reference pfm.py computeAutoexposure: exposure stops such that the
    high percentile maps near white."""
    p = float(np.percentile(img, 98))
    return float(-np.log2(max(p, 1e-6)))


def _save_png(path, img, exposure):
    from ..utils import image as imglib

    ldr = np.clip(np.asarray(img) * (2.0 ** exposure), 0.0, 1.0)
    ldr = ldr ** (1.0 / GAMMA)
    if ldr.ndim == 2:
        ldr = np.stack([ldr] * 3, axis=-1)
    if ldr.shape[-1] == 1:
        ldr = np.repeat(ldr, 3, axis=-1)
    imglib.write_png(path, ldr)


def _gauss_blur(img, sigma=1.0):
    r = max(1, int(3 * sigma))
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    out = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 0, img)
    return np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1, out)


def main(argv=None):
    from . import dataset as dslib
    from . import train as trainlib
    from ..models import iisptnet, transforms as nnx
    from ..utils import metrics as m

    ap = argparse.ArgumentParser(prog="interactive")
    ap.add_argument("--dataset", nargs="+", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--outdir", default=".")
    args = ap.parse_args(argv)

    examples = dslib.load_pfm_dataset(args.dataset)
    if not examples:
        _say("#LOADCOMPLETE 0")
        print("no examples found", file=sys.stderr)
        return 1
    hemi = examples[0]["d"].shape[0]
    net, net_vars = iisptnet.init_params(jax.random.PRNGKey(0), hemi)
    if args.checkpoint:
        net_vars = trainlib.inference_variables(
            trainlib.load_checkpoint(args.checkpoint))

    @jax.jit
    def predict(d, n, z):
        x, aux = nnx.probe_to_network_input(d, n, z)
        y = net.apply(net_vars, x[None], train=False)[0]
        return nnx.network_output_to_radiance(y, aux)

    _say(f"#LOADCOMPLETE {len(examples)}")

    out = lambda name: os.path.join(args.outdir, name)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            idx = int(line)
        except ValueError:
            _say("Out of range!")
            continue
        if not (0 <= idx < len(examples)):
            _say("Out of range!")
            continue
        _say(f"Requesting index {idx}")
        ex = examples[idx]
        d = jnp.asarray(ex["d"], jnp.float32)
        n = jnp.asarray(ex["n"], jnp.float32)
        z = jnp.asarray(ex["z"], jnp.float32)
        result = np.asarray(predict(d, n, z))

        expected = ex["p"].astype(np.float32)
        expo = _autoexposure(expected)
        _save_png(out("interactiveExpected.png"), expected, expo)
        _save_png(out("interactiveResult.png"), result, expo)
        _save_png(out("interactiveNormals.png"), 0.5 * (ex["n"] + 1.0), 0.0)
        _save_png(out("interactiveDistance.png"), ex["z"],
                  _autoexposure(ex["z"]))
        low = ex["d"].astype(np.float32)
        _save_png(out("interactiveLow.png"), low, expo)
        blurred = _gauss_blur(low, 1.0)
        _save_png(out("interactiveBlurred.png"), blurred, expo)

        _say(f"#LOWL1 {m.l1(low, expected)}")
        _say(f"#LOWSS {m.ssim(low, expected)}")
        _say(f"#GAUSSL1 {m.l1(blurred, expected)}")
        _say(f"#GAUSSSS {m.ssim(blurred, expected)}")
        _say(f"#RESL1 {m.l1(result, expected)}")
        _say(f"#RESSS {m.ssim(result, expected)}")
        _say(f"#NAME example_{idx}")
        _say("#EVALUATECOMPLETE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
