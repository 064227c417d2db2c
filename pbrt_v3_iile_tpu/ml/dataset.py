"""Training datasets for the IILE U-Net.

Two sources:
1. On-device generation (replaces the reference's render_reference PFM
   pipeline, ref: iispt.cpp:456-526 + Li_reference :650-744): probe
   G-buffers + high-spp hemispherical ground truth rendered as arrays —
   no {d,n,z,p}_x_y.pfm files, no resume-by-file.
2. A loader for reference-format PFM set directories (ref:
   ml/iispt_dataset.py generate_pfm_filenames) for interop.

Augmentation and normalization semantics match ml/iispt_dataset.py
__getitem__: 16x (4 rotations x 4 flips, iispt_transforms.py:36-73);
p -> downstream-half with p's own mean; d -> downstream-full with d's
mean; n -> [-1,1]; z -> distance-downstream with z's mean.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..models import transforms as nnx
from ..ops import samplers as smplr
from ..utils import image as imglib
from ..utils import vecmath as vm


# ---------------------------------------------------------------------------
# augmentation (jnp, batched) — (ref: iispt_transforms.augmentList)
# ---------------------------------------------------------------------------

def augment(maps: jnp.ndarray, aug: int) -> jnp.ndarray:
    """maps: (..., H, W, C); aug in [0, 16): flip index = aug//4
    (0 none, 1 vflip, 2 hflip, 3 both), rotation index = aug%4 (k*90)."""
    flip = aug // 4
    rot = aug % 4
    if flip == 1:
        maps = maps[..., ::-1, :, :]
    elif flip == 2:
        maps = maps[..., :, ::-1, :]
    elif flip == 3:
        maps = maps[..., ::-1, ::-1, :]
    if rot:
        maps = jnp.rot90(maps, k=rot, axes=(-3, -2))
    return maps


def example_from_maps(p, d, n, z, aug: int = 0):
    """Builds (x (H,W,7), y (H,W,3)) from raw maps, matching
    iispt_dataset.__getitem__ normalization."""
    p, d, n, z = (augment(m, aug) for m in (p, d, n, z))
    y = nnx.intensity_downstream_half(p, jnp.mean(p))
    xd = nnx.intensity_downstream_full(d, jnp.mean(d))
    xn = nnx.normals_downstream(n)
    xz = nnx.distance_downstream(z, jnp.mean(z))
    x = jnp.concatenate([xd, xn, xz], axis=-1)
    return x, y


# ---------------------------------------------------------------------------
# on-device dataset generation (replaces render_reference)
# ---------------------------------------------------------------------------

def generate_examples(scene, cam, cam_kind, key, pixel_coords,
                      hemi_size: int = 32, gt_spp: int = 16,
                      accel: str = "bvh"):
    """Render raw training maps at the given film pixels.

    pixel_coords: (P, 2) int film pixels (the reference_tiles grid,
    ref iispt.cpp:498-505).  gt_spp hemispherical ground-truth samples per
    probe (reference default 4096 — scale to budget).

    Returns dict of raw maps: p (P,Hs,Hs,3) ground truth, d (P,Hs,Hs,3)
    1spp intensity, n (P,Hs,Hs,3) camera-space normals, z (P,Hs,Hs,1),
    valid (P,).
    """
    from ..integrators import probes as probelib
    from ..ops import camera as camlib

    P = pixel_coords.shape[0]
    kj = smplr.wave_key(key, 9, 0, smplr.DIM_PIXEL_JITTER)
    jit_p = smplr.uniform(kj, (P, 2))
    p_film = pixel_coords.astype(jnp.float32) + jit_p
    o, d = camlib.generate_rays(cam, p_film, kind=cam_kind)
    fi = probelib.find_first_nonspecular(scene, o, d, key,
                                         accel=accel)
    valid = fi["found"]

    # 1spp probe G-buffer (the network input)
    gb = probelib.render_probes(scene, fi["p"], fi["n"],
                                jax.random.fold_in(key, 1), hemi_size,
                                accel=accel)

    # ground truth: average of gt_spp jittered probe renders
    def gt_body(carry, i):
        acc = carry
        g = probelib.render_probes(scene, fi["p"], fi["n"],
                                   jax.random.fold_in(key, 100 + i),
                                   hemi_size, accel=accel)
        return acc + g.intensity, None

    acc0 = jnp.zeros((P, hemi_size, hemi_size, 3), jnp.float32)
    acc, _ = jax.lax.scan(gt_body, acc0, jnp.arange(gt_spp))
    p_maps = acc / gt_spp

    return dict(p=p_maps, d=gb.intensity, n=gb.normals, z=gb.distance,
                valid=valid)


# ---------------------------------------------------------------------------
# reference-format PFM directory loader (ref: iispt_dataset.load_dataset)
# ---------------------------------------------------------------------------

def load_pfm_dataset(set_dirs):
    """Scans directories of {p,d,n,z}_x_y.pfm files; returns list of raw
    example dicts (numpy)."""
    examples = []
    for dirname in set_dirs:
        names = os.listdir(dirname)
        for f in names:
            if not (f.startswith("p_") and f.endswith(".pfm")):
                continue
            _, x, y = f[:-4].split("_")
            paths = {k: os.path.join(dirname, f"{k}_{x}_{y}.pfm")
                     for k in "pdnz"}
            if not all(os.path.exists(v) for v in paths.values()):
                continue
            ex = {k: imglib.read_pfm(v) for k, v in paths.items()}
            for k in "pdn":
                if ex[k].ndim == 2:
                    ex[k] = np.stack([ex[k]] * 3, axis=-1)
            if ex["z"].ndim == 2:
                ex["z"] = ex["z"][..., None]
            examples.append(ex)
    return examples


def batches_from_raw(raw_examples, batch_size: int, key, n_augment: int = 16):
    """Yields (x (B,H,W,7), y (B,H,W,3)) with random augmentation."""
    rng = np.random.default_rng(int(jax.random.randint(key, (), 0, 2**31 - 1)))
    idx = rng.permutation(len(raw_examples) * n_augment)
    for start in range(0, len(idx) - batch_size + 1, batch_size):
        xs, ys = [], []
        for j in idx[start:start + batch_size]:
            ex = raw_examples[j // n_augment]
            aug = int(j % n_augment)
            x, y = example_from_maps(
                jnp.asarray(ex["p"]), jnp.asarray(ex["d"]),
                jnp.asarray(ex["n"]), jnp.asarray(ex["z"]), aug)
            xs.append(x)
            ys.append(y)
        yield jnp.stack(xs), jnp.stack(ys)


def generate_examples_sharded(scene, cam, cam_kind, key, pixel_coords,
                              mesh=None, hemi_size: int = 32,
                              gt_spp: int = 16, accel: str = "bvh"):
    """Mesh-sharded reference-mode generation (SURVEY P4).

    Replaces the reference's MOD/MATCH multi-process pixel-grid sharding
    (ref: iispt.cpp:479-505, tools/multiprocess_reference.py:6-33): the
    probe batch is sharded over every mesh axis; each shard runs the
    plain on-device generator on its slice with a key folded by its
    shard index, so a single-device run that loops the shards serially
    (see tests/test_multichip.py) reproduces the sharded output
    bitwise — the same determinism contract as the row-chunked render
    pass (SURVEY P1/P6).

    pixel_coords count must divide evenly by the mesh size (pad with
    duplicate coords and drop them afterwards if needed).  Returns the
    same dict as generate_examples.
    """
    from ..parallel import mesh as meshlib
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    if mesh is None:
        mesh = meshlib.make_mesh()
    axes = (meshlib.AXIS_DP, meshlib.AXIS_TILE)
    n_dev = mesh.devices.size
    Pn = pixel_coords.shape[0]
    if Pn % n_dev:
        raise ValueError(f"probe count {Pn} must divide the mesh size "
                         f"{n_dev}")

    def shard_fn(coords_shard):
        sid = (jax.lax.axis_index(meshlib.AXIS_DP) * mesh.shape[
            meshlib.AXIS_TILE] + jax.lax.axis_index(meshlib.AXIS_TILE))
        k = jax.random.fold_in(key, sid)
        return generate_examples(scene, cam, cam_kind, k, coords_shard,
                                 hemi_size=hemi_size, gt_spp=gt_spp,
                                 accel=accel)

    fn = shard_map(shard_fn, mesh=mesh, in_specs=(P(axes),),
                   out_specs=P(axes), check_vma=False)
    return fn(pixel_coords)


def generate_examples_shard_serial(scene, cam, cam_kind, key, pixel_coords,
                                   n_shards: int, hemi_size: int = 32,
                                   gt_spp: int = 16,
                                   accel: str = "bvh"):
    """Single-device oracle for generate_examples_sharded: loops the
    shards serially with the identical per-shard key folding."""
    Pn = pixel_coords.shape[0]
    per = Pn // n_shards
    outs = []
    for s in range(n_shards):
        k = jax.random.fold_in(key, s)
        outs.append(generate_examples(
            scene, cam, cam_kind, k, pixel_coords[s * per:(s + 1) * per],
            hemi_size=hemi_size, gt_spp=gt_spp, accel=accel))
    return {k: jnp.concatenate([o[k] for o in outs]) for k in outs[0]}
