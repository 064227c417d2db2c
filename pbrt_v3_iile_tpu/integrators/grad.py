"""Differentiable rendering: pixel gradients w.r.t. scene parameters.

The reference renderer is not differentiable at all; this is an
extension (BASELINE.json config 3: gradients w.r.t. BSDF
albedo / light intensity).  The estimator is *detached sampling* (path
replay with frozen decisions): sampled directions, pdfs, lobe choices,
Russian-roulette and all intersection outputs are stop_gradient'ed, so
reverse-mode AD differentiates only the smooth shading terms
(f, Le, Li, cos) along the sampled paths — an unbiased gradient of the
pixel value w.r.t. material/light parameters for fixed path geometry.

Differentiable parameters (leaves of DeviceScene):
  mat_kd, mat_ks, mat_kr, mat_kt, mat_rough, mat_sigma, light_L.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import camera as camlib
from ..ops import samplers as smplr
from . import path as pathlib_

DIFF_FIELDS = ("mat_kd", "mat_ks", "mat_kr", "mat_kt", "mat_rough",
               "mat_sigma", "light_L")


def _merge(scene, diff_params):
    return scene._replace(**diff_params)


def split_scene(scene):
    """Returns (diff_params dict, frozen scene with those fields zeroed
    out of the grad path)."""
    diff = {f: getattr(scene, f) for f in DIFF_FIELDS}
    return diff, scene


def make_image_and_grad_fn(sd, cfg: pathlib_.PathConfig = None, spp: int = 4,
                           loss_fn=None):
    """Returns jitted f(scene, cam, key) -> (image (H,W,3), grads dict).

    loss_fn: (image) -> scalar; default mean luminance (for testing).
    For image-target optimization pass e.g.
    lambda img: jnp.mean(jnp.abs(img - target)).
    """
    H, W = sd.film.y_resolution, sd.film.x_resolution
    if cfg is None:
        from . import render as renderlib
        cfg = renderlib.make_integrator_config(sd)
    cfg = cfg._replace(differentiable=True)
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    if loss_fn is None:
        loss_fn = lambda img: jnp.mean(img)

    def render_image(diff_params, scene, cam, key):
        scene = _merge(scene, diff_params)
        px = jnp.arange(W, dtype=jnp.float32)
        py = jnp.arange(H, dtype=jnp.float32)
        gx, gy = jnp.meshgrid(px, py)
        pix = jnp.stack([gx, gy], axis=-1).reshape(-1, 2)
        img = jnp.zeros((H, W, 3))
        for p in range(spp):
            k = jax.random.fold_in(key, p)
            kj = smplr.wave_key(k, 0, 0, smplr.DIM_PIXEL_JITTER)
            jitter = smplr.uniform(kj, (H * W, 2))
            o, d = camlib.generate_rays(cam, pix + jitter, kind=cam_kind)
            L, _ = pathlib_.trace_paths(scene, o, d, k, cfg)
            img = img + L.reshape(H, W, 3)
        return img / spp

    def fwd(diff_params, scene, cam, key):
        img = render_image(diff_params, scene, cam, key)
        return loss_fn(img), img

    grad_fn = jax.grad(fwd, argnums=0, has_aux=True)

    @jax.jit
    def run(scene, cam, key):
        diff_params, _ = split_scene(scene)
        grads, img = grad_fn(diff_params, scene, cam, key)
        return img, grads

    return run
