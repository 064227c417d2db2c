"""Trilinear mip-mapped image textures (ref: src/core/mipmap.h MIPMap:
box-filtered pyramid, Lookup(st, width) level selection + level lerp) and
the ray-cone width plumbing that replaces the reference's per-ray
differentials (SurfaceInteraction::ComputeDifferentials)."""

import numpy as np
import jax.numpy as jnp

from pbrt_v3_iile_tpu.scene import textures as texlib


def _table_with_image(img):
    """Minimal one-entry imagemap table around a raw (R,R,3) image."""
    t = texlib.empty_table()
    pyr = texlib._mip_pyramid(img.astype(np.float32))
    return t._replace(
        kind=jnp.asarray([texlib.TEX_IMAGE], jnp.int32),
        img=jnp.asarray([0], jnp.int32),
        atlas=jnp.asarray(pyr, jnp.float32),
    )


def _rand_img(res=texlib.ATLAS_RES, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (res, res, 3)).astype(np.float32)


def test_zero_width_is_level0_bilinear():
    """width=None / width=0 must reproduce the original bilinear lookup."""
    img = _rand_img()
    tt = _table_with_image(img)
    rng = np.random.default_rng(1)
    uv = jnp.asarray(rng.uniform(0, 1, (64, 2)), jnp.float32)
    p = jnp.zeros((64, 3), jnp.float32)
    tid = jnp.zeros(64, jnp.int32)
    a = np.asarray(texlib.eval_texture(tt, tid, uv, p))
    b = np.asarray(texlib.eval_texture(tt, tid, uv, p,
                                       jnp.zeros(64, jnp.float32)))
    np.testing.assert_allclose(a, b, atol=1e-6)
    # cross-check one sample against manual bilinear (wrap)
    R = img.shape[0]
    u, v = float(uv[0, 0]), float(uv[0, 1])
    fx, fy = u * R - 0.5, v * R - 0.5
    x0, y0 = int(np.floor(fx)), int(np.floor(fy))
    ax, ay = fx - x0, fy - y0
    ref = ((1 - ax) * (1 - ay) * img[y0 % R, x0 % R]
           + ax * (1 - ay) * img[y0 % R, (x0 + 1) % R]
           + (1 - ax) * ay * img[(y0 + 1) % R, x0 % R]
           + ax * ay * img[(y0 + 1) % R, (x0 + 1) % R])
    np.testing.assert_allclose(a[0], ref, rtol=1e-5, atol=1e-5)


def test_integer_level_matches_coarse_bilinear():
    """The upsampled-storage trick must make a level-k lookup equal
    bilinear filtering of the k-times box-downsampled image (the exact
    MIPMap::triangle semantics at integer levels)."""
    img = _rand_img(seed=2)
    tt = _table_with_image(img)
    R = img.shape[0]
    k = 2
    coarse = img
    for _ in range(k):
        coarse = 0.25 * (coarse[0::2, 0::2] + coarse[1::2, 0::2]
                         + coarse[0::2, 1::2] + coarse[1::2, 1::2])
    r = coarse.shape[0]
    rng = np.random.default_rng(3)
    uvn = rng.uniform(0.1, 0.9, (128, 2)).astype(np.float32)
    width = np.full(128, 2.0 ** k / R, np.float32)  # exact level k
    got = np.asarray(texlib.eval_texture(
        tt, jnp.zeros(128, jnp.int32), jnp.asarray(uvn),
        jnp.zeros((128, 3), jnp.float32), jnp.asarray(width)))
    for i in range(128):
        u, v = uvn[i]
        fx, fy = u * r - 0.5, v * r - 0.5
        x0, y0 = int(np.floor(fx)), int(np.floor(fy))
        ax, ay = fx - x0, fy - y0
        ref = ((1 - ax) * (1 - ay) * coarse[y0 % r, x0 % r]
               + ax * (1 - ay) * coarse[y0 % r, (x0 + 1) % r]
               + (1 - ax) * ay * coarse[(y0 + 1) % r, x0 % r]
               + ax * ay * coarse[(y0 + 1) % r, (x0 + 1) % r])
        np.testing.assert_allclose(got[i], ref, rtol=2e-4, atol=2e-4)


def test_wide_footprint_converges_to_smooth():
    """A huge footprint clamps to the coarsest level: the lookup loses the
    texture's high-frequency content (variance collapses toward the 8x8
    box average) while preserving the mean."""
    img = _rand_img(seed=4)
    tt = _table_with_image(img)
    rng = np.random.default_rng(5)
    uvn = jnp.asarray(rng.uniform(0, 1, (512, 2)), jnp.float32)
    p = jnp.zeros((512, 3), jnp.float32)
    tid = jnp.zeros(512, jnp.int32)
    fine = np.asarray(texlib.eval_texture(tt, tid, uvn, p,
                                          jnp.zeros(512)))
    coarse = np.asarray(texlib.eval_texture(tt, tid, uvn, p,
                                            jnp.full(512, 1.0)))
    assert coarse.std() < 0.5 * fine.std()
    np.testing.assert_allclose(coarse.mean(), img.mean(), atol=0.02)


def test_level_lerp_is_monotone_between_levels():
    """Fractional widths interpolate between bracketing levels."""
    img = _rand_img(seed=6)
    tt = _table_with_image(img)
    uvn = jnp.asarray([[0.37, 0.61]], jnp.float32)
    p = jnp.zeros((1, 3), jnp.float32)
    tid = jnp.zeros(1, jnp.int32)
    R = img.shape[0]

    def look(w):
        return np.asarray(texlib.eval_texture(
            tt, tid, uvn, p, jnp.full(1, w, jnp.float32)))[0]

    l1 = look(2.0 / R)
    l2 = look(4.0 / R)
    mid = look(2.0 ** 1.5 / R)  # level 1.5
    np.testing.assert_allclose(mid, 0.5 * (l1 + l2), rtol=1e-4, atol=1e-4)


def test_render_with_imagemap_still_works():
    """End-to-end: textured scene renders finite through the wavefront
    (exercises the tri_uv_density/tex_theta plumbing in device+path)."""
    import tempfile
    import os
    from pbrt_v3_iile_tpu.utils import image as imglib
    from pbrt_v3_iile_tpu.scene import api as apilib
    from pbrt_v3_iile_tpu.integrators import render as renderlib

    tex = (np.indices((64, 64)).sum(0) % 2).astype(np.float32)
    tex = np.repeat(tex[..., None], 3, -1)
    with tempfile.TemporaryDirectory() as td:
        fn = os.path.join(td, "check.pfm")
        imglib.write_pfm(fn, tex)
        scene = f"""
        LookAt 0 1 -3  0 0 2  0 1 0
        Camera "perspective" "float fov" [60]
        Film "image" "integer xresolution" [48] "integer yresolution" [48]
        Integrator "path" "integer maxdepth" [2]
        WorldBegin
        LightSource "point" "color I" [20 20 20] "point from" [0 3 -2]
        Texture "chk" "color" "imagemap" "string filename" ["{fn}"]
            "float uscale" [16] "float vscale" [16]
        Material "matte" "texture Kd" "chk"
        Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
            "point P" [-8 0 -4  8 0 -4  8 0 12  -8 0 12]
            "float uv" [0 0  1 0  1 1  0 1]
        WorldEnd
        """
        sd = apilib.load_scene_string(scene)
        img, _ = renderlib.render(sd, spp=2, use_native_bvh=False)
        img = np.asarray(img)
        assert np.isfinite(img).all()
        assert img.mean() > 0.01  # lit, textured
