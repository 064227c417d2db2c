"""Hair BSDF tests — mirrors the reference's src/tests/hair.cpp
(WhiteFurnace / WhiteFurnaceSampled / SamplingConsistency)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_v3_iile_tpu.ops import hair as hairlib


def _uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


@pytest.mark.parametrize("beta", [(0.6, 0.6), (0.4, 0.4)])
def test_white_furnace(beta):
    """sigma_a = 0 fiber conserves energy: ∫ f |cos| dw ≈ 1
    (ref: hair.cpp TEST(Hair, WhiteFurnace))."""
    beta_m, beta_n = beta
    N = 200_000
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    wo = _uniform_sphere(jax.random.uniform(k1, (1, 2)))
    wi = _uniform_sphere(jax.random.uniform(k2, (N, 2)))
    h = jnp.full(N, 0.33, jnp.float32)
    sigma_a = jnp.zeros((N, 3), jnp.float32)
    f = hairlib.evaluate(jnp.broadcast_to(wo, (N, 3)), wi, h, sigma_a,
                         jnp.full(N, beta_m), jnp.full(N, beta_n))
    # uniform-sphere pdf = 1/4pi
    est = jnp.mean(f * jnp.abs(wi[:, 2:3]), axis=0) * 4.0 * jnp.pi
    np.testing.assert_allclose(np.asarray(est), 1.0, atol=0.06)


def test_white_furnace_sampled():
    """Importance-sampled furnace: E[f |cos| / pdf] = 1
    (ref: hair.cpp WhiteFurnaceSampled)."""
    N = 100_000
    key = jax.random.PRNGKey(3)
    ko, ku = jax.random.split(key)
    wo = jnp.broadcast_to(_uniform_sphere(jax.random.uniform(ko, (1, 2))),
                          (N, 3))
    u4 = jax.random.uniform(ku, (N, 4))
    h = jnp.full(N, -0.25, jnp.float32)
    sigma_a = jnp.zeros((N, 3), jnp.float32)
    bm = jnp.full(N, 0.5)
    bn = jnp.full(N, 0.4)
    wi, f, pdf = hairlib.sample(wo, u4, h, sigma_a, bm, bn)
    w = jnp.where((pdf > 0)[:, None],
                  f * jnp.abs(wi[:, 2:3]) / jnp.maximum(pdf, 1e-9)[:, None],
                  0.0)
    np.testing.assert_allclose(np.asarray(jnp.mean(w, axis=0)), 1.0,
                               atol=0.08)


def test_pdf_normalized():
    """Pdf integrates to 1 over the sphere (ref: hair.cpp SamplingWeights
    invariant)."""
    N = 200_000
    key = jax.random.PRNGKey(11)
    wo = jnp.broadcast_to(
        jnp.asarray([[0.3, 0.8, jnp.sqrt(1 - 0.09 - 0.64)]], jnp.float32),
        (N, 3))
    wi = _uniform_sphere(jax.random.uniform(key, (N, 2)))
    h = jnp.full(N, 0.55, jnp.float32)
    sigma_a = jnp.full((N, 3), 0.5, jnp.float32)
    pdf = hairlib.pdf(wo, wi, h, sigma_a, jnp.full(N, 0.3), jnp.full(N, 0.3))
    est = jnp.mean(pdf) * 4.0 * jnp.pi
    np.testing.assert_allclose(float(est), 1.0, atol=0.06)


def test_sampling_consistency():
    """Sampled f/pdf agree with evaluate/pdf at the sampled direction
    (ref: hair.cpp SamplingConsistency)."""
    N = 4096
    key = jax.random.PRNGKey(5)
    ko, ku, kh = jax.random.split(key, 3)
    wo = _uniform_sphere(jax.random.uniform(ko, (N, 2)))
    u4 = jax.random.uniform(ku, (N, 4))
    h = jax.random.uniform(kh, (N,), minval=-0.9, maxval=0.9)
    sigma_a = jnp.full((N, 3), 0.25, jnp.float32)
    bm = jnp.full(N, 0.4)
    bn = jnp.full(N, 0.35)
    wi, f_s, pdf_s = hairlib.sample(wo, u4, h, sigma_a, bm, bn)
    f_e = hairlib.evaluate(wo, wi, h, sigma_a, bm, bn)
    pdf_e = hairlib.pdf(wo, wi, h, sigma_a, bm, bn)
    np.testing.assert_allclose(np.asarray(f_s), np.asarray(f_e), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(pdf_s), np.asarray(pdf_e),
                               rtol=1e-4, atol=1e-6)


def test_sigma_a_from_reflectance_roundtrip_direction():
    """Darker target color -> more absorption, elementwise monotone."""
    bn = 0.3
    light = hairlib.sigma_a_from_reflectance(jnp.full(3, 0.8), bn)
    dark = hairlib.sigma_a_from_reflectance(jnp.full(3, 0.1), bn)
    assert np.all(np.asarray(dark) > np.asarray(light))


def test_hair_material_in_scene_renders():
    """End-to-end: a hair-material patch lit by a point light renders
    finite, non-negative radiance through the wavefront integrator."""
    from pbrt_v3_iile_tpu.scene import api as apilib
    from pbrt_v3_iile_tpu.integrators import render as renderlib

    scene_text = """
    LookAt 0 1 -4  0 1 0  0 1 0
    Camera "perspective" "float fov" [45]
    Film "image" "integer xresolution" [16] "integer yresolution" [16]
    Integrator "path" "integer maxdepth" [3]
    WorldBegin
    LightSource "point" "color I" [20 20 20] "point from" [0 3 -2]
    Material "hair" "float beta_m" [0.3] "float beta_n" [0.35]
      "float eumelanin" [0.5]
    Shape "trianglemesh" "point P" [-2 0 0 2 0 0 2 3 0 -2 3 0]
      "integer indices" [0 1 2 2 3 0]
    WorldEnd
    """
    sd = apilib.load_scene_string(scene_text)
    img, _ = renderlib.render(sd, spp=4, use_native_bvh=False)
    img = np.asarray(img)
    assert np.all(np.isfinite(img))
    assert img.max() > 0.0
