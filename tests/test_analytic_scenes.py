"""Integration test: analytic scenes with known exact radiance
(coverage model: src/tests/analytic_scenes.cpp CheckSceneAverage —
image mean must match the closed-form value within delta)."""

import numpy as np
import pytest

from pbrt_v3_iile_tpu.scene import api as apilib
from pbrt_v3_iile_tpu.integrators import render as renderlib

# inside a unit sphere with albedo rho and point light I=pi at center:
# L = sum_k rho^k * (I/pi)/(1) ... = rho/(1-rho) * E/pi with E=I -> for
# rho=.5, I=pi: L = 1 exactly (ref: analytic_scenes.cpp:68-90)
SPHERE_GI = """
LookAt 0 0 0  1 0 0  0 0 1
Camera "perspective" "float fov" [90]
Film "image" "integer xresolution" [24] "integer yresolution" [24]
Integrator "path" "integer maxdepth" [12]
WorldBegin
LightSource "point" "color I" [3.14159265 3.14159265 3.14159265]
AttributeBegin
  ReverseOrientation
  Material "matte" "color Kd" [0.5 0.5 0.5]
  Shape "sphere" "float radius" [1]
AttributeEnd
WorldEnd
"""

# direct lighting only: first bounce is rho/pi * E = 0.5
SPHERE_DIRECT = SPHERE_GI.replace(
    'Integrator "path" "integer maxdepth" [12]',
    'Integrator "directlighting" "integer maxdepth" [2]')


@pytest.mark.slow
def test_sphere_multibounce_radiance_is_one():
    sd = apilib.load_scene_string(SPHERE_GI)
    img, _ = renderlib.render(sd, spp=8, use_native_bvh=True)
    assert abs(float(img.mean()) - 1.0) < 0.02


@pytest.mark.slow
def test_sphere_direct_radiance_is_half():
    sd = apilib.load_scene_string(SPHERE_DIRECT)
    img, _ = renderlib.render(sd, spp=8, use_native_bvh=True)
    assert abs(float(img.mean()) - 0.5) < 0.01


@pytest.mark.slow
def test_area_light_furnace():
    """Camera inside emitting sphere sees exactly L everywhere."""
    scene = """
LookAt 0 0 0  1 0 0  0 0 1
Camera "perspective" "float fov" [90]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Integrator "path" "integer maxdepth" [2]
WorldBegin
AttributeBegin
  Material "matte" "color Kd" [0 0 0]
  AreaLightSource "area" "color L" [2 3 4] "bool twosided" "true"
  Shape "sphere" "float radius" [1]
AttributeEnd
WorldEnd
"""
    sd = apilib.load_scene_string(scene)
    img, _ = renderlib.render(sd, spp=2)
    assert np.allclose(img.mean(axis=(0, 1)), [2, 3, 4], rtol=0.02)


# ---------------------------------------------------------------------------
# scenes x samplers x integrators matrix (coverage model:
# analytic_scenes.cpp:420-439 INSTANTIATE_TEST_CASE_P — the reference
# crosses its analytic scenes with every sampler and integrator and
# checks the image mean against the closed form)
# ---------------------------------------------------------------------------

def _gi_scene(sampler, integrator, depth, res=12):
    txt = SPHERE_GI.replace(
        'Integrator "path" "integer maxdepth" [12]',
        f'Integrator "{integrator}" "integer maxdepth" [{depth}]\n'
        f'Sampler "{sampler}" "integer pixelsamples" [8]').replace(
        '"integer xresolution" [24] "integer yresolution" [24]',
        f'"integer xresolution" [{res}] "integer yresolution" [{res}]')
    return apilib.load_scene_string(txt)


@pytest.mark.slow
@pytest.mark.parametrize("sampler", ["random", "sobol", "halton",
                                     "stratified"])
def test_matrix_path_samplers(sampler):
    """Every sampler kind must converge to the same analytic mean
    (ref: analytic_scenes.cpp crosses samplers x integrators)."""
    sd = _gi_scene(sampler, "path", 12, res=16)
    img, _ = renderlib.render(sd, spp=8)
    assert abs(float(img.mean()) - 1.0) < 0.03, (sampler, img.mean())


@pytest.mark.slow
@pytest.mark.parametrize("integrator,depth,expect,tol", [
    # NEE fires at bounces 0..maxDepth-1 -> vertices v1..v3 ->
    # rho + rho^2 + rho^3 = 0.875 (pbrt path.cpp breaks BEFORE the NEE
    # of bounce maxDepth; bdpt bounds s+t-2 <= maxDepth identically)
    ("path", 3, 0.875, 0.02),
    ("volpath", 3, 0.875, 0.02),      # no media -> identical transport
    ("bdpt", 3, 0.875, 0.04),         # incl. t=1 splat strategies
])
def test_matrix_integrators(integrator, depth, expect, tol):
    sd = _gi_scene("random", integrator, depth)
    img, _ = renderlib.render(sd, spp=6)
    assert abs(float(img.mean()) - expect) < tol, (integrator, img.mean())


@pytest.mark.slow
def test_matrix_mlt_sphere():
    """PSSMLT on the GI sphere: unbiased wrt the same target (wider
    tolerance — Metropolis normalization is itself Monte Carlo)."""
    sd = _gi_scene("random", "mlt", 3)
    from pbrt_v3_iile_tpu.integrators import mlt as mltlib
    img, st = mltlib.render_mlt(sd, mutations_per_pixel=64, seed=0)
    assert abs(float(img.mean()) - 0.875) < 0.1, img.mean()


# ---------------------------------------------------------------------------
# Per-lobe furnace tests (VERDICT r1 #10: closed-form furnace per BSDF
# lobe).  A convex object under a uniform infinite light L=1 reflects
# exactly its hemispherical albedo into every pixel: lossless lobes give
# 1, every physical lobe gives <= 1 (white-furnace energy conservation).
# ---------------------------------------------------------------------------

def _furnace_scene(mat, depth=16):
    return f"""
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [30]
Film "image" "integer xresolution" [24] "integer yresolution" [24]
Integrator "path" "integer maxdepth" [{depth}]
WorldBegin
LightSource "infinite" "color L" [1 1 1]
{mat}
Shape "sphere" "float radius" [1]
WorldEnd
"""


def _furnace_mean(mat, spp=48):
    sd = apilib.load_scene_string(_furnace_scene(mat))
    img = np.asarray(renderlib.render(sd, spp=spp, seed=11)[0])
    h, w = img.shape[:2]
    # center crop: pixels guaranteed on the sphere (radius 1 at fov 30
    # from z=-4 covers ~the central half of the frame)
    c = img[h // 3: 2 * h // 3, w // 3: 2 * w // 3]
    assert np.isfinite(c).all()
    return float(c.mean())


@pytest.mark.slow
@pytest.mark.parametrize("mat", [
    'Material "matte" "color Kd" [1 1 1]',
    'Material "matte" "color Kd" [1 1 1] "float sigma" [20]',  # oren-nayar
    'Material "mirror" "color Kr" [1 1 1]',
])
def test_furnace_lossless_lobes_reflect_unity(mat):
    m = _furnace_mean(mat)
    # oren-nayar's A/B model loses ~10% energy at sigma=20 (a known
    # property of the reference model too) — allow 12% low, 2% high
    assert 0.88 < m < 1.02, (mat, m)


@pytest.mark.slow
@pytest.mark.parametrize("mat,lo", [
    ('Material "plastic" "color Kd" [0.9 0.9 0.9] "color Ks" [0.1 0.1 0.1]'
     ' "float roughness" [0.2]', 0.55),
    ('Material "metal"', 0.55),                       # copper Fresnel
    ('Material "substrate" "color Kd" [0.8 0.8 0.8]'
     ' "color Ks" [0.2 0.2 0.2]', 0.5),
    ('Material "uber"', 0.2),           # default Kd=0.25
    ('Material "disney" "color color" [0.9 0.9 0.9]', 0.45),
    ('Material "translucent"', 0.2),    # default Kd=0.25
    ('Material "glass"', 0.8),
])
def test_furnace_physical_lobes_bounded(mat, lo):
    """White-furnace upper bound: no lobe may create energy; lower bound
    guards against silent energy loss regressions."""
    m = _furnace_mean(mat)
    assert m <= 1.05, (mat, m)
    assert m >= lo, (mat, m)
