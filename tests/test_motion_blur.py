"""AnimatedTransform / camera motion blur tests (ref: core/transform.cpp
AnimatedTransform::Decompose/Interpolate; api.cpp TransformSet +
activeTransformBits)."""

import numpy as np
import jax.numpy as jnp

from pbrt_v3_iile_tpu.utils import transforms as xf
from pbrt_v3_iile_tpu.scene import api as apilib
from pbrt_v3_iile_tpu.ops import camera as camlib


def test_decompose_recompose():
    m = xf.translate(1, 2, 3) @ xf.rotate(37, 0.2, 0.9, 0.1) \
        @ xf.scale(2, 1.5, 0.5)
    T, q, S = xf.decompose(m)
    m2 = np.eye(4)
    m2[:3, :3] = xf.quat_to_matrix(q) @ S
    m2[:3, 3] = T
    np.testing.assert_allclose(m2, m, atol=1e-10)


def test_slerp_halfway():
    q0 = xf.matrix_to_quat(np.eye(3))
    q1 = xf.matrix_to_quat(xf.rotate(90, 0, 0, 1)[:3, :3])
    qh = xf.quat_slerp(0.5, q0, q1)
    np.testing.assert_allclose(np.degrees(2 * np.arccos(qh[0])), 45.0,
                               atol=1e-6)


def test_active_transform_parsing():
    """ActiveTransform EndTime moves only the end CTM; the camera desc
    records both transforms (ref: api.cpp pbrtActiveTransformEndTime)."""
    scene_text = """
    TransformTimes 0 1
    LookAt 0 0 -5  0 0 0  0 1 0
    ActiveTransform EndTime
    Translate 2 0 0
    ActiveTransform All
    Camera "perspective" "float fov" [45]
      "float shutteropen" [0] "float shutterclose" [1]
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    WorldBegin
    Material "matte" "color Kd" [0.5 0.5 0.5]
    Shape "trianglemesh" "point P" [-1 -1 0 1 -1 0 1 1 0 -1 1 0]
      "integer indices" [0 1 2 2 3 0]
    WorldEnd
    """
    sd = apilib.load_scene_string(scene_text)
    assert sd.camera.cam_to_world_end is not None
    # start camera at (0,0,-5); end translated in camera space
    np.testing.assert_allclose(sd.camera.cam_to_world[:3, 3], [0, 0, -5],
                               atol=1e-6)
    assert not np.allclose(sd.camera.cam_to_world_end[:3, 3],
                           sd.camera.cam_to_world[:3, 3])


def test_animated_rays_span_positions():
    """Per-ray shutter times interpolate the camera origin between the
    start and end transforms."""
    scene_text = """
    TransformTimes 0 1
    LookAt 0 0 -5  0 0 0  0 1 0
    ActiveTransform EndTime
    ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  -3 0 0 1]
    ActiveTransform All
    Camera "perspective" "float fov" [45]
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    WorldBegin
    WorldEnd
    """
    sd = apilib.load_scene_string(scene_text)
    cam = camlib.make_camera(sd.camera, sd.film)
    N = 64
    p_film = jnp.tile(jnp.asarray([[4.0, 4.0]]), (N, 1))
    u_time = jnp.linspace(0.0, 1.0, N)
    o, d = camlib.generate_rays(cam, p_film, kind=0, u_time=u_time)
    o = np.asarray(o)
    # origins sweep continuously along the translation path
    np.testing.assert_allclose(o[0], [0, 0, -5], atol=1e-5)
    assert abs(np.linalg.norm(o[-1] - o[0]) - 3.0) < 1e-4
    mid = o[N // 2]
    assert 1.0 < np.linalg.norm(mid - o[0]) < 2.0
    assert np.all(np.isfinite(np.asarray(d)))


def test_static_scene_unaffected():
    """Scenes without animation keep cam_to_world_end = None and the
    static ray path."""
    scene_text = """
    LookAt 0 0 -5  0 0 0  0 1 0
    Camera "perspective" "float fov" [45]
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    WorldBegin
    WorldEnd
    """
    sd = apilib.load_scene_string(scene_text)
    assert sd.camera.cam_to_world_end is None


def test_motion_blur_render_smears():
    """End-to-end: a camera translating across the shutter blurs a bright
    quad — more nonzero columns than the static render."""
    from pbrt_v3_iile_tpu.integrators import render as renderlib

    base = """
    %s
    Camera "perspective" "float fov" [60]
    Film "image" "integer xresolution" [32] "integer yresolution" [32]
    Sampler "random" "integer pixelsamples" [1]
    Integrator "path" "integer maxdepth" [1]
    WorldBegin
    AttributeBegin
      AreaLightSource "area" "color L" [5 5 5]
      Material "matte" "color Kd" [0 0 0]
      Shape "trianglemesh" "point P" [-0.3 -2 0 0.3 -2 0 0.3 2 0 -0.3 2 0]
        "integer indices" [0 1 2 2 3 0]
    AttributeEnd
    WorldEnd
    """
    static = base % 'LookAt 0 0 4  0 0 0  0 1 0'
    animated = base % """TransformTimes 0 1
    LookAt 0 0 4  0 0 0  0 1 0
    ActiveTransform EndTime
    Translate 1.5 0 0
    ActiveTransform All"""
    img_s, _ = renderlib.render(apilib.load_scene_string(static), spp=8,
                                use_native_bvh=False)
    img_a, _ = renderlib.render(apilib.load_scene_string(animated), spp=8,
                                use_native_bvh=False)
    cols_s = int((np.asarray(img_s).sum(axis=(0, 2)) > 1e-5).sum())
    cols_a = int((np.asarray(img_a).sum(axis=(0, 2)) > 1e-5).sum())
    assert cols_a > cols_s + 2, (cols_s, cols_a)


def test_object_motion_blur_smears():
    """Object motion blur (TransformedPrimitive role, ref: primitive.h +
    transform.h:412): a quad translating across the shutter under a
    static camera smears over more columns than the static render, and
    both shutter endpoints receive energy."""
    from pbrt_v3_iile_tpu.integrators import render as renderlib

    base = """
    LookAt 0 0 4  0 0 0  0 1 0
    Camera "perspective" "float fov" [60]
      "float shutteropen" [0] "float shutterclose" [1]
    Film "image" "integer xresolution" [32] "integer yresolution" [32]
    Sampler "random" "integer pixelsamples" [1]
    Integrator "path" "integer maxdepth" [1]
    WorldBegin
    AttributeBegin
      AreaLightSource "area" "color L" [5 5 5]
      Material "matte" "color Kd" [0 0 0]
      %s
      Shape "trianglemesh" "point P" [-0.3 -2 0 0.3 -2 0 0.3 2 0 -0.3 2 0]
        "integer indices" [0 1 2 2 3 0]
    AttributeEnd
    WorldEnd
    """
    static = base % ""
    animated = ("TransformTimes 0 1\n" + base) % """ActiveTransform EndTime
      Translate 1.5 0 0
      ActiveTransform All"""
    sd_a = apilib.load_scene_string(animated)
    assert sd_a.has_motion
    assert sd_a.camera.cam_to_world_end is None  # camera is static
    img_s, _ = renderlib.render(apilib.load_scene_string(static), spp=8,
                                use_native_bvh=False)
    img_a, _ = renderlib.render(sd_a, spp=8,
                                use_native_bvh=False)
    cols_s = int((np.asarray(img_s).sum(axis=(0, 2)) > 1e-5).sum())
    cols_a = int((np.asarray(img_a).sum(axis=(0, 2)) > 1e-5).sum())
    assert cols_a > cols_s + 2, (cols_s, cols_a)
    # energy is conserved-ish: blur spreads, does not create light
    assert np.asarray(img_a).sum() < np.asarray(img_s).sum() * 1.2


def test_static_scene_has_no_motion_flag():
    sd = apilib.load_scene_string("""
    LookAt 0 0 4  0 0 0  0 1 0
    Camera "perspective" "float fov" [60]
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    WorldBegin
    Material "matte" "color Kd" [0.5 0.5 0.5]
    Shape "trianglemesh" "point P" [-1 -1 0 1 -1 0 1 1 0 -1 1 0]
      "integer indices" [0 1 2 2 3 0]
    WorldEnd
    """)
    assert not sd.has_motion


def test_rotating_blade_sweeps_not_shrinks():
    """A triangle blade rotating 90 deg about +y must be intersectable
    at its slerped mid-shutter position (45 deg) — the old two-keyframe
    vertex lerp collapses it toward the chord (ref: transform.h:412
    AnimatedTransform::Decompose/Interpolate)."""
    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.ops import intersect as isect

    scene_text = """
    TransformTimes 0 1
    LookAt 0 0 -5  0 0 0  0 1 0
    Camera "perspective" "float fov" [45]
      "float shutteropen" [0] "float shutterclose" [1]
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    WorldBegin
    LightSource "point" "rgb I" [10 10 10]
    Material "matte" "color Kd" [0.5 0.5 0.5]
    AttributeBegin
      ActiveTransform EndTime
      Rotate 90 0 1 0
      ActiveTransform All
      # long thin blade along +x: from r=0.2 to r=2.0
      Shape "trianglemesh" "point P" [0.2 -0.05 0  2.0 -0.05 0  2.0 0.05 0  0.2 0.05 0]
        "integer indices" [0 1 2 2 3 0]
    AttributeEnd
    WorldEnd
    """
    sd = apilib.load_scene_string(scene_text)
    assert sd.has_motion
    scene, cam = renderlib.build(sd)
    Ms = scene.tris_steps_packed.shape[0]
    assert Ms >= 7, f"90-degree rotation needs >=7 sub-keyframes, got {Ms}"

    # at t=0.5 the blade lies along the -45-degree direction (+x
    # rotates toward -z under a +90 rotation about +y); shoot a ray
    # straight at a point on it
    r = 1.6
    target = np.array([r / np.sqrt(2), 0.0, -r / np.sqrt(2)])
    o = jnp.asarray([[target[0], 0.0, -5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    tm = jnp.full((1,), 1e30)
    hit_mid = isect.intersect(scene, o, d, tm,
                              time=jnp.asarray([0.5], jnp.float32))
    assert bool(hit_mid.valid[0]), \
        "ray at the slerped mid-shutter position must hit the blade"
    # hit z should be near the rotated blade plane z = target[2]
    z_hit = float(o[0, 2] + hit_mid.t[0] * d[0, 2])
    np.testing.assert_allclose(z_hit, target[2], atol=0.05)

    # at t=0 the blade lies in the z=0 plane: the same ray hits it at
    # z ~ 0, NOT at the rotated plane
    h0 = isect.intersect(scene, o, d, tm,
                         time=jnp.asarray([0.0], jnp.float32))
    assert bool(h0.valid[0])
    np.testing.assert_allclose(float(o[0, 2] + h0.t[0] * d[0, 2]), 0.0,
                               atol=0.05)
    # at t=1 the blade lies along -z at x ~ 0: the ray (x=1.13) misses
    h1 = isect.intersect(scene, o, d, tm,
                         time=jnp.asarray([1.0], jnp.float32))
    assert not bool(h1.valid[0]), "ray must miss at t=1"

    # chord shrink check: the vertex-lerped midpoint would put the blade
    # tip at radius 2*cos(45deg/..)~1.41*sqrt(2)/2... assert the tip
    # survives at full radius: aim near the tip (r=1.95) at 45 deg
    rt = 1.95
    o2 = jnp.asarray([[rt / np.sqrt(2), 0.0, -5.0]], jnp.float32)
    h2 = isect.intersect(scene, o2, d, tm,
                         time=jnp.asarray([0.5], jnp.float32))
    assert bool(h2.valid[0]), "blade tip must stay at full radius mid-sweep"
