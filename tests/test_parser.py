"""Parser/API tests (coverage model: src/tests/parser.cpp)."""

import numpy as np

from pbrt_v3_iile_tpu.scene import api as apilib
from pbrt_v3_iile_tpu.scene.parser import tokenize
from pbrt_v3_iile_tpu.scene.paramset import ParamSet


def test_tokenize():
    toks = list(tokenize('Shape "sphere" "float radius" [3] # comment\nWorldEnd'))
    assert toks == ['Shape', '"sphere"', '"float radius"', '[', '3', ']',
                    'WorldEnd']


def test_paramset():
    ps = ParamSet()
    ps.add("float radius", [3.0])
    ps.add("color L", [1.0, 2.0, 3.0])
    ps.add("integer indices", [0, 1, 2])
    ps.add("string filename", ["out.exr"])
    ps.add("bool jitter", ["true"])
    assert ps.find_one_float("radius", 0) == 3.0
    assert np.allclose(ps.find_one_rgb("L", [0, 0, 0]), [1, 2, 3])
    assert ps.find_ints("indices").tolist() == [0, 1, 2]
    assert ps.find_one_string("filename", "") == "out.exr"
    assert ps.find_one_bool("jitter", False) is True


SCENE = """
LookAt 400 20 30   0 63 -110   0 0 1
Rotate -5 0 0 1
Camera "perspective" "float fov" [39]
Film "image" "integer xresolution" [700] "integer yresolution" [700]
Sampler "halton" "integer pixelsamples" [8]
Integrator "path"
WorldBegin
AttributeBegin
Material "matte" "color Kd" [0 0 0]
Translate 150 0 20
AreaLightSource "area" "color L" [2000 2000 2000]
Shape "sphere" "float radius" [3]
AttributeEnd
AttributeBegin
  Material "plastic" "color Kd" [.4 .2 .2] "color Ks" [.5 .5 .5]
      "float roughness" [.025]
  Shape "trianglemesh" "point P" [ -1 -1 0 1 -1 0 1 1 0 -1 1 0 ]
    "integer indices" [ 0 1 2 2 3 0]
AttributeEnd
WorldEnd
"""


def test_scene_structure():
    sd = apilib.load_scene_string(SCENE)
    assert sd.camera.fov == 39.0
    assert sd.film.x_resolution == 700
    assert sd.sampler.pixel_samples == 8
    assert sd.integrator.kind == "path"
    assert sd.n_triangles == 2
    assert len(sd.spheres) == 1  # emitting sphere stays analytic
    assert len(sd.lights) == 1
    assert sd.lights[0].kind == apilib.LIGHT_AREA_SPHERE
    # sphere translated to (150, 0, 20)
    assert np.allclose(sd.spheres[0]["center"], [150, 0, 20])
    assert sd.spheres[0]["radius"] == 3.0
    # plastic material recorded
    m = sd.materials[-1]
    assert m.kind == apilib.MAT_PLASTIC
    assert np.allclose(m.kd, [0.4, 0.2, 0.2])
    assert m.roughness == 0.025


def test_attribute_stack_restores_state():
    sd = apilib.load_scene_string("""
WorldBegin
Material "matte" "color Kd" [0.9 0.9 0.9]
AttributeBegin
Material "mirror"
AttributeEnd
Shape "trianglemesh" "point P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
WorldEnd
""")
    # shape gets the matte (outer) material, not mirror
    mat = sd.materials[sd.tri_blocks[0]["mat"][0]]
    assert mat.kind == apilib.MAT_MATTE


def test_atrium_scene_parses():
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "atrium.pbrt")
    sd = apilib.load_scene(path)
    assert sd.n_triangles > 10000  # PLY furniture + two rooms
    assert len(sd.spheres) == 0
    assert len(sd.lights) == 3     # sun, sky and the lamp's area light
    assert sd.film.x_resolution == 512
    assert sd.integrator.max_depth == 6
