"""Backend selection and GPU entry points, checked on the CPU: the one
traversal decision (ops/intersect.default_accel), the compile-cache
location, and the GPU scripts' refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from pbrt_v3_iile_tpu.ops import intersect as isect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,accel", [("cpu", "bvh"),
                                            ("gpu", "clusters"),
                                            ("metal", None)])
def test_default_accel(platform, accel):
    if accel is None:
        with pytest.raises(RuntimeError, match="metal"):
            isect.default_accel(platform)
    else:
        assert isect.default_accel(platform) == accel


def test_default_accel_follows_the_backend():
    assert isect.default_accel() == isect.default_accel(
        jax.default_backend())


def test_resolve_accel_on_cpu():
    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.scene import api as apilib

    sd = apilib.load_scene(os.path.join(REPO, "scenes", "atrium.pbrt"))
    assert renderlib.resolve_accel(sd) == "bvh"
    assert renderlib.resolve_accel(sd, "kdtree") == "kdtree"
    sd.accelerator = "kdtree"
    assert renderlib.resolve_accel(sd) == "kdtree"
    with pytest.raises(ValueError, match="GPU"):
        renderlib.resolve_accel(sd, "clusters")
    # cluster tables are built only for the cluster traversal
    scene, _ = renderlib.build(apilib.load_scene_string(
        'Film "image" "integer xresolution" [8] "integer yresolution" [8]\n'
        'WorldBegin\nShape "trianglemesh" "point P" [0 0 0 1 0 0 0 1 0] '
        '"integer indices" [0 1 2]\nWorldEnd\n'))
    assert scene.clusters is None


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(env_set, monkeypatch, tmp_path):
    from pbrt_v3_iile_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
            assert compile_cache.enable() == str(tmp_path)
            # JAX reads the variable itself: nothing else is set
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv(compile_cache.ENV, raising=False)
            path = compile_cache.enable(str(tmp_path))
            assert path == os.path.join(str(tmp_path), ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            assert compile_cache.CHECKOUT == REPO
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("script,alone", [("chip_smoke.py", False),
                                          ("chip_smoke.py", True),
                                          ("bench.py", False)])
def test_gpu_scripts_fail_without_a_gpu(script, alone, tmp_path):
    """On the CPU (or copied away from the package) the GPU scripts exit
    non-zero and print no result line."""
    path = os.path.join(REPO, script)
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        path = shutil.copy(path, tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, path], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("integrator", ["path", "iispt"])
def test_cli_renders_atrium_quick_on_cpu(integrator, tmp_path):
    """The CLI's own path on the CPU: atrium at --quick (128^2)."""
    import numpy as np

    from pbrt_v3_iile_tpu.cli import main as climain
    from pbrt_v3_iile_tpu.utils import image as imglib

    out = str(tmp_path / "out.pfm")
    argv = [os.path.join(REPO, "scenes", "atrium.pbrt"), out, "--cpu",
            "--quick", "--spp", "1", "--integrator", integrator]
    if integrator == "iispt":
        argv += ["--iileIndirect", "1", "--iileDirect", "1",
                 "--iispt_hemi_size", "8"]
    before = jax.config.jax_compilation_cache_dir
    try:
        assert climain.main(argv) == 0
    finally:  # the CLI turns the persistent cache on for the process
        jax.config.update("jax_compilation_cache_dir", before)
    img = imglib.read_pfm(out)
    assert img.shape == (128, 128, 3)
    assert np.isfinite(img).all() and img.mean() > 0
