"""Tests that need an NVIDIA GPU (marker `gpu`; they skip elsewhere).
Run them on the card with `python -m pytest -m gpu tests/`."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_compiled_cluster_kernel_matches_walker(gpu):
    """The kernel as compiled for the card (no interpret mode) against
    the XLA walker on an atrium primary wave."""
    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.ops import intersect as isect
    from pbrt_v3_iile_tpu.scene import api as apilib

    sd = apilib.load_scene(os.path.join(REPO, "scenes", "atrium.pbrt"))
    sd.film.x_resolution = sd.film.y_resolution = 128
    scene, cam = renderlib.build(sd, accel="clusters")
    prep, _ = renderlib.make_wave_prep(sd)
    o, d, *_ = jax.jit(prep)(cam, jax.random.PRNGKey(0), jnp.int32(0),
                             jnp.int32(0))
    tm = jnp.full((o.shape[0],), 1e30)
    got = isect.intersect(scene, o, d, tm, accel="clusters")
    ref = isect.intersect(scene, o, d, tm, accel="bvh")
    gv, rv = np.asarray(got.valid), np.asarray(ref.valid)
    assert (gv == rv).mean() > 0.999
    both = gv & rv
    np.testing.assert_allclose(np.asarray(got.t)[both],
                               np.asarray(ref.t)[both], rtol=1e-3)
