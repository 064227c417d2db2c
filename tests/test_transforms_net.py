"""CNN transform parity + network shape tests — coverage the reference
LACKS (SURVEY §4: 'no automated tests of the CNN or train/eval
transforms')."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrt_v3_iile_tpu.models import transforms as nnx
from pbrt_v3_iile_tpu.models import iisptnet
from pbrt_v3_iile_tpu.ml import dataset as datasetlib


def test_positive_log_matches_reference_semantics():
    # npLog: clip(x+1, 1, None) then log (iispt_transforms.py:22-26)
    x = jnp.array([-5.0, -0.5, 0.0, 1.0, 10.0])
    y = np.asarray(nnx.positive_log(x))
    expect = np.log(np.clip(np.asarray(x) + 1.0, 1.0, None))
    assert np.allclose(y, expect)


def test_intensity_down_up_roundtrip():
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 5, (32, 32, 3)), jnp.float32)
    mean = jnp.mean(img)
    down = nnx.intensity_downstream_half(img, mean)
    up = nnx.intensity_upstream(down, mean)
    assert np.allclose(np.asarray(up), np.asarray(img), rtol=1e-4, atol=1e-4)


def test_full_half_differ_by_0p1():
    img = jnp.asarray(np.random.default_rng(1).uniform(0, 5, (8, 8, 3)))
    m = jnp.mean(img)
    d = np.asarray(nnx.intensity_downstream_full(img, m)
                   - nnx.intensity_downstream_half(img, m))
    assert np.allclose(d, -0.1, atol=1e-6)


def test_probe_pipeline_shapes_and_mean_matching():
    rng = np.random.default_rng(2)
    P = 3
    inten = jnp.asarray(rng.uniform(0, 4, (P, 16, 16, 3)), jnp.float32)
    nrm = jnp.asarray(rng.uniform(-1, 1, (P, 16, 16, 3)), jnp.float32)
    dist = jnp.asarray(rng.uniform(0, 9, (P, 16, 16, 1)), jnp.float32)
    x, aux = nnx.probe_to_network_input(inten, nrm, dist)
    assert x.shape == (P, 16, 16, 7)
    assert aux["chan_means"].shape == (P, 3)
    # identity network output (predict the downstream-half of input):
    # upstream should reproduce per-channel means of the input
    y = nnx.intensity_downstream_half(
        inten, aux["overall_mean"][:, None, None, None])
    out = nnx.network_output_to_radiance(y, aux)
    got = np.asarray(out.mean(axis=(1, 2)))
    want = np.asarray(aux["chan_means"])
    assert np.allclose(got, want, rtol=1e-3)


def test_iisptnet_shapes():
    net, variables = iisptnet.init_params(jax.random.PRNGKey(0),
                                          hemi_size=32, k=8)
    x = jnp.zeros((2, 32, 32, 7))
    y = net.apply(variables, x, train=False)
    assert y.shape == (2, 32, 32, 3)
    assert (np.asarray(y) >= 0).all()  # final ReLU


def test_iisptnet_train_mode_updates_batchstats():
    net, variables = iisptnet.init_params(jax.random.PRNGKey(0),
                                          hemi_size=16, k=4)
    x = jax.random.uniform(jax.random.PRNGKey(1), (4, 16, 16, 7))
    y, updates = net.apply(variables, x, train=True, mutable=["batch_stats"])
    assert "batch_stats" in updates


def test_augment_16_unique():
    base = jnp.arange(16.0).reshape(1, 4, 4, 1)
    seen = set()
    for aug in range(16):
        m = np.asarray(datasetlib.augment(base, aug)).tobytes()
        seen.add(m)
    # rotations+flips of a generic array give 8 distinct layouts; all
    # 16 aug indices must be valid (4 flips x 4 rotations)
    assert len(seen) >= 8


def test_example_from_maps():
    rng = np.random.default_rng(3)
    p = jnp.asarray(rng.uniform(0, 3, (8, 8, 3)), jnp.float32)
    d = jnp.asarray(rng.uniform(0, 3, (8, 8, 3)), jnp.float32)
    n = jnp.asarray(rng.uniform(-1, 1, (8, 8, 3)), jnp.float32)
    z = jnp.asarray(rng.uniform(0, 5, (8, 8, 1)), jnp.float32)
    x, y = datasetlib.example_from_maps(p, d, n, z, aug=5)
    assert x.shape == (8, 8, 7)
    assert y.shape == (8, 8, 3)
    assert np.isfinite(np.asarray(x)).all()


@pytest.mark.parametrize("train", [False, True])
def test_iisptnet_matches_flax_golden(train):
    """The plain-lax U-Net reproduces the earlier flax.linen module's
    output on a seeded input (golden written by that module: k=4,
    (2,16,16,7) input, random BatchNorm affine and running statistics),
    in eval mode and in train mode with its running-stat update."""
    import os

    from pbrt_v3_iile_tpu.ml import train as trainlib

    z = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "iisptnet_k4_flax.npz"))
    tree = trainlib._unflatten_tree(
        {k: z[k] for k in z.files if "/" in k})
    variables = {"params": tree["params"],
                 "batch_stats": tree["batch_stats"]}
    net = iisptnet.IISPTNet(k=4)
    x = jnp.asarray(z["x"])
    if train:
        y, upd = net.apply(variables, x, train=True,
                           mutable=["batch_stats"])
        np.testing.assert_allclose(np.asarray(y), z["y_train"],
                                   rtol=1e-5, atol=1e-6)
        for name, st in tree["updated_stats"].items():
            for k in ("mean", "var"):
                np.testing.assert_allclose(
                    np.asarray(upd["batch_stats"][name][k]),
                    np.asarray(st[k]), rtol=1e-5, atol=1e-6)
    else:
        y = net.apply(variables, x, train=False)
        np.testing.assert_allclose(np.asarray(y), z["y_eval"],
                                   rtol=1e-5, atol=1e-6)

