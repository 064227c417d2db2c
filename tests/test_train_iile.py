"""End-to-end IILE ML pipeline test: on-device dataset generation ->
U-Net training (loss decreases) -> inference through the probe pipeline.
(Replaces-and-tests the reference flow render_reference -> main_train.py
-> main_stdio_net.py, which had no automated tests at all.)"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrt_v3_iile_tpu.scene import api as apilib
from pbrt_v3_iile_tpu.integrators import render as renderlib

SCENE = """
LookAt 0 2.5 -6  0 2.5 0  0 1 0
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Integrator "iispt" "integer maxdepth" [4]
WorldBegin
AttributeBegin
  Material "matte" "color Kd" [0 0 0]
  AreaLightSource "area" "color L" [20 20 20]
  Translate 0 4.5 0
  Shape "sphere" "float radius" [0.4]
AttributeEnd
Material "matte" "color Kd" [0.6 0.6 0.6]
Shape "trianglemesh" "point P" [-5 0 -5 5 0 -5 5 0 5 -5 0 5]
  "integer indices" [0 1 2 2 3 0]
Material "matte" "color Kd" [0.7 0.3 0.3]
Shape "trianglemesh" "point P" [-5 0 3 5 0 3 5 5 3 -5 5 3]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""

HEMI = 8


@pytest.mark.slow
def test_dataset_generation_and_training(tmp_path):
    from pbrt_v3_iile_tpu.ml import dataset as datasetlib
    from pbrt_v3_iile_tpu.ml import train as trainlib
    from pbrt_v3_iile_tpu.parallel import mesh as meshlib

    sd = apilib.load_scene_string(SCENE)
    scene, cam = renderlib.build(sd, use_native_bvh=True)
    key = jax.random.PRNGKey(0)

    # reference-tiles style probe grid (ref: iispt.cpp:498 render_reference)
    g = jnp.linspace(2, 29, 4).astype(jnp.int32)
    gx, gy = jnp.meshgrid(g, g)
    coords = jnp.stack([gx, gy], -1).reshape(-1, 2)

    gen = jax.jit(lambda scene, key: datasetlib.generate_examples(
        scene, cam, 0, key, coords, hemi_size=HEMI, gt_spp=2))
    maps = gen(scene, key)
    assert maps["p"].shape == (16, HEMI, HEMI, 3)
    assert bool(maps["valid"].any())
    assert np.isfinite(np.asarray(maps["p"])).all()

    raw = [
        {k: np.asarray(maps[k][i]) for k in "pdnz"}
        for i in range(16) if bool(maps["valid"][i])
    ]
    assert len(raw) >= 4

    # train a small net; loss must decrease
    mesh = meshlib.make_mesh(1)
    state = trainlib.init_training(jax.random.PRNGKey(1), hemi_size=HEMI,
                                   mesh=mesh)
    # shrink the net for test speed
    from pbrt_v3_iile_tpu.models import iisptnet
    import optax
    net = iisptnet.IISPTNet(k=8)
    variables = net.init(jax.random.PRNGKey(2),
                         jnp.zeros((1, HEMI, HEMI, 7)), train=False)
    opt = optax.adam(1e-3)
    from pbrt_v3_iile_tpu.parallel import sharded
    step = sharded.make_train_step(net, opt, mesh)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    opt_state = opt.init(params)
    losses = []
    for epoch in range(6):
        for x, y in datasetlib.batches_from_raw(
                raw, 8, jax.random.fold_in(key, epoch)):
            params, stats, opt_state, loss = step(params, stats, opt_state,
                                                  x, y)
            losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses

    # checkpoint round trip (replaces iispt_model.tch)
    ckpt = str(tmp_path / "model.ckpt")
    trainlib.save_checkpoint(ckpt, dict(params=params, batch_stats=stats))
    blob = trainlib.load_checkpoint(ckpt)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: np.allclose(a, b), params, blob["params"]))


def test_evalstats_kruskal():
    """Eval statistics tool (ml/main_compute_test_statistics.py role):
    the three estimator groups get L1/SSIM distributions and Kruskal
    p-values; blurred-1spp must beat raw 1spp on L1 for noisy maps."""
    import jax
    import jax.numpy as jnp

    from pbrt_v3_iile_tpu.scene import api as apilib
    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.ml import dataset as datasetlib, evalstats
    from pbrt_v3_iile_tpu.models import iisptnet

    sd = apilib.load_scene_string("""
LookAt 0 1 -4  0 1 0  0 1 0
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Integrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "point" "color I" [10 10 10] "point from" [0 3 -1]
Material "matte" "color Kd" [0.6 0.5 0.4]
Shape "trianglemesh" "point P" [-5 0 -5 5 0 -5 5 0 5 -5 0 5]
  "integer indices" [0 1 2 2 3 0]
Shape "trianglemesh" "point P" [-5 0 3 5 0 3 5 5 3 -5 5 3]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
""")
    scene, cam = renderlib.build(sd)
    hemi = 8
    coords = jnp.asarray([[4, 16], [16, 16], [24, 20], [16, 26]],
                         jnp.int32)
    raw = datasetlib.generate_examples(scene, cam, 0, jax.random.PRNGKey(0),
                                       coords, hemi_size=hemi, gt_spp=8)
    net, net_vars = iisptnet.init_params(jax.random.PRNGKey(1), hemi)
    stats = evalstats.compare_predictions(raw, net, net_vars)
    txt = evalstats.report(stats)
    assert "p[l1:low_vs_pred]" in txt
    for k, p in stats["p_values"].items():
        assert 0.0 <= p <= 1.0
    assert set(stats["means"]["l1"]) == {"low", "blur", "pred"}


@pytest.mark.slow
def test_iile_quality_gate(tmp_path):
    """End-to-end quality gate (the charts_*.py parity claim, VERDICT r1
    item #10): train on generated probes, render IILE, and require the
    combined image to be measurably closer to the converged path
    reference than the direct-only component alone — i.e. the predicted
    indirect layer adds real signal, not just noise."""
    import jax
    import jax.numpy as jnp

    from pbrt_v3_iile_tpu.integrators import iispt as iisptlib
    from pbrt_v3_iile_tpu.ml import dataset as datasetlib
    from pbrt_v3_iile_tpu.ml import train as trainlib
    from pbrt_v3_iile_tpu.models import iisptnet
    from pbrt_v3_iile_tpu.utils import metrics as metricslib
    from pbrt_v3_iile_tpu.parallel import mesh as meshlib, sharded
    import optax

    scene_text = """
LookAt 0 2 -5  0 2 0  0 1 0
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [48] "integer yresolution" [48]
Integrator "path" "integer maxdepth" [5]
WorldBegin
AttributeBegin
  Material "matte" "color Kd" [0 0 0]
  AreaLightSource "area" "color L" [25 25 25]
  Translate 0 3.8 0
  Shape "sphere" "float radius" [0.3]
AttributeEnd
Material "matte" "color Kd" [0.85 0.85 0.85]
Shape "trianglemesh" "point P" [-3 0 -6 3 0 -6 3 0 2 -3 0 2] "integer indices" [0 1 2 2 3 0]
Shape "trianglemesh" "point P" [-3 4 -6 3 4 -6 3 4 2 -3 4 2] "integer indices" [0 2 1 2 0 3]
Shape "trianglemesh" "point P" [-3 0 2 3 0 2 3 4 2 -3 4 2] "integer indices" [0 1 2 2 3 0]
Material "matte" "color Kd" [0.7 0.2 0.2]
Shape "trianglemesh" "point P" [-3 0 -6 -3 0 2 -3 4 2 -3 4 -6] "integer indices" [0 1 2 2 3 0]
Material "matte" "color Kd" [0.2 0.7 0.2]
Shape "trianglemesh" "point P" [3 0 -6 3 0 2 3 4 2 3 4 -6] "integer indices" [0 2 1 2 0 3]
WorldEnd
"""
    hemi = 8
    sd = apilib.load_scene_string(scene_text)
    scene, cam = renderlib.build(sd)
    key = jax.random.PRNGKey(0)

    # converged path reference
    ref, _ = renderlib.render(sd, spp=48, seed=5)

    # train a small net on generated probes
    g = jnp.linspace(4, 43, 5).astype(jnp.int32)
    gx, gy = jnp.meshgrid(g, g)
    coords = jnp.stack([gx, gy], -1).reshape(-1, 2)
    maps = datasetlib.generate_examples(scene, cam, 0, key, coords,
                                        hemi_size=hemi, gt_spp=12)
    raw = [{k: np.asarray(maps[k][i]) for k in "pdnz"}
           for i in range(coords.shape[0]) if bool(maps["valid"][i])]
    net = iisptnet.IISPTNet(k=8)
    variables = net.init(jax.random.PRNGKey(2),
                         jnp.zeros((1, hemi, hemi, 7)), train=False)
    opt = optax.adam(2e-3)
    mesh = meshlib.make_mesh(1)
    step = sharded.make_train_step(net, opt, mesh)
    params, stats = variables["params"], variables.get("batch_stats", {})
    opt_state = opt.init(params)
    for epoch in range(8):
        for x, y in datasetlib.batches_from_raw(
                raw, 8, jax.random.fold_in(key, epoch)):
            params, stats, opt_state, loss = step(params, stats,
                                                  opt_state, x, y)

    # IILE render with the trained net (small net -> matching apply)
    sd.integrator.kind = "iispt"
    net_vars = {"params": params, "batch_stats": stats}
    import pbrt_v3_iile_tpu.models.iisptnet as netmod
    orig = netmod.IISPTNet
    try:
        netmod.IISPTNet = lambda: net  # render_iile instantiates IISPTNet()
        combined, direct, indirect, _ = iisptlib.render_iile(
            sd, net_vars=net_vars, indirect_tasks=2, direct_samples=8,
            hemi_size=hemi)
    finally:
        netmod.IISPTNet = orig

    # the CNN indirect layer must move the image TOWARD the reference.
    # L1 rather than PSNR: PSNR's max^2 term is dominated by the in-view
    # emitter, hiding the wall-GI differences this gate is about.
    l1_combined = metricslib.l1(combined, ref)
    l1_direct = metricslib.l1(direct, ref)
    assert np.isfinite(l1_combined)
    assert l1_combined < 0.85 * l1_direct, (l1_combined, l1_direct)
    assert metricslib.psnr(combined, ref) > 15.0
