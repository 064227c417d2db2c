"""Offline-tool CLI tests: imgtool, cyhair2pbrt, interactive viewer.

Covers the reference's src/tools/imgtool.cpp commands, cyhair2pbrt.cpp
conversion, and ml/main_interactive_view.py protocol."""

import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from pbrt_v3_iile_tpu.cli import imgtool, cyhair2pbrt
from pbrt_v3_iile_tpu.utils import image as imglib


def _write_img(path, img):
    imglib.write_pfm(path, img.astype(np.float32))


def test_imgtool_info_and_cat(tmp_path, capsys):
    p = str(tmp_path / "a.pfm")
    _write_img(p, np.full((4, 4, 3), 0.25))
    assert imgtool.main(["info", p]) == 0
    out = capsys.readouterr().out
    assert "resolution (4, 4)" in out and "avg 0.25" in out
    assert imgtool.main(["cat", "--sort", p]) == 0
    assert "(0, 0):" in capsys.readouterr().out


def test_imgtool_convert_flipy_scale_repeat(tmp_path):
    src = str(tmp_path / "a.pfm")
    dst = str(tmp_path / "b.pfm")
    img = np.zeros((2, 2, 3), np.float32)
    img[0, 0] = 1.0
    _write_img(src, img)
    assert imgtool.main(["convert", "--flipy", "--scale", "2.0",
                         "--repeatpix", "2", src, dst]) == 0
    out = imglib.read_pfm(dst)
    assert out.shape == (4, 4, 3)
    # flipy puts the hot pixel at the bottom; scale doubles it
    assert out[3, 0, 0] == pytest.approx(2.0)
    assert out[0, 0, 0] == pytest.approx(0.0)


def test_imgtool_convert_tonemap_despike(tmp_path):
    src = str(tmp_path / "a.pfm")
    dst = str(tmp_path / "b.pfm")
    img = np.full((5, 5, 3), 0.5, np.float32)
    img[2, 2] = 1000.0  # spike
    _write_img(src, img)
    assert imgtool.main(["convert", "--despike", "10", "--tonemap",
                         src, dst]) == 0
    out = imglib.read_pfm(dst)
    assert out.max() < 1.5  # spike removed, Reinhard bounded


def test_imgtool_diff_and_assemble(tmp_path, capsys):
    a = str(tmp_path / "a.pfm")
    b = str(tmp_path / "b.pfm")
    _write_img(a, np.full((3, 3, 3), 1.0))
    _write_img(b, np.full((3, 3, 3), 1.0))
    assert imgtool.main(["diff", a, b]) == 0
    _write_img(b, np.full((3, 3, 3), 2.0))
    assert imgtool.main(["diff", a, b]) == 1
    capsys.readouterr()

    out = str(tmp_path / "full.pfm")
    t0 = str(tmp_path / "t0.pfm")
    t1 = str(tmp_path / "t1.pfm")
    _write_img(t0, np.full((2, 2, 3), 1.0))
    _write_img(t1, np.full((2, 2, 3), 3.0))
    assert imgtool.main(["assemble", "--outfile", out,
                         f"{t0}:0,0", f"{t1}:2,0"]) == 0
    img = imglib.read_pfm(out)
    assert img.shape == (2, 4, 3)
    assert img[0, 0, 0] == 1.0 and img[0, 3, 0] == 3.0


def test_imgtool_makesky(tmp_path):
    out = str(tmp_path / "sky.exr")
    assert imgtool.main(["makesky", "--outfile", out, "--resolution", "16",
                         "--elevation", "30", "--turbidity", "3"]) == 0
    sky = imglib.read_exr(out)
    assert sky.shape == (16, 32, 3)
    assert np.isfinite(sky).all() and sky.max() > 0
    # sky brighter above the horizon than the albedo ground below it
    assert sky[:7].mean() != pytest.approx(sky[10:].mean())


def _write_cyhair(path, strands):
    """strands: list of (points (K,3), thickness (K,))"""
    num_strands = len(strands)
    total = sum(len(p) for p, _ in strands)
    flags = 0b00111  # segments+points+thickness
    header = b"HAIR" + struct.pack(
        "<IIIIfffff", num_strands, total, flags, 0, 0.1, 0.0, 1, 1, 1)
    header += b"\0" * (128 - len(header))
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.array([len(p) - 1 for p, _ in strands],
                         "<u2").tobytes())
        f.write(np.concatenate([p for p, _ in strands]).astype(
            "<f4").tobytes())
        f.write(np.concatenate([t for _, t in strands]).astype(
            "<f4").tobytes())


def test_cyhair2pbrt_roundtrip(tmp_path):
    hair = str(tmp_path / "test.hair")
    out = str(tmp_path / "hair.pbrt")
    pts = np.array([[0, 0, 0], [0, 1, 0], [0, 2, 0.5], [0, 3, 1.0]],
                   np.float32)
    _write_cyhair(hair, [(pts, np.full(4, 0.05, np.float32))])
    assert cyhair2pbrt.main([hair, out]) == 0
    text = open(out).read()
    assert text.count('Shape "curve"') == 3  # 4 points -> 3 bezier segments
    assert '"string type" "cylinder"' in text
    assert '"float width0" [0.05]' in text
    # and the emitted scene parses through our own parser
    from pbrt_v3_iile_tpu.scene import api as apilib
    sd = apilib.load_scene_string(
        'Camera "perspective"\nFilm "image" "integer xresolution" [8] '
        '"integer yresolution" [8]\nWorldBegin\n' + text + "\nWorldEnd\n")
    assert sd.n_triangles > 0


def test_interactive_viewer_protocol(tmp_path):
    # build a tiny fake PFM dataset (one 8x8 example)
    ds = tmp_path / "set"
    ds.mkdir()
    rng = np.random.default_rng(0)
    for k, c in (("p", 3), ("d", 3), ("n", 3), ("z", 1)):
        img = rng.uniform(0.1, 1.0, (8, 8, c)).astype(np.float32)
        if c == 1:
            img = img[..., 0]  # 1-channel PFMs are grayscale "Pf" rasters
        imglib.write_pfm(str(ds / f"{k}_0_0.pfm"), img)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pbrt_v3_iile_tpu.ml.interactive",
         "--dataset", str(ds), "--outdir", str(tmp_path)],
        input="0\n", capture_output=True, text=True, timeout=300,
        env=env, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert "#LOADCOMPLETE 1" in proc.stdout
    for tok in ("#LOWL1", "#GAUSSL1", "#RESL1", "#RESSS",
                "#EVALUATECOMPLETE"):
        assert tok in proc.stdout, proc.stdout
    for name in ("interactiveExpected.png", "interactiveResult.png",
                 "interactiveLow.png", "interactiveBlurred.png"):
        assert (tmp_path / name).exists()


def test_bsdftest_tool():
    """bsdftest harness (src/tools/bsdftest.cpp role): every model's
    three reflectance estimators must agree."""
    from pbrt_v3_iile_tpu.cli import tools

    rc = tools.main(["bsdftest", "--n", "8192",
                     "--models", "matte,plastic,metal,disney"])
    assert rc == 0


def test_histogram_and_flipnz_tools(tmp_path):
    import numpy as np
    from pbrt_v3_iile_tpu.cli import tools
    from pbrt_v3_iile_tpu.utils import image as imglib

    img = np.random.default_rng(1).uniform(0, 2, (8, 8, 3)).astype(np.float32)
    p = str(tmp_path / "t.pfm")
    imglib.write_pfm(p, img)
    assert tools.main(["histogram", p, "--buckets", "4"]) == 0
    assert tools.main(["flipnz", p]) == 0
    out = imglib.read_pfm(p)
    np.testing.assert_allclose(out[..., 2], -img[..., 2], rtol=1e-6)
    np.testing.assert_allclose(out[..., 0], img[..., 0], rtol=1e-6)
