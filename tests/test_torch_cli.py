"""The port's CLI (``python -m insarseg_torch.cli``, in process, ``--device
cpu``) on the cases of the JAX package's ``tests/test_cli.py``, at 32^2
tiles and 48^2 scenes (``predict --stream``: a 96x130 ``.npy`` scene),
plus the ResNet families' training, and across the two packages.
The port-only cases build their U-Nets at base 16 (level 1 16 for the
fast cell) through the model registry; the cases that cross to the JAX
package keep the published widths (``wide``), which the JAX CLI builds:

- a JAX ``export-torch`` file (of the port's export, read by the JAX
  package: a JAX fresh init takes 20 s here) served by the port's
  ``predict --torch-checkpoint --engine serve`` writes the PNG the JAX
  package's ``predict`` writes from that file, equal;
- a JAX int8 artifact (``--save-engine``) served by the port's
  ``predict --engine-artifact`` agrees with the JAX package's PNG from the
  same artifact on >= 0.995 of pixels (the bar of
  ``tests/test_torch_engines.py``);
- the port's ``export-torch`` scored by the JAX package's ``eval
  --torch-checkpoint`` gives the port's metrics within 1e-5;
- several ``--input`` scenes (two shapes) through the batched stitch write
  the PNGs of single-scene runs, equal;
- ``predict --stream`` of a uint8 ``.npy`` scene writes the PNG of the
  in-memory ``predict`` of that scene, and the JAX package's ``predict
  --stream`` on the same weights writes it too; its two errors are the
  JAX CLI's.
"""

import ast
import functools
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from insarseg.cli import main as jax_main
from insarseg_torch.cli import main as port_main
from insarseg_torch.data.synthetic import make_synthetic_voc


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def _save_png(path, arr):
    from PIL import Image

    Image.fromarray(arr, "L").save(path)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    make_synthetic_voc(str(d / "voc"), n_train=6, n_val=3, size=32)
    rng = np.random.default_rng(0)
    _save_png(str(d / "scene.png"),
              (rng.random((48, 48)) * 255).astype(np.uint8))
    return d


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: the cases' ops are small, and the test run
    shares the host's cores between its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cwd(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    return workdir


BASE = ["--preset", "unet", "--image-size", "32", "--batch-size", "4"]
NARROW = 16


def _narrow(mp):
    """U-Nets at base ``NARROW`` (the fast cell's level 1 too) from the
    registry the CLI builds through."""
    from insarseg_torch.models import registry, unet_stem

    mp.setattr(registry, "UNet",
               functools.partial(registry.UNet, base_features=NARROW))
    mp.setattr(unet_stem, "UNetFastS2D",
               functools.partial(unet_stem.UNetFastS2D,
                                 level1_features=NARROW))


@pytest.fixture
def wide():
    """A case that keeps the published widths (it crosses to the JAX
    package, whose CLI builds them)."""


@pytest.fixture(autouse=True)
def narrow(request, monkeypatch):
    if "wide" not in request.fixturenames:
        _narrow(monkeypatch)


def port(*argv):
    """The port's CLI on the CPU; its exit code."""
    return port_main([*argv, "--device", "cpu"])


def _metrics(fn, argv):
    """The metrics dict an eval prints on its last line."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert fn(argv) == 0
    return ast.literal_eval(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def trained(workdir):
    """One epoch of the unet preset, on the native loader: the checkpoint
    directory the other cases read."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        _narrow(mp)
        assert port("train", *BASE, "--voc-root", "voc", "--num-epochs", "1",
                    "--native", "--model-save-path", "ckpt/m",
                    "--metrics-save-path", "hist.json") == 0
    return "ckpt/m"


def test_cli_train_eval_export_roundtrip(cwd, trained):
    assert os.path.exists("hist.json")
    assert {"best.pt", "latest.pt"} <= set(os.listdir(trained))
    hist = json.load(open("hist.json"))
    assert [h["epoch"] for h in hist] == [1]
    assert {"train_loss", "train_miou", "val_loss", "val_miou"} <= set(hist[0])
    from_ckpt = _metrics(port_main, ["eval", *BASE, "--voc-root", "voc",
                                     "--checkpoint", trained, "--split",
                                     "val", "--device", "cpu"])
    assert port("export-torch", *BASE, "--checkpoint", trained, "--output",
                "exported.pth") == 0
    from_pth = _metrics(port_main, ["eval", *BASE, "--voc-root", "voc",
                                    "--torch-checkpoint", "exported.pth",
                                    "--split", "val", "--device", "cpu"])
    assert from_ckpt == from_pth


@pytest.fixture(scope="module")
def exported(workdir):
    """The port's export-torch of a fresh init (``--seed 5``), at the
    published width."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        assert port("export-torch", *BASE, "--seed", "5", "--output",
                    "port.pth") == 0
    return "port.pth"


def test_cli_export_matches_jax_eval(cwd, wide, exported):
    """The port's export scored by the JAX package's eval: the port's
    metrics within 1e-5."""
    args = ["eval", *BASE, "--voc-root", "voc", "--torch-checkpoint",
            exported, "--split", "val"]
    ours = _metrics(port_main, [*args, "--device", "cpu"])
    theirs = _metrics(jax_main, args)
    assert set(ours) == set(theirs)
    for k in ours:
        assert abs(ours[k] - float(theirs[k])) <= 1e-5, (k, ours, theirs)


@pytest.mark.parametrize("engine", ["serve", "int8"])
def test_cli_eval_engines(cwd, engine, capsys):
    assert port("eval", *BASE, "--voc-root", "voc", "--split", "val",
                "--engine", engine) == 0
    assert "val_miou" in capsys.readouterr().out


def test_cli_eval_int8_calib_split_train(cwd, capsys):
    for split in ("train", "val"):
        assert port("eval", *BASE, "--voc-root", "voc", "--split", "val",
                    "--engine", "int8", "--calib-split", split,
                    "--calib-batches", "1") == 0
        assert "val_miou" in capsys.readouterr().out


def test_cli_predict(cwd):
    assert port("predict", *BASE, "--input", "scene.png", "--tile", "32",
                "--overlap", "8", "--output", "pred.png") == 0
    assert _png("pred.png").shape == (48, 48)


def test_cli_predict_multi_scene(cwd):
    """Two 48^2 scenes through the batched stitch and a 40x56 scene in its
    own group write the PNGs of single-scene runs, equal."""
    rng = np.random.default_rng(7)
    _save_png("scene_b.png", (rng.random((48, 48)) * 255).astype(np.uint8))
    _save_png("scene_c.png", (rng.random((40, 56)) * 255).astype(np.uint8))
    names = ("scene", "scene_b", "scene_c")
    for extra in ([], ["--engine", "int8"]):
        assert port("predict", *BASE, "--input", *(p + ".png" for p in names),
                    "--tile", "32", "--overlap", "8", "--output", "multi",
                    *extra) == 0
        multi = {p: _png(os.path.join("multi", p + "_pred.png"))
                 for p in names}
        assert multi["scene"].shape == (48, 48)
        assert multi["scene_c"].shape == (40, 56)
        for p in names:
            assert port("predict", *BASE, "--input", p + ".png", "--tile",
                        "32", "--overlap", "8", "--output", p + "_one.png",
                        *extra) == 0
            np.testing.assert_array_equal(_png(p + "_one.png"), multi[p])


def test_cli_predict_basename_collision_uniquified(cwd):
    rng = np.random.default_rng(11)
    os.makedirs("dir_a", exist_ok=True)
    os.makedirs("dir_b", exist_ok=True)
    _save_png("dir_a/dup.png", (rng.random((48, 48)) * 255).astype(np.uint8))
    _save_png("dir_b/dup.png", (rng.random((48, 48)) * 255).astype(np.uint8))
    assert port("predict", *BASE, "--input", "dir_a/dup.png",
                "dir_b/dup.png", "--tile", "32", "--overlap", "8",
                "--output", "dup_out") == 0
    assert _png("dup_out/dup_pred.png").shape == (48, 48)
    assert _png("dup_out/dup_pred_2.png").shape == (48, 48)


@pytest.mark.parametrize("preset,engine", [
    ("unet-channelattention", "serve"), ("unet-channelattention", "int8"),
    ("unet-spatialattention", "serve"), ("unet-spatialattention", "int8"),
    ("deeplabv3", "serve"), ("unet-fast-ca", "int8"), ("unet-fast-ca",
                                                       "module"),
    ("pspnet-true", "int8"),
])
def test_cli_predict_engines(cwd, preset, engine):
    out = f"pred_{preset}_{engine}.png"
    assert port("predict", "--preset", preset, "--image-size", "32",
                "--input", "scene.png", "--tile", "32", "--overlap", "8",
                "--engine", engine, "--output", out) == 0
    pred = _png(out)
    assert pred.shape == (48, 48) and set(np.unique(pred)) <= {0, 255}


def test_cli_train_missing_dataset(cwd, capsys):
    assert port("train", *BASE, "--voc-root", "/nonexistent") == 2
    assert "dataset not found" in capsys.readouterr().err


def test_cli_export_torch_deeplab_roundtrip(cwd):
    """A fresh deeplabv3 init exported and imported again scores the same
    eval, to the digit."""
    args = ["--preset", "deeplabv3", "--image-size", "32", "--batch-size",
            "4", "--seed", "7"]
    assert port("export-torch", *args, "--output", "dl.pth") == 0
    ev = ["eval", *args, "--voc-root", "voc", "--split", "val", "--device",
          "cpu"]
    assert _metrics(port_main, ev) == _metrics(
        port_main, [*ev, "--torch-checkpoint", "dl.pth"])


def test_cli_export_torch_pspnet_rejected(cwd, capsys):
    assert port("export-torch", "--model", "pspnet", "--image-size", "32",
                "--output", "x.pth") == 2
    assert "no reference naming" in capsys.readouterr().err
    assert not os.path.exists("x.pth")


def test_cli_train_resume(cwd):
    """1 epoch, then --resume to 3: the merged history holds 1, 2, 3; a
    resume of the finished run keeps it."""
    common = [*BASE, "--voc-root", "voc", "--model-save-path", "rck/m",
              "--metrics-save-path", "rhist.json"]
    assert port("train", *common, "--num-epochs", "1") == 0
    assert port("train", *common, "--num-epochs", "3", "--resume") == 0
    hist = json.load(open("rhist.json"))
    assert [h["epoch"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    assert port("train", *common, "--num-epochs", "3", "--resume") == 0
    assert [h["epoch"] for h in json.load(open("rhist.json"))] == [1, 2, 3]
    ck = torch.load("rck/m/latest.pt", weights_only=True)
    assert ck["step"] == 3 * 2  # 6 samples in batches of 4, 3 epochs


def test_cli_train_raw_u8_debug_nans(cwd):
    assert port("train", *BASE, "--voc-root", "voc", "--num-epochs", "1",
                "--raw-u8", "--debug-nans", "--model-save-path", "u8ck/m",
                "--metrics-save-path", "u8hist.json") == 0
    assert os.path.exists("u8hist.json")
    assert not torch.is_anomaly_enabled()  # restored after the run


@pytest.mark.parametrize("preset,batch", [("pspnet-channelattention", 2),
                                          ("pspnet-true", 1)])
def test_cli_train_resnet_families(cwd, preset, batch):
    """The reference's FCN-CA and the true PSPNet (at batch 1: one value per
    channel in its 1x1 bin) train from the VOC tree; eval --engine int8
    scores the checkpoint. (DeepLabV3's step is held to JAX's in
    ``tests/test_torch_train_resnet.py``.)"""
    args = ["--preset", preset, "--image-size", "32", "--batch-size",
            str(batch)]
    stem = f"r_{preset}"
    assert port("train", *args, "--voc-root", "voc", "--num-epochs", "1",
                "--model-save-path", f"{stem}/m", "--metrics-save-path",
                f"{stem}.json") == 0
    hist = json.load(open(f"{stem}.json"))
    assert np.isfinite(hist[0]["train_loss"])
    assert np.isfinite(hist[0]["val_loss"])
    res = _metrics(port_main, ["eval", *args, "--voc-root", "voc",
                               "--checkpoint", f"{stem}/m", "--engine",
                               "int8", "--calib-batches", "1", "--device",
                               "cpu"])
    assert np.isfinite(res["val_loss"])


def test_cli_engine_artifact_roundtrip_and_mismatch(cwd, capsys):
    assert port("eval", *BASE, "--voc-root", "voc", "--split", "val",
                "--engine", "int8", "--calib-batches", "1",
                "--save-engine", "unet_i8") == 0
    assert os.path.exists("unet_i8.npz")
    capsys.readouterr()
    assert port("predict", *BASE, "--engine-artifact", "unet_i8.npz",
                "--input", "scene.png", "--tile", "32", "--overlap", "8",
                "--output", "pred_art.png") == 0
    assert port("eval", *BASE, "--voc-root", "voc", "--split", "val",
                "--engine-artifact", "unet_i8.npz") == 0
    assert "val_miou" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="does not match"):
        port("eval", "--preset", "deeplabv3", "--image-size", "32",
             "--batch-size", "4", "--voc-root", "voc",
             "--engine-artifact", "unet_i8.npz")
    with pytest.raises(SystemExit, match="conflicts"):
        port("eval", *BASE, "--voc-root", "voc", "--engine", "serve",
             "--engine-artifact", "unet_i8.npz")
    with pytest.raises(SystemExit, match="needs a packed engine"):
        port("eval", *BASE, "--voc-root", "voc", "--save-engine", "m.npz")
    assert port("eval", *BASE, "--voc-root", "voc", "--split", "val",
                "--engine-artifact", "unet_i8.npz",
                "--calib-batches", "8") == 0
    assert "ignored" in capsys.readouterr().err


@pytest.mark.parametrize("flags,item", [
    (["train", "--preset", "deeplabv3", "--image-size", "32", "--voc-root",
      "voc", "--mesh-spatial", "2"], "item 21b"),
])
def test_cli_unported_flags_raise(cwd, flags, item):
    """Flags that raised naming their ROADMAP ``item`` until it was ported
    now run as the JAX CLI's do: ``train --preset deeplabv3
    --mesh-spatial 2`` (item 21b: the ResNet families shard H) trains
    DeepLabV3-ResNet50 on two gloo ranks and writes a finite history
    (``tests/test_torch_spatial_resnet*.py`` hold the sharded step)."""
    hist = f"h_{item.replace(' ', '_')}.json"
    assert port(*flags, "--batch-size", "4", "--num-epochs", "1",
                "--model-save-path", f"m_{item.replace(' ', '_')}/b.ckpt",
                "--metrics-save-path", hist) == 0
    with open(hist) as f:
        h = json.load(f)
    assert [e["epoch"] for e in h] == [1]
    assert np.isfinite([h[0]["train_loss"], h[0]["val_loss"]]).all()


def test_cli_predict_mesh_spatial_runs_as_jax(cwd):
    """``predict --mesh-spatial 2`` runs as the JAX CLI's does, which
    serves over a data mesh and ignores the spatial axis: the PNG of a run
    without the flag."""
    flags = ["predict", *BASE, "--input", "scene.png", "--tile", "32",
             "--overlap", "8"]
    assert port(*flags, "--output", "a.png") == 0
    assert port(*flags, "--mesh-spatial", "2", "--output", "b.png") == 0
    np.testing.assert_array_equal(_png("a.png"), _png("b.png"))


BF16 = ["--compute-dtype", "bfloat16"]


@pytest.mark.parametrize("flags", [BF16, ["--remat", "true"],
                                   [*BF16, "--remat", "true"]],
                         ids=["bf16", "remat", "bf16-remat"])
def test_cli_train_bf16_and_remat(cwd, flags):
    """``train`` in bf16, with remat, and with both: a finite history and
    f32 weights in the checkpoint, which ``eval`` scores in the same
    compute dtype."""
    stem = "t_" + "_".join(f.strip("-") for f in flags)
    assert port("train", *BASE, *flags, "--voc-root", "voc", "--num-epochs",
                "1", "--model-save-path", f"{stem}/m", "--metrics-save-path",
                f"{stem}.json") == 0
    hist = json.load(open(f"{stem}.json"))
    assert np.isfinite(hist[0]["train_loss"])
    assert np.isfinite(hist[0]["val_loss"])
    best = torch.load(f"{stem}/m/best.pt", weights_only=True)
    assert all(t.dtype in (torch.float32, torch.int64) for t in best.values())
    adam = torch.load(f"{stem}/m/latest.pt", weights_only=True)["optimizer"]
    assert all(st[k].dtype == torch.float32 for st in adam["state"].values()
               for k in ("exp_avg", "exp_avg_sq"))
    res = _metrics(port_main, ["eval", *BASE, *flags, "--voc-root", "voc",
                               "--checkpoint", f"{stem}/m", "--device",
                               "cpu"])
    assert np.isfinite(res["val_loss"])


def test_cli_eval_and_predict_bf16(cwd):
    """The module engine of ``eval`` and ``predict`` (and ``predict
    --stream``) computes in bf16: its loss within 2e-2 of the f32 eval's
    (relative), its class map on >= 0.99 of the f32 one's pixels, the
    stream's PNG the in-memory bf16 one; the serve and int8 engines pack
    the f32 weights whatever the compute dtype, as the JAX package's do,
    and score the same."""
    ev = ["eval", *BASE, "--voc-root", "voc", "--split", "val", "--device",
          "cpu"]
    f32, b16 = _metrics(port_main, ev), _metrics(port_main, [*ev, *BF16])
    assert b16["val_loss"] != f32["val_loss"]
    assert abs(b16["val_loss"] - f32["val_loss"]) <= 2e-2 * f32["val_loss"]
    for engine in ("serve", "int8"):
        args = [*ev, "--engine", engine, "--calib-batches", "1"]
        assert _metrics(port_main, [*args, *BF16]) == _metrics(port_main,
                                                               args)
    pred = ["predict", *BASE, "--tile", "32", "--overlap", "8"]
    assert port(*pred, "--input", "scene.png", "--output", "p32.png") == 0
    assert port(*pred, *BF16, "--input", "scene.png", "--output",
                "p16.png") == 0
    assert np.mean(_png("p16.png") == _png("p32.png")) >= 0.99
    np.save("bf16_scene.npy", _png("scene.png"))
    assert port(*pred, *BF16, "--input", "bf16_scene.npy", "--stream",
                "--output", "p16_stream.png") == 0
    np.testing.assert_array_equal(_png("p16_stream.png"), _png("p16.png"))


def test_cli_grafts_an_rgb_stem(cwd):
    """A ResNet file with an RGB stem (a pretrained torchvision
    ``backbone.conv1``, here FCN-CA's state_dict with a 3-channel conv1
    drawn from a numpy seed) loads through ``--torch-checkpoint`` with the
    stem averaged to one channel, as the JAX package's import grafts it:
    the two packages' logits within 1e-4 x max|logit|, and ``eval`` of the
    file exits 0. A U-Net file is never grafted: its 3-channel ``inc``
    conv does not load."""
    import argparse

    import jax
    import jax.numpy as jnp

    from insarseg.compat.torch_io import segmentation_variables_from_torch
    from insarseg.models.registry import build as jax_build
    from insarseg_torch.cli import _load_weights
    from insarseg_torch.config import get_preset
    from insarseg_torch.models.registry import build
    from insarseg_torch.models.unet import UNet
    from tests.test_torch_common import resnet_numpy_state_dict, smooth

    model = build("fcn", "channel")
    sd = resnet_numpy_state_dict(
        {k: tuple(v.shape) for k, v in model.state_dict().items()}, seed=2)
    rng = np.random.default_rng(3)
    sd["backbone.conv1.weight"] = rng.normal(
        0, (1 / (3 * 49)) ** 0.5, (64, 3, 7, 7)).astype(np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, "rgb.pth")
    _load_weights(argparse.Namespace(torch_checkpoint="rgb.pth"),
                  get_preset("pspnet-channelattention"), model)
    x = smooth(rng, (2, 32, 32, 1))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    v = segmentation_variables_from_torch(sd, "fcn", "channel")
    jm = jax_build("fcn", "channel")
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= 1e-4, rel
    assert port("eval", "--preset", "pspnet-channelattention",
                "--image-size", "32", "--batch-size", "2", "--voc-root",
                "voc", "--torch-checkpoint", "rgb.pth") == 0
    unet = UNet(base_features=NARROW, in_channels=3).state_dict()
    torch.save(unet, "rgb_unet.pth")
    with pytest.raises(RuntimeError, match="inc.double_conv.0.weight"):
        port("eval", *BASE, "--voc-root", "voc", "--torch-checkpoint",
             "rgb_unet.pth")


@pytest.fixture(scope="module")
def stream_scene(workdir):
    """A 96x130 uint8 scene as ``stream.npy`` and as ``stream.png``."""
    u8 = (np.random.default_rng(13).random((96, 130)) * 255).astype(np.uint8)
    np.save(workdir / "stream.npy", u8)
    _save_png(str(workdir / "stream.png"), u8)
    return u8


STREAM = ["--tile", "32", "--overlap", "8"]


@pytest.mark.parametrize("engine", ["module", "int8"])
def test_cli_predict_stream_matches_in_memory(cwd, stream_scene, engine):
    """``predict --stream`` of the ``.npy`` scene (memory-mapped, streamed
    band by band, normalized and argmaxed on the device) writes the PNG of
    the in-memory ``predict`` of the same scene as a PNG; int8 calibrates
    on the same tiles of it."""
    args = [*BASE, *STREAM, "--engine", engine]
    assert port("predict", *args, "--input", "stream.npy", "--stream",
                "--output", f"st_{engine}.png") == 0
    assert port("predict", *args, "--input", "stream.png", "--output",
                f"mem_{engine}.png") == 0
    got = _png(f"st_{engine}.png")
    assert got.shape == (96, 130) and set(np.unique(got)) <= {0, 255}
    np.testing.assert_array_equal(got, _png(f"mem_{engine}.png"))


def test_cli_predict_stream_matches_jax(cwd, wide, exported, stream_scene):
    """The JAX package's ``predict --stream`` and the port's, on the same
    exported weights and ``.npy`` scene, write the same PNG."""
    pred = ["predict", *BASE, *STREAM, "--tile-batch", "8",
            "--torch-checkpoint", exported, "--engine", "serve", "--input",
            "stream.npy", "--stream"]
    assert jax_main([*pred, "--output", "jax_stream.png"]) == 0
    assert port(*pred, "--output", "port_stream.png") == 0
    np.testing.assert_array_equal(_png("port_stream.png"),
                                  _png("jax_stream.png"))


@pytest.mark.parametrize("scene,shape,dtype", [
    ("bad_dtype.npy", (64, 64, 2), np.float32),
    ("small.npy", (24, 64), np.uint8),
])
def test_cli_predict_stream_errors_match_jax(cwd, scene, shape, dtype):
    """A ``--stream`` scene that is not 2D uint8 / f32, or smaller than the
    tile, ends both CLIs with one message."""
    np.save(scene, np.zeros(shape, dtype))
    argv = ["predict", *BASE, *STREAM, "--input", scene, "--stream"]
    with pytest.raises(SystemExit) as jax_err:
        jax_main(argv)
    with pytest.raises(SystemExit) as port_err:
        port(*argv)
    assert str(port_err.value) == str(jax_err.value)
    assert "--stream" in str(port_err.value)


def test_cli_serves_jax_export_equal(cwd, wide, exported):
    """JAX export-torch (of the port's export, read by the JAX package) ->
    the port's predict --torch-checkpoint --engine serve writes the JAX
    package's PNG from the same file."""
    assert jax_main(["export-torch", *BASE, "--torch-checkpoint", exported,
                     "--output", "jax.pth"]) == 0
    pred = ["predict", *BASE, "--torch-checkpoint", "jax.pth", "--input",
            "scene.png", "--tile", "32", "--overlap", "8", "--engine",
            "serve"]
    assert jax_main([*pred, "--output", "jax_serve.png"]) == 0
    assert port(*pred, "--output", "port_serve.png") == 0
    np.testing.assert_array_equal(_png("port_serve.png"),
                                  _png("jax_serve.png"))


def test_cli_serves_jax_int8_artifact(cwd, wide, exported):
    """A JAX int8 artifact (``predict --save-engine``: calibrated on the
    scene, saved, and served from the saved artifact, one JAX compile
    where ``eval --save-engine`` and a second predict take two) served by
    the port's predict --engine-artifact: argmax agreement with the JAX
    package's PNG >= 0.995."""
    args = [*BASE, "--input", "scene.png", "--tile", "32", "--overlap", "8"]
    assert jax_main(["predict", *args, "--torch-checkpoint", exported,
                     "--engine", "int8", "--save-engine", "jax_i8",
                     "--output", "jax_i8.png"]) == 0
    assert port("predict", *args, "--engine-artifact", "jax_i8.npz",
                "--output", "port_i8.png") == 0
    agree = float((_png("port_i8.png") == _png("jax_i8.png")).mean())
    assert agree >= 0.995, agree


@pytest.mark.parametrize("hw,calib_batches", [((200, 260), 1), ((200, 260), 3),
                                              ((200, 260), 9), ((64, 64), 4)])
def test_scene_calib_picks_the_jax_tiles(hw, calib_batches):
    """predict's int8 calibration takes the JAX package's tiles of the first
    scene, in its groups of 4 and its order (``insarseg/cli.py``'s
    ``_stream_calib`` shares ``_scene_calib``'s pick), so the int8 scales
    are the JAX CLI's; ``predict --stream``'s ``stream_calib`` reads the
    same tiles from a uint8 or pre-normalized f32 scene."""
    import types

    from insarseg.cli import _stream_calib
    from insarseg_torch.cli import normalize_scene, scene_calib, stream_calib
    from insarseg_torch.config import Config

    u8 = np.random.default_rng(3).integers(0, 256, hw, dtype=np.uint8)
    cfg = Config(normalize_mean=0.3, normalize_std=0.2)
    args = types.SimpleNamespace(tile=64, overlap=8,
                                 calib_batches=calib_batches)
    want = _stream_calib(u8, args, (0.3, 0.2))
    f32 = normalize_scene(u8, cfg)[..., 0]
    for got in (scene_calib(normalize_scene(u8, cfg), 64, 8, calib_batches),
                stream_calib(u8, 64, 8, calib_batches, cfg),
                stream_calib(f32, 64, 8, calib_batches, cfg)):
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    for g, w in zip(stream_calib(f32, 64, 8, calib_batches, cfg),
                    _stream_calib(f32, args, (0.3, 0.2))):
        np.testing.assert_array_equal(g, w)


def test_supported_matches_the_jax_package():
    """``engines.supported`` takes the cells the JAX package's takes: every
    known model (either spelling) on every engine, nothing else."""
    from insarseg.engines import supported as jax_supported
    from insarseg_torch.engines import supported

    models = ("unet", "unet-fast", "unet_fast", "deeplabv3", "fcn",
              "pspnet", "segformer")
    for m in models:
        for a in ("none", "channel", "spatial"):
            for e in ("module", "serve", "int8", "tensorrt"):
                assert supported(m, a, e) == jax_supported(m, a, e), (m, a, e)
    assert not supported("unet", "both", "int8")
