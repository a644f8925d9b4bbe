"""Port engine factory and artifacts (insarseg_torch/engines.py,
engines_io.py) against the JAX package: the port serves artifacts the JAX
package saved (serve, and int8 in the H-s2d default and the standard
layout) and writes artifacts the JAX package serves (U-Net-SA:
tests/test_torch_unet_sa.py; the fast cell: tests/test_torch_unet_stem.py).
The H-s2d int8 artifact is held to the JAX package's op-by-op
``unet_int8_apply`` (2e-2 x max|logit|, argmax >= 99.5%) and to its jitted
engine, which rounds the fused bf16 ops elsewhere, at a bar pinned above
the value measured (max rel err 0.0115, argmax agreement 1.0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.engines import engine_from_artifact as jax_from_artifact
from insarseg.engines import make_engine as jax_make_engine
from insarseg.engines import pack_engine as jax_pack_engine
from insarseg.engines_io import load_artifact as jax_load
from insarseg.engines_io import save_artifact as jax_save
from insarseg.models.unet_int8 import pack_unet_int8 as jax_pack_int8
from insarseg.models.unet_int8 import unet_int8_apply as jax_int8_apply
from insarseg_torch.engines import (
    collect_calib_batches,
    engine_from_artifact,
    make_engine,
    pack_engine,
)
from insarseg_torch.engines_io import load_artifact, save_artifact
from tests.test_torch_common import CPU, make_pair, smooth


@pytest.fixture(scope="module")
def pair():
    jm, v, tm = make_pair(use_se=True, hw=32)
    rng = np.random.default_rng(30)
    x = smooth(rng, (2, 32, 32, 1))
    return jm, v, tm, x


def test_serves_jax_serve_artifact(tmp_path, pair):
    jm, v, _, x = pair
    art = jax_pack_engine("unet", "channel", jm, v, "serve")
    path = jax_save(str(tmp_path / "serve"), art)
    want = np.asarray(jax_make_engine("unet", "channel", jm, v, "serve")(
        jnp.asarray(x)))
    got = engine_from_artifact(load_artifact(path), device=CPU)(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_serves_jax_int8_standard_layout_artifact(tmp_path, pair):
    jm, v, _, x = pair
    tree = jax_pack_int8(v, [jnp.asarray(x)], s2d=False)
    art = {"format": 1, "model": "unet", "attention": "channel",
           "engine": "int8", "meta": {"num_classes": 2}, "tree": tree}
    path = jax_save(str(tmp_path / "int8"), art)
    want = np.asarray(jax_from_artifact(jax_load(path))(jnp.asarray(x)))
    got = engine_from_artifact(load_artifact(path), device=CPU)(x)
    got, want = got.float().numpy(), want.astype(np.float32)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.995


@pytest.mark.parametrize("argmax", [False, True])
def test_serves_jax_default_s2d_int8_artifact(tmp_path, pair, argmax):
    jm, v, _, x = pair
    art = jax_pack_engine("unet", "channel", jm, v, "int8",
                          calib_batches=[x])
    assert art["tree"]["s2d"] is True
    path = jax_save(str(tmp_path / "s2d"), art)
    jitted = np.asarray(jax_from_artifact(jax_load(path), argmax=argmax)(
        jnp.asarray(x)))
    got = engine_from_artifact(load_artifact(path), argmax=argmax,
                               device=CPU)(x)
    if argmax:
        assert got.dtype == torch.int32
        assert np.mean(got.numpy() == jitted) >= 0.995
        return
    want = np.asarray(jax_int8_apply(jax_load(path)["tree"], jnp.asarray(x)),
                      np.float32)
    got, jitted = got.float().numpy(), jitted.astype(np.float32)
    for what, ref, bar in (("op by op", want, 2e-2),
                           ("jitted", jitted, 1.5e-2)):
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        agree = np.mean(got.argmax(-1) == ref.argmax(-1))
        print(f"U-Net-CA H-s2d int8, port vs JAX {what}: max rel err "
              f"{rel:.4g}, argmax {agree:.5f}")
        assert rel <= bar and agree >= 0.995, (what, rel, agree)


def test_port_int8_engine_packs_s2d_like_jax(pair):
    _, _, tm, x = pair
    art = pack_engine("unet", "channel", tm, None, "int8",
                      calib_batches=[x], device=CPU)
    assert art["tree"]["s2d"] is True
    assert tuple(art["tree"]["up4"]["k"].shape) == (1, 2, 32, 32)


@pytest.mark.parametrize("engine", ["serve", "int8"])
def test_port_artifact_serves_in_jax(tmp_path, pair, engine):
    _, _, tm, x = pair
    calib = [x] if engine == "int8" else None
    art = pack_engine("unet", "channel", tm, None, engine,
                      calib_batches=calib, device=CPU)
    path = save_artifact(str(tmp_path / engine), art)
    ours = make_engine("unet", "channel", tm, None, engine,
                       calib_batches=calib, device=CPU)(x).float().numpy()
    back = engine_from_artifact(load_artifact(path), device=CPU)(x)
    np.testing.assert_array_equal(back.float().numpy(), ours)
    theirs = np.asarray(jax_from_artifact(jax_load(path))(jnp.asarray(x)))
    np.testing.assert_allclose(theirs.astype(np.float32), ours, rtol=0,
                               atol=1e-4 if engine == "serve" else 2e-2)


def test_engines_agree_on_cpu(pair):
    _, _, tm, x = pair
    module = make_engine("unet", "channel", tm, None, "module",
                         device=CPU)(x).numpy()
    serve = make_engine("unet", "channel", tm, None, "serve",
                        device=CPU)(x).numpy()
    np.testing.assert_allclose(serve, module, rtol=0, atol=1e-4)
    int8 = make_engine("unet", "channel", tm, None, "int8",
                       calib_batches=[x], device=CPU, argmax=True)(x)
    assert int8.dtype == torch.int32 and int8.shape == (2, 32, 32)


def test_bf16_artifact_leaves_round_trip(tmp_path):
    tree = {"w": torch.linspace(-3, 3, 64).to(torch.bfloat16),
            "codes": torch.arange(-128, 128, dtype=torch.int8),
            "s": 1.5e-3, "none": None, "shape": (2, 3)}
    art = {"format": 1, "model": "unet", "attention": "none",
           "engine": "serve", "meta": {}, "tree": tree}
    path = save_artifact(str(tmp_path / "t"), art)
    back = load_artifact(path)["tree"]
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["codes"], tree["codes"])
    assert back["s"] == 1.5e-3 and back["none"] is None
    assert back["shape"] == (2, 3)
    jax_back = jax_load(path)["tree"]
    np.testing.assert_array_equal(
        np.asarray(jax_back["w"]).view(np.uint16),
        tree["w"].view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("model,attention,kw,err", [
    ("unet-fast", "channel", {"mesh": object()}, TypeError),
    ("deeplabv3", "none", {"mesh": object()}, TypeError),
    ("unet", "channel", {"mesh": object()}, TypeError),
    ("unet", "channel", {"engine": "int8"}, ValueError),
    ("unet", "channel", {"engine": "fp4"}, ValueError),
    ("pspnet", "cbam", {}, ValueError),
    ("psp", "none", {}, ValueError),
])
def test_make_engine_refuses(pair, model, attention, kw, err):
    _, _, tm, _ = pair
    kw = {"engine": "serve", **kw}
    with pytest.raises(err):
        make_engine(model, attention, tm, None, device=CPU, **kw)


@pytest.mark.parametrize("attention", ["none", "channel", "spatial"])
def test_pspnet_cells_build(attention):
    """Every true-PSPNet cell builds its module and serve engines."""
    from insarseg_torch.models.registry import build

    model = build("pspnet", attention)
    for engine in ("module", "serve"):
        assert callable(make_engine("pspnet", attention, model, None,
                                    engine, device=CPU))


def test_collect_calib_batches_normalizes_u8():
    img = np.full((2, 4, 4, 1), 255, np.uint8)
    got = collect_calib_batches(iter([{"image": img}] * 3), 2)
    assert len(got) == 2 and got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], 1.0)
    with pytest.raises(ValueError):
        collect_calib_batches(iter([]), 2)
