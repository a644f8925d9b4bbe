"""The fast cell ``unet-fast`` (insarseg_torch/models/unet_stem.py) against
the JAX package's ``insarseg/models/unet_stem.py``: the space-to-depth
stem and its inverse bit for bit, and the module / serve / int8 engines of
U-Net-fast-CA at level 1 = 16 on 64^2, one set of weights crossing through
the inner tree. Bars: module and serve within 1e-4 x max|logit| of the JAX
package's; int8 within 2e-2 x max|logit| with argmax agreement >= 99.5%
of its jitted engine. Artifacts cross both ways: a port-saved artifact
serves in the port bit for bit and in the JAX package, a JAX-saved one in
the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.engines import engine_from_artifact as jax_from_artifact
from insarseg.engines import make_engine as jax_make_engine
from insarseg.engines import pack_engine as jax_pack_engine
from insarseg.engines_io import load_artifact as jax_load
from insarseg.engines_io import save_artifact as jax_save
from insarseg.models import unet_stem as JF
from insarseg_torch.compat import state_dict_to_torch
from insarseg_torch.engines import (
    engine_from_artifact,
    make_engine,
    pack_engine,
)
from insarseg_torch.engines_io import load_artifact, save_artifact
from insarseg_torch.models import unet_stem as TF
from insarseg_torch.models.registry import build
from tests.test_torch_common import CPU, random_bn_stats, smooth

HW, L1 = 64, 16


@pytest.fixture(scope="module")
def fast():
    jm = JF.UNetFastS2D(num_classes=2, level1_features=L1, use_se=True)
    v = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, HW, HW, 1)))
    v = random_bn_stats(v, 0)
    tm = TF.UNetFastS2D(num_classes=2, level1_features=L1, use_se=True)
    tm.load_state_dict(state_dict_to_torch(
        TF.fast_variables_to_torch(v, use_se=True)), strict=True)
    rng = np.random.default_rng(60)
    calib = [smooth(rng, (2, HW, HW, 1))]
    x = smooth(rng, (2, HW, HW, 1))
    return jm, v, tm.eval(), calib, x


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(61).normal(0, 1, (2, 8, 12, 3)) \
        .astype(np.float32)
    got = TF.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JF.space_to_depth(jnp.asarray(x))))
    assert got.shape == (2, 4, 6, 12)
    np.testing.assert_array_equal(TF.depth_to_space(got).numpy(), x)


def test_registry_builds_the_fast_cell():
    m = build("unet-fast", "spatial", num_classes=3)
    assert isinstance(m, TF.UNetFastS2D) and m.use_sa and not m.use_se
    assert m.unet.inc.double_conv[0].weight.shape == (128, 4, 3, 3)
    assert m.unet.down4[1].double_conv[0].weight.shape == (1024, 512, 3, 3)
    assert m.unet.outc.weight.shape[0] == 12


def _check(got, want, engine):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape == (2, HW, HW, 2)
    rel = np.abs(got - want).max() / np.abs(want).max()
    agree = np.mean(got.argmax(-1) == want.argmax(-1))
    print(f"unet-fast {engine}: max rel err {rel:.3g}, argmax {agree:.5f}")
    if engine == "int8":
        assert rel <= 2e-2 and agree >= 0.995, (rel, agree)
    else:
        assert rel <= 1e-4, rel


@pytest.mark.parametrize("engine", ["module", "serve", "int8"])
def test_unet_fast_engine_matches_jax(tmp_path, fast, engine):
    jm, v, tm, calib, x = fast
    kw = {"calib_batches": calib} if engine == "int8" else {}
    want = np.asarray(jax_make_engine("unet-fast", "channel", jm, v, engine,
                                      **kw)(jnp.asarray(x)))
    got = make_engine("unet-fast", "channel", tm, None, engine, device=CPU,
                      **kw)(x)
    _check(got.float().numpy(), want, engine)
    cls = make_engine("unet-fast", "channel", tm, None, engine, device=CPU,
                      argmax=True, **kw)(x)
    assert cls.dtype == torch.int32 and cls.shape == (2, HW, HW)
    np.testing.assert_array_equal(cls.numpy(), got.float().numpy()
                                  .argmax(-1))
    if engine == "module":
        return
    art = pack_engine("unet-fast", "channel", tm, None, engine, device=CPU,
                      **kw)
    assert art["meta"] == {"factor": 2, "num_classes": 2}
    path = save_artifact(str(tmp_path / "port"), art)
    back = engine_from_artifact(load_artifact(path), device=CPU)(x)
    np.testing.assert_array_equal(back.float().numpy(), got.float().numpy())
    _check(got.float().numpy(),
           jax_from_artifact(jax_load(path))(jnp.asarray(x)), engine)
    jpath = jax_save(str(tmp_path / "jax"),
                     jax_pack_engine("unet-fast", "channel", jm, v, engine,
                                     **kw))
    _check(engine_from_artifact(load_artifact(jpath), device=CPU)(x)
           .float().numpy(), want, engine)
