"""Port engine factory and artifacts for DeepLabV3 / FCN against the JAX
package: a JAX-saved serve or int8 artifact serves in the port, a
port-saved one serves in the JAX package, and the three engines agree on
the CPU.

Bars: serve within 1e-4 x max|logit|; int8 within 2e-2 x max|logit| with
argmax agreement >= 99.5% of the JAX package's ``resnet_int8_apply`` run
op by op on the artifact's tree. The JAX package's jitted int8 engine
(what ``insarseg.engines.engine_from_artifact`` serves) rounds at other
places than its own op by op graph: XLA fuses the bf16 head and the conv
epilogues under ``jit`` (2.4e-2 x max|logit| apart on FCN-CA at 32^2). The
port is held to it too, at bars pinned from the values measured on these
inputs (``JITTED``); the int8 engine against the f32 engines is held to
the JAX package's correlation bar, > 0.97 (``tests/test_resnet_int8.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.engines import engine_from_artifact as jax_from_artifact
from insarseg.engines import pack_engine as jax_pack_engine
from insarseg.engines_io import load_artifact as jax_load
from insarseg.engines_io import save_artifact as jax_save
from insarseg.models.resnet_int8 import resnet_int8_apply as jax_int8_apply
from insarseg_torch.engines import engine_from_artifact, make_engine, pack_engine
from insarseg_torch.engines_io import load_artifact, save_artifact
from insarseg_torch.models.registry import build
from tests.test_torch_common import CPU, make_resnet_pair, smooth

CELLS = [("deeplabv3", "none"), ("fcn", "channel")]
# the port's int8 engine against the JAX package's jitted one on these
# inputs: (max |delta| / max|logit|, argmax agreement) bars, pinned above
# the values measured (DeepLabV3: 0.0147 on the JAX-saved tree and 0.0074
# on the port-saved one, agreement 1.0 on both; FCN-CA: 0.0242 and 0.0047,
# agreement 0.99756 and 1.0)
JITTED = {"deeplabv3": (0.02, 0.995), "fcn": (0.03, 0.995)}


@pytest.fixture(scope="module", params=CELLS,
                ids=[f"{m}-{a}" for m, a in CELLS])
def cell(request):
    model, attention = request.param
    jm, v, tm = make_resnet_pair(model, attention)
    rng = np.random.default_rng(50)
    calib = [smooth(rng, (2, 32, 32, 1))]
    x = smooth(rng, (2, 32, 32, 1))
    return model, attention, jm, v, tm, calib, x


def _np32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _argmax_agree(got, want):
    return np.mean(_np32(got).argmax(-1) == _np32(want).argmax(-1))


def _check(got, want, engine):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / np.abs(want).max()
    if engine == "serve":
        assert rel <= 1e-4, rel
    else:
        assert rel <= 2e-2, rel
        assert _argmax_agree(got, want) >= 0.995


def _jax_serves(path, x, engine, got):
    """The JAX package serves the artifact at ``path``: its jitted engine,
    and (int8) its op-by-op apply, the reference for the bars. The port's
    int8 output ``got`` is also held to the jitted engine at the pinned
    ``JITTED`` bars."""
    art = jax_load(path)
    jitted = jax_from_artifact(art)(jnp.asarray(x))
    if engine == "serve":
        return jitted
    want = jax_int8_apply(art["tree"], jnp.asarray(x))
    assert _argmax_agree(jitted, want) >= 0.99
    got, jitted = _np32(got), _np32(jitted)
    rel = np.abs(got - jitted).max() / np.abs(jitted).max()
    agree = _argmax_agree(got, jitted)
    print(f"{art['model']} int8, port vs the JAX jitted engine: max rel err "
          f"{rel:.4g}, argmax {agree:.5f}")
    bar_rel, bar_agree = JITTED[art["model"]]
    assert rel <= bar_rel and agree >= bar_agree, (rel, agree)
    return want


@pytest.mark.parametrize("engine", ["serve", "int8"])
def test_serves_jax_artifact(tmp_path, cell, engine):
    model, attention, jm, v, _, calib, x = cell
    art = jax_pack_engine(model, attention, jm, v, engine,
                          calib_batches=calib if engine == "int8" else None)
    path = jax_save(str(tmp_path / engine), art)
    got = engine_from_artifact(load_artifact(path), device=CPU)(x)
    _check(got, _jax_serves(path, x, engine, got), engine)


@pytest.mark.parametrize("engine", ["serve", "int8"])
def test_port_artifact_serves_in_jax(tmp_path, cell, engine):
    model, attention, _, _, tm, calib, x = cell
    calib = calib if engine == "int8" else None
    art = pack_engine(model, attention, tm, None, engine,
                      calib_batches=calib, device=CPU)
    path = save_artifact(str(tmp_path / engine), art)
    ours = make_engine(model, attention, tm, None, engine,
                       calib_batches=calib, device=CPU)(x).float().numpy()
    back = engine_from_artifact(load_artifact(path), device=CPU)(x)
    np.testing.assert_array_equal(back.float().numpy(), ours)
    _check(ours, _jax_serves(path, x, engine, ours), engine)


def test_engines_agree_on_cpu(cell):
    model, attention, _, _, tm, calib, x = cell
    module = make_engine(model, attention, tm, None, "module",
                         device=CPU)(x).numpy()
    serve = make_engine(model, attention, tm, None, "serve",
                        device=CPU)(x).numpy()
    _check(serve, module, "serve")
    int8 = make_engine(model, attention, tm, None, "int8",
                       calib_batches=calib, device=CPU)(x)
    assert int8.dtype == torch.bfloat16
    assert np.corrcoef(_np32(int8).ravel(), serve.ravel())[0, 1] > 0.97
    cls = make_engine(model, attention, tm, None, "int8",
                      calib_batches=calib, device=CPU, argmax=True)(x)
    assert cls.dtype == torch.int32 and cls.shape == (2, 32, 32)


@pytest.mark.parametrize("model,attention,engine", [
    ("pspnet", "none", "serve"), ("pspnet", "spatial", "int8")])
def test_pspnet_builds_and_round_trips(model, attention, engine):
    """The true PSPNet's cells build and serve on the CPU: through
    ``make_engine`` on the port's module at full ResNet-50 widths, and
    from the port's artifact, with the same logits."""
    torch.manual_seed(0)
    tm = build(model, attention).eval()
    rng = np.random.default_rng(60)
    calib = [smooth(rng, (2, 32, 32, 1))] if engine == "int8" else None
    x = smooth(rng, (2, 32, 32, 1))
    got = make_engine(model, attention, tm, None, engine,
                      calib_batches=calib, device=CPU)(x)
    assert got.shape == (2, 32, 32, 2)
    assert got.dtype == (torch.bfloat16 if engine == "int8"
                         else torch.float32)
    assert bool(torch.isfinite(got.float()).all())
    art = pack_engine(model, attention, tm, None, engine,
                      calib_batches=calib, device=CPU)
    back = engine_from_artifact(art, device=CPU)(x)
    assert torch.equal(back, got)
