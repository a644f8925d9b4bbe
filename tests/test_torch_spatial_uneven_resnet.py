"""The ResNet families' H-sharded forwards at odd slab heights
(``insarseg_torch/parallel/spatial.py``: row ranges, halos past small
and empty slabs): FCN-ResNet50-CA, DeepLabV3-ResNet50 and the
PSPNet-ResNet50-CA at full ResNet-50 widths, 36^2, global b2, the port's
``make_predict_fn`` over ``make_mesh(data=2, spatial=4, devices=["cpu"]
* 8)`` (9-row slabs; at the output stride the 5 rows fall 2, 1, 1, 1 over
the slabs, where ASPP's rates and the PSPNet's bins reach past them)
against the JAX package's ``make_predict_fn(model, mesh=make_mesh(data=2,
spatial=4))`` (the 8 virtual CPU devices of ``tests/conftest.py``), within
1e-4 x max|logit| (the port's ResNet bar), and the argmax form equal to
one device's. The JAX trees are numpy draws (``make_resnet_pair``,
``numpy_pspnet_variables``)."""

import numpy as np
import pytest
import torch

from insarseg.models.pspnet import PSPNet as JaxPSPNet
from insarseg.parallel import make_mesh as jax_make_mesh
from insarseg.parallel import make_predict_fn as jax_predict_fn
from insarseg.parallel import replicate as jax_replicate
from insarseg.parallel import shard_batch as jax_shard_batch
from insarseg_torch.compat import (
    pspnet_variables_to_torch,
    state_dict_to_torch,
)
from insarseg_torch.models.registry import build
from insarseg_torch.parallel import make_mesh, make_predict_fn
from tests.test_torch_common import make_resnet_pair, smooth
from tests.test_torch_pspnet import numpy_pspnet_variables

BAR = 1e-4  # x max|logit|: the port's ResNet bar
DATA, SPATIAL = 2, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    return smooth(np.random.default_rng(13), (2, 36, 36, 1))


def _pair(cell):
    if cell == "pspnet-channel":
        v = numpy_pspnet_variables("channel", seed=4)
        model = build("pspnet", "channel").eval()
        model.load_state_dict(state_dict_to_torch(
            pspnet_variables_to_torch(v, "channel")), strict=True)
        return JaxPSPNet(attention="channel"), v, model
    return make_resnet_pair(*cell.split("-"), seed=5)


@pytest.mark.parametrize("cell", ["fcn-channel", "deeplabv3-none",
                                  "pspnet-channel"])
def test_odd_slab_forward_matches_jax_mesh(cell, images):
    jmodel, v, model = _pair(cell)
    jmesh = jax_make_mesh(data=DATA, spatial=SPATIAL)
    want = np.asarray(jax_predict_fn(jmodel, mesh=jmesh)(
        jax_replicate(v, jmesh),
        jax_shard_batch({"image": images}, jmesh)["image"]))
    mesh = make_mesh(data=DATA, spatial=SPATIAL,
                     devices=["cpu"] * (DATA * SPATIAL))
    got = make_predict_fn(model, mesh=mesh)(torch.from_numpy(images))
    assert got.shape == images.shape[:3] + (2,)
    err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert err < BAR, err
    cls = make_predict_fn(model, argmax=True, mesh=mesh)(
        torch.from_numpy(images))
    one = make_predict_fn(model, device="cpu")(torch.from_numpy(images))
    assert float((cls == one.argmax(-1)).float().mean()) > 0.999
