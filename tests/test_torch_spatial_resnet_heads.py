"""FCN's and the PSPNet's H-sharded forwards
(``insarseg_torch/parallel/spatial.py``): the port's ``make_predict_fn``
over ``make_mesh(data=4, spatial=2, devices=["cpu"] * 8)`` against the
JAX package's ``make_predict_fn(model, mesh=make_mesh(data=4,
spatial=2))``, no and channel attention, full ResNet-50 widths, 32^2,
global b8 (16-row slabs: 2 rows a slab at the output stride, where the
PSPNet's bins 3 and 6 cross the slabs' edge), within 1e-4 x max|logit|,
and the argmax form (``tests/test_torch_spatial_resnet.py``, whose
helpers these are). The JAX trees are numpy draws
(``make_resnet_pair``, ``numpy_pspnet_variables``)."""

import numpy as np
import pytest
import torch

from insarseg.models.pspnet import PSPNet as JaxPSPNet
from insarseg_torch.compat import (
    pspnet_variables_to_torch,
    state_dict_to_torch,
)
from insarseg_torch.models.registry import build
from tests.test_torch_common import make_resnet_pair, smooth
from tests.test_torch_pspnet import numpy_pspnet_variables
from tests.test_torch_spatial_resnet import (
    check_sharded_forward,
    jax_mesh_forward,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    return smooth(np.random.default_rng(11), (8, 32, 32, 1))


@pytest.mark.parametrize("attention", ["none", "channel"])
def test_fcn_h_sharded_forward_matches_jax_mesh(attention, images):
    jmodel, v, model = make_resnet_pair("fcn", attention, seed=3)
    check_sharded_forward(model, jax_mesh_forward(jmodel, v, images),
                          images)


@pytest.mark.parametrize("attention", ["none", "channel"])
def test_pspnet_h_sharded_forward_matches_jax_mesh(attention, images):
    v = numpy_pspnet_variables(attention, seed=4)
    model = build("pspnet", attention).eval()
    model.load_state_dict(state_dict_to_torch(
        pspnet_variables_to_torch(v, attention)), strict=True)
    check_sharded_forward(
        model, jax_mesh_forward(JaxPSPNet(attention=attention), v, images),
        images)
