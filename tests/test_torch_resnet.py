"""Port DeepLabV3 / FCN (every attention cell, full ResNet-50 widths, 32^2)
against the JAX package on one set of numpy weights:

- bridge: ``segmentation_variables_to_torch`` equals the JAX package's key
  for key and bit for bit, and loads with ``strict=True``;
- module f32: within 1e-4 x max|logit| of ``model.apply(train=False)``;
- serve f32: the port's folded tree and graph within 1e-4 x max|logit| of
  ``resnet_serve_apply`` on the JAX package's folded tree, and the JAX
  package's folded tree serves in the port unchanged.

The bars are float reassociation (two f32 graphs with other summation
orders through 53 convs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.compat.torch_io import (
    segmentation_variables_to_torch as jax_to_torch,
)
from insarseg.models.resnet_serve import pack_resnet_serve as jax_pack_serve
from insarseg.models.resnet_serve import resnet_serve_apply as jax_serve_apply
from insarseg_torch.compat import segmentation_variables_to_torch
from insarseg_torch.engines_io import to_torch_tree
from insarseg_torch.models.registry import build
from insarseg_torch.models.resnet_serve import (
    make_resnet_serve_predict_fn,
    pack_resnet_serve,
    resnet_serve_apply,
)
from tests.test_torch_common import CPU, RESNET_CELLS, make_resnet_pair

BAR = 1e-4


@pytest.fixture(scope="module", params=RESNET_CELLS,
                ids=[f"{m}-{a}" for m, a in RESNET_CELLS])
def cell(request):
    model, attention = request.param
    jm, v, tm = make_resnet_pair(model, attention)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 1)) \
        .astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    return model, attention, jm, v, tm, x, want


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_bridge_matches_jax_package(cell):
    model, attention, _, v, tm, _, _ = cell
    ours = segmentation_variables_to_torch(v, model, attention)
    ref = jax_to_torch(v, model, attention)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    fresh = build(model, attention)
    fresh.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(a))
                           for k, a in ours.items()}, strict=True)


def test_module_matches_jax(cell):
    *_, tm, x, want = cell
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 32, 32, 2)
    rel = _rel(got, want)
    print(f"module vs jax: {rel:.3g} x max|logit|")
    assert rel <= BAR, rel


def test_serve_matches_jax(cell):
    _, _, _, v, tm, x, _ = cell
    jtree = jax_pack_serve(v)
    want = np.asarray(jax_serve_apply(jtree, jnp.asarray(x)))
    got = resnet_serve_apply(pack_resnet_serve(tm.state_dict()),
                             torch.from_numpy(x)).numpy()
    rel = _rel(got, want)
    print(f"serve vs jax serve: {rel:.3g} x max|logit|")
    assert rel <= BAR, rel
    np_tree = jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, jtree)
    on_jax_tree = make_resnet_serve_predict_fn(to_torch_tree(np_tree, CPU))(x)
    assert _rel(on_jax_tree.numpy(), want) <= BAR
    cls = make_resnet_serve_predict_fn(to_torch_tree(np_tree, CPU),
                                       argmax=True)(x)
    assert cls.dtype == torch.int32 and cls.shape == (2, 32, 32)
    np.testing.assert_array_equal(cls.numpy(), on_jax_tree.numpy().argmax(-1))
