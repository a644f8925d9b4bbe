"""Shared set-up for the port's parity tests (insarseg_torch vs insarseg),
plus the weight-bridge tests: one set of weights, made with numpy from a
seed, crosses from the JAX tree to the port through the port's bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.compat.torch_io import (
    segmentation_variables_from_torch as jax_segmentation_from_torch,
)
from insarseg.compat.torch_io import unet_variables_to_torch as jax_to_torch
from insarseg.models.registry import build as jax_build
from insarseg.models.unet import UNet as JaxUNet
from insarseg_torch.compat import (
    segmentation_variables_to_torch,
    state_dict_to_torch,
    unet_variables_to_torch,
)
from insarseg_torch.models.registry import build
from insarseg_torch.models.unet import UNet

CPU = torch.device("cpu")


def smooth(rng, shape):
    """Smooth random NHWC images (f32): coarse noise, bilinear upsampled."""
    b, h, w, c = shape
    coarse = rng.standard_normal((b, max(h // 4, 1), max(w // 4, 1), c))
    return np.array(jax.image.resize(
        jnp.asarray(coarse, jnp.float32), shape, "bilinear"))


def random_bn_stats(variables, seed=0):
    """Replace the init BN statistics/affines with random ones (var > 0),
    so BN folding is exercised with non-trivial values."""
    rng = np.random.default_rng(seed)

    def bn(p, s):
        c = p["scale"].shape[0]
        p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        p["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        s["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        s["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    params = jax.tree.map(np.array, variables["params"])
    stats = jax.tree.map(np.array, variables["batch_stats"])

    def walk(p, s):
        for k in s:
            if "mean" in s[k]:
                bn(p[k], s[k])
            else:
                walk(p[k], s[k])

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


def make_pair(base=16, use_se=True, hw=32, seed=0, nc=2, use_sa=False):
    """(JAX model, JAX variables as numpy, port UNet with those weights)."""
    jm = JaxUNet(num_classes=nc, base_features=base, use_se=use_se,
                 use_sa=use_sa)
    v = jm.init(jax.random.key(seed), jnp.zeros((1, hw, hw, 1)))
    v = random_bn_stats(v, seed)
    tm = UNet(num_classes=nc, base_features=base, use_se=use_se,
              use_sa=use_sa)
    tm.load_state_dict(state_dict_to_torch(
        unet_variables_to_torch(v, use_se=use_se, use_sa=use_sa)),
        strict=True)
    return jm, v, tm.eval()


def flat(tree, prefix=""):
    """(dotted key, leaf) pairs of a nested dict."""
    for k, val in tree.items():
        if isinstance(val, dict):
            yield from flat(val, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", val


def numpy_tree(tree):
    """A JAX-packed tree with its arrays as numpy (other leaves kept)."""
    return jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def assert_packed_equal(ours, ref):
    """A port-packed tree against the JAX package's, key for key: int8
    codes and non-float leaves equal, float scalars and arrays within rtol
    1e-5 (calibration replays are two f32 graphs; weight-only leaves are
    equal, which rtol 1e-5 also admits)."""
    ours, ref = dict(flat(ours)), dict(flat(ref))
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        o = ours[k]
        if r is None or isinstance(r, (bool, int, str, tuple, list)):
            assert o == r, k
        elif isinstance(r, float):
            assert o == pytest.approx(r, rel=1e-5), k
        elif k.endswith(".q"):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=k)
        else:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=0, err_msg=k)


RESNET_CELLS = [(m, a) for m in ("deeplabv3", "fcn")
                for a in ("none", "channel", "spatial")]


def resnet_numpy_state_dict(shapes, seed=0):
    """Weights made with numpy from a seed, in torchvision state_dict
    shapes: LeCun-normal convs (the JAX package's init), random BN affines
    and statistics (var > 0) as :func:`random_bn_stats` draws them."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = np.zeros(shape, np.int64)
            continue
        if k.endswith("running_mean"):
            a = rng.normal(0, 0.1, shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif len(shape) == 1 and k.endswith(".weight"):  # BN gamma
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(".bias"):
            a = rng.normal(0, 0.1, shape)
        else:  # Conv2d (O, I, kh, kw)
            a = rng.normal(0, np.sqrt(1.0 / np.prod(shape[1:])), shape)
        sd[k] = a.astype(np.float32)
    return sd


def make_resnet_pair(model, attention, seed=0):
    """(JAX module, JAX variables as numpy, port module with the same
    weights) for one DeepLabV3 / FCN cell at full ResNet-50 widths. The
    numpy weights enter the JAX tree through the JAX package's importer
    and reach the port through the port's bridge."""
    tm = build(model, attention).eval()
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    v = jax_segmentation_from_torch(
        resnet_numpy_state_dict(shapes, seed), model, attention)
    tm.load_state_dict(state_dict_to_torch(
        segmentation_variables_to_torch(v, model, attention)), strict=True)
    return jax_build(model, attention), v, tm


@pytest.mark.parametrize("use_se,use_sa", [(True, False), (False, False),
                                            (False, True)])
def test_bridge_matches_jax_package(use_se, use_sa):
    _, v, _ = make_pair(use_se=use_se, use_sa=use_sa)
    ours = unet_variables_to_torch(v, use_se=use_se, use_sa=use_sa)
    ref = jax_to_torch(v, use_se=use_se, use_sa=use_sa)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("use_se,use_sa", [(True, False), (False, True)])
def test_bridge_loads_strict_into_port_unet(use_se, use_sa):
    _, v, tm = make_pair(use_se=use_se, use_sa=use_sa)
    sd = unet_variables_to_torch(v, use_se=use_se, use_sa=use_sa)
    assert set(sd) == set(tm.state_dict())
