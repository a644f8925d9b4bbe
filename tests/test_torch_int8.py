"""Port int8 engine (standard layout) against the JAX package's
``pack_unet_int8(s2d=False)`` / ``unet_int8_apply``: equal weight codes
and scales (rtol 1e-5: the calibration replays are two f32 graphs), and
the forward on the JAX-packed tree within 2e-2 x max|logit| with argmax
agreement >= 99.5% (the bf16 transposed convs and head round at other
places in the two frameworks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.models.unet_int8 import pack_unet_int8 as jax_pack
from insarseg.models.unet_int8 import unet_int8_apply as jax_apply
from insarseg_torch.models.unet_int8 import (
    pack_unet_int8,
    prepare_int8,
    unet_int8_apply,
)
from tests.test_torch_common import CPU, make_pair, smooth


@pytest.fixture(scope="module")
def setup():
    jm, v, tm = make_pair(use_se=True, hw=32)
    rng = np.random.default_rng(20)
    calib = [smooth(rng, (2, 32, 32, 1)) for _ in range(2)]
    return v, tm, calib


def _flat(tree, prefix=""):
    for k, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", val


def test_pack_int8_equals_jax(setup):
    v, tm, calib = setup
    ours = dict(_flat(pack_unet_int8(tm.state_dict(), calib, device=CPU)))
    ref = dict(_flat(jax_pack(v, [jnp.asarray(c) for c in calib],
                              s2d=False)))
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        o = ours[k]
        if r is None or isinstance(r, (bool, int, str)):
            assert o == r, k
        elif isinstance(r, float):
            assert o == pytest.approx(r, rel=1e-5), k
        elif k.endswith(".q"):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=k)
        else:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=0, err_msg=k)


def test_int8_apply_on_jax_tree_matches_jax(setup):
    v, _, calib = setup
    tree = jax_pack(v, [jnp.asarray(c) for c in calib], s2d=False)
    x = smooth(np.random.default_rng(21), (4, 32, 32, 1))
    want = np.asarray(jax_apply(tree, jnp.asarray(x))).astype(np.float32)
    np_tree = jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)
    got = unet_int8_apply(prepare_int8(np_tree, CPU), torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    agree = np.mean(got.argmax(-1) == want.argmax(-1))
    # measured on this test's inputs: max rel err 0, argmax agreement 1.0
    print(f"int8 port vs jax: max rel err {rel:.3g}, argmax {agree:.5f}")
    assert rel <= 2e-2, rel
    assert agree >= 0.995, agree
    cls = unet_int8_apply(prepare_int8(np_tree, CPU), torch.from_numpy(x),
                          argmax=True)
    assert cls.dtype == torch.int32
    np.testing.assert_array_equal(cls.numpy(), got.argmax(-1))


def test_s2d_raises(setup):
    v, tm, calib = setup
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        pack_unet_int8(tm.state_dict(), calib, s2d=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        prepare_int8({"s2d": True}, CPU)
