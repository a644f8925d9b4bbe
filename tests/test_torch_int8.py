"""Port int8 engine in the standard layout against the JAX package's
``pack_unet_int8(s2d=False)`` / ``unet_int8_apply`` (the H-s2d layout:
tests/test_torch_s2d.py; the SA variant: tests/test_torch_unet_sa.py):
equal weight codes
and scales (rtol 1e-5: the calibration replays are two f32 graphs), and
the forward on the JAX-packed tree within 2e-2 x max|logit| with argmax
agreement >= 99.5% (the bf16 transposed convs and head round at other
places in the two frameworks)."""

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
from tests.test_torch_common import (
    CPU,
    assert_packed_equal,
    make_pair,
    numpy_tree,
    smooth,
)


@pytest.fixture(scope="module")
def setup():
    jm, v, tm = make_pair(use_se=True, hw=32)
    rng = np.random.default_rng(20)
    calib = [smooth(rng, (2, 32, 32, 1)) for _ in range(2)]
    return v, tm, calib


def test_pack_int8_equals_jax(setup):
    v, tm, calib = setup
    ours = pack_unet_int8(tm.state_dict(), calib, s2d=False, device=CPU)
    assert ours["s2d"] is False
    assert_packed_equal(ours, jax_pack(v, [jnp.asarray(c) for c in calib],
                                       s2d=False))


def test_int8_apply_on_jax_tree_matches_jax(setup):
    v, _, calib = setup
    tree = jax_pack(v, [jnp.asarray(c) for c in calib], s2d=False)
    x = smooth(np.random.default_rng(21), (4, 32, 32, 1))
    want = np.asarray(jax_apply(tree, jnp.asarray(x))).astype(np.float32)
    np_tree = numpy_tree(tree)
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

