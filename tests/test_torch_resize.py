"""``insarseg_torch/ops/resize.py::resize_nearest`` against the JAX
package's ``insarseg/ops/resize.py::resize_nearest`` on the CPU: NHWC,
HWC and HW inputs, up and down, float and integer (a mask), the same
values bit for bit (both take ``jax.image.resize``'s half-pixel-centre
rule in f32), the input itself where the size is its own, and the 2-4D
check."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.ops.resize import resize_nearest as jax_resize_nearest
from insarseg_torch.ops.resize import resize_nearest


@pytest.mark.parametrize("shape, size", [
    ((2, 7, 9, 3), (13, 5)), ((7, 9, 3), (3, 20)), ((7, 9), (21, 2)),
    ((1, 100, 37, 1), (33, 111)), ((5, 5), (1, 1)), ((3, 8, 8, 2), (8, 8)),
], ids=["nhwc", "hwc", "hw", "odd-scales", "to-1x1", "same-size"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_resize_nearest_matches_jax(shape, size, dtype):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, shape).astype(dtype) if dtype == np.int32 \
        else rng.normal(size=shape).astype(dtype)
    want = np.asarray(jax_resize_nearest(jnp.asarray(x), size))
    got = resize_nearest(torch.from_numpy(x), size).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_nearest_rejects_other_ranks():
    with pytest.raises(ValueError, match="2-4D"):
        resize_nearest(torch.zeros(1, 2, 3, 4, 5), (2, 2))
