"""Port scene stitching (insarseg_torch/data/stitch.py) against the JAX
package's insarseg/data/stitch.py on the same predict function: <= 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.data import stitch as J
from insarseg_torch.data import stitch as T

CPU = torch.device("cpu")


def _jax_fn(t):
    return jnp.concatenate([2.0 * t, t * t - 0.5], axis=-1)


def _torch_fn(t):
    return torch.cat([2.0 * t, t * t - 0.5], dim=-1)


@pytest.mark.parametrize("hw,tile,overlap,bs,window", [
    ((96, 80), 32, 8, 3, "hann"),
    ((64, 64), 32, 0, None, "uniform"),
    ((20, 40), 32, 8, 2, "hann"),  # smaller than a tile: padded, cropped
])
def test_sliding_window_matches_jax(hw, tile, overlap, bs, window):
    scene = np.random.default_rng(0).standard_normal(hw + (1,)) \
        .astype(np.float32)
    want = np.asarray(J.sliding_window_inference(
        _jax_fn, jnp.asarray(scene), tile, overlap, window, bs))
    got = T.sliding_window_inference(_torch_fn, scene, tile, overlap, window,
                                     bs, device=CPU)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_plan_and_window_equal_jax():
    assert T.plan_tiles(1024, 1000, 512, 64) == J.plan_tiles(1024, 1000,
                                                             512, 64)
    np.testing.assert_array_equal(T._window(64, "hann"),
                                  J._window(64, "hann"))
    with pytest.raises(ValueError):
        T.plan_tiles(64, 64, 32, 32)
