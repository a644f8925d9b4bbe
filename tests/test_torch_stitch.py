"""Port scene stitching (insarseg_torch/data/stitch.py) against the JAX
package's insarseg/data/stitch.py on the same predict function: <= 1e-5
for one scene; the batched multi-scene stitch within 1e-6 of JAX's
``sliding_window_inference_batched`` and bit-identical to stitching each
scene alone (a tail chunk padded by index included)."""

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


@pytest.mark.parametrize("hw,tile,overlap,bs", [
    ((96, 80), 32, 8, 5),    # 3 x 12 tiles in chunks of 5: a tail of 1
    ((20, 40), 32, 8, 2),    # smaller than a tile: padded, cropped
    ((64, 64), 32, 0, None),  # one chunk of all 12 tiles
])
def test_batched_stitch_equals_per_scene_and_jax(hw, tile, overlap, bs):
    scenes = np.random.default_rng(1).standard_normal((3,) + hw + (1,)) \
        .astype(np.float32)
    calls = []

    def fn(t):
        calls.append(t.shape[0])
        return _torch_fn(t)

    got = T.sliding_window_inference_batched(fn, scenes, tile, overlap,
                                             batch_size=bs, device=CPU)
    assert got.shape == (3,) + hw + (2,)
    n_tiles = 3 * len(T.plan_tiles(max(hw[0], tile), max(hw[1], tile), tile,
                                   overlap))
    assert calls == [bs or n_tiles] * -(-n_tiles // (bs or n_tiles))
    for i in range(3):
        alone = T.sliding_window_inference(_torch_fn, scenes[i], tile,
                                           overlap, batch_size=bs,
                                           device=CPU)
        assert torch.equal(got[i], alone), i
    want = np.asarray(J.sliding_window_inference_batched(
        _jax_fn, jnp.asarray(scenes), tile, overlap, batch_size=bs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("gate", ["unet", "resnet"])
@pytest.mark.parametrize("c", [256, 1024])
def test_se_gates_do_not_depend_on_the_batch(gate, c):
    """A tile's SE gates, and so its codes, are the same alone and among
    17 other tiles: the batched multi-scene predict runs chunks of other
    sizes than a scene alone, and an f32 GEMM sums in an order that
    depends on its row count (here MKL's at 1, 9 and 18 rows; cuBLAS's on
    the card). Bit-equal."""
    from insarseg_torch.models.resnet_serve import _se_gate
    from insarseg_torch.models.unet_s2d import _se_scales

    g = torch.Generator().manual_seed(c)
    pk = {"fc1": torch.randn(c, c // 16, generator=g) / c ** 0.5,
          "fc2": torch.randn(c // 16, c, generator=g) / (c // 16) ** 0.5}
    fn = _se_scales if gate == "unet" else _se_gate
    for trial in range(5):
        pooled = torch.randn(18, c, generator=g)
        full = fn(pk, pooled)
        for n in (1, 9):
            assert torch.equal(full[:n], fn(pk, pooled[:n])), (trial, n)
