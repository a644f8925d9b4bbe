"""``insarseg_torch/ops/resize.py::resize_nearest`` against the JAX
package's ``insarseg/ops/resize.py::resize_nearest`` on the CPU: NHWC,
HWC and HW inputs, up and down, float and integer (a mask), the same
values bit for bit (both take ``jax.image.resize``'s half-pixel-centre
rule in f32), the input itself where the size is its own, and the 2-4D
check. The bilinear resize's fixed-order backward (the card's:
``_Interpolate``, ``_LerpRows``) against autograd's through
``F.interpolate`` and the lerp on the same inputs, up and down, odd
scales and a 1x1 map, NCHW and channels-last: the same forward bit for
bit, the input's gradient within ``F64_BAR`` (f64), ``F32_BAR`` (f32) and
``BF16_BAR`` (bf16, where autograd may round between the two axes) of its
largest value, in the input's layout; in bf16 also the f32 gradient of
the same values rounded once, bit for bit. A resize with no gradient to
take runs the plain ops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from insarseg.ops.resize import resize_nearest as jax_resize_nearest
from insarseg_torch.ops import resize as R
from insarseg_torch.ops.resize import resize_nearest

F64_BAR = 1e-12  # x max|grad|: two orders of an f64 sum
F32_BAR = 1e-6  # x max|grad|: two orders of an f32 sum
BF16_BAR = 2.0 ** -8  # x max|grad|: one bf16 rounding more or less
BARS = {torch.float64: F64_BAR, torch.float32: F32_BAR,
        torch.bfloat16: BF16_BAR}


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


@pytest.mark.parametrize("shape, size", [
    ((2, 3, 8, 8), (64, 64)), ((2, 3, 1, 1), (16, 16)),
    ((1, 2, 6, 6), (13, 17)), ((2, 4, 9, 7), (9, 20)),
    ((1, 2, 17, 19), (5, 4)),
], ids=["up-8x", "from-1x1", "odd-up", "w-only", "down"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16], ids=["f64", "f32", "bf16"])
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "cl"])
def test_fixed_order_interpolate_backward(shape, size, dtype, channels_last):
    g = torch.Generator().manual_seed(sum(shape) + sum(size))
    x = torch.randn(shape, generator=g).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    dy = torch.randn(shape[:2] + size, generator=g).to(dtype)
    got = R._interpolate(x, size)
    want = F.interpolate(x, size=size, mode="bilinear", align_corners=False)
    assert got.grad_fn.name() == "_InterpolateBackward"
    assert torch.equal(got, want)
    (dx,) = torch.autograd.grad(got, x, dy)
    (ref,) = torch.autograd.grad(want, x, dy)
    assert dx.dtype == dtype
    assert float((dx - ref).abs().max()) \
        <= BARS[dtype] * float(ref.abs().max())
    assert dx.is_contiguous(memory_format=torch.channels_last) \
        == channels_last or shape[2:] == (1, 1)
    if dtype == torch.bfloat16:
        x32 = x.detach().float().requires_grad_(True)
        (dx32,) = torch.autograd.grad(R._Interpolate.apply(x32, size), x32,
                                      dy.float())
        assert torch.equal(dx, dx32.to(dtype))


def test_resize_without_a_gradient_runs_the_plain_ops():
    x = torch.randn(1, 2, 5, 6, requires_grad=True)
    assert R._interpolate(x.detach(), (9, 9)).grad_fn is None
    with torch.no_grad():
        assert R._interpolate(x, (9, 9)).grad_fn is None
    rows = R._source_rows(5, 9, 0, 9, "cpu")
    assert R._lerp_rows(x.detach(), *rows).grad_fn is None
    assert R._lerp_rows(x, *rows).grad_fn.name() == "_LerpRowsBackward"


@pytest.mark.parametrize("n_in, start, count", [(0, 0, 0), (9, 4, 0)],
                         ids=["empty-slab", "no-output-row"])
def test_fixed_order_lerp_rows_of_no_row(n_in, start, count):
    """A slab of no row, or no output row, in the graph: an empty
    gradient of the input's shape."""
    x = torch.randn(2, 3, n_in, 5, requires_grad=True)
    rows = R._source_rows(max(n_in, 1), 20, start, count, "cpu")
    y = R._lerp_rows(x, *rows)
    assert y.shape == (2, 3, count, 5)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert dx.shape == x.shape and not dx.any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fixed_order_lerp_rows_backward(dtype):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 9, 5, generator=g, dtype=dtype,
                    requires_grad=True)
    rows = R._source_rows(9, 20, 3, 11, "cpu")
    dy = torch.randn(2, 3, 11, 5, generator=g, dtype=dtype)
    got = R._LerpRows.apply(x, *rows)
    want = R._lerp(x, *rows)
    assert torch.equal(got, want)
    (dx,) = torch.autograd.grad(got, x, dy)
    (ref,) = torch.autograd.grad(want, x, dy)
    bar = F64_BAR if dtype == torch.float64 else F32_BAR
    assert float((dx - ref).abs().max()) <= bar * float(ref.abs().max())
