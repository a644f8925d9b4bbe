"""K6's weight layout and counted bar on the CPU.

``pack_up_weight`` gives the kernel's K-major (taps * Cout, Cin) operand:
its rows are the columns of the earlier (Cin, taps * Cout) layout, and
``up_bf16_plain`` on it repeats the earlier ascending-k f32 sum bit for bit
(the same z as before), within one bf16 ulp of the JAX package's bf16
transposed convs (``insarseg/models/unet_int8.py::_conv_transpose_k2s2``,
``insarseg/models/unet_s2d.py::_up4_s2d``) in both geometries.
``assert_up_codes_close``, the bar that holds the tensor-core kernel to its
plain version, passes codes within 1 at a share inside its bound and raises
on a code off by 2, on a share past the bound and on a skip code that
differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.models import unet_int8 as J
from insarseg.models import unet_s2d as JS
from insarseg_torch.kernels import (
    assert_up_codes_close,
    pack_up_weight,
    up_concat_i8,
)
from insarseg_torch.kernels.up_i8 import up_bf16_plain


def _jax_layout_kernel(rng, s2d, cin, cout):
    """A transposed-conv kernel in the JAX package's packed layout:
    (2, 2, Cin, Cout), or (1, 2, Cin, Cout) for the H-s2d up4, f32."""
    return rng.normal(0, 1 / np.sqrt(cin),
                      (1 if s2d else 2, 2, cin, cout)).astype(np.float32)


def _earlier_z(y, k, bias, s2d):
    """The z of the earlier (Cin, taps * Cout) layout: its column
    t * Cout + c, the f32 sum in ascending k, bf16, the bias as a bf16 add,
    the taps placed on their output pixels."""
    kk = k.flip(1) if s2d else k
    w = kk.permute(2, 0, 1, 3).reshape(k.shape[2], -1).to(torch.bfloat16)
    b, h, wd, cin = y.shape
    rt = 1 if s2d else 2
    y2, w2 = y.reshape(-1, cin).float(), w.float()
    acc = torch.zeros((y2.shape[0], w2.shape[1]))
    for i in range(cin):
        acc.addcmul_(y2[:, i:i + 1], w2[i:i + 1])
    z = acc.to(torch.bfloat16)
    if bias is not None:
        z = (z.float() + bias.float().repeat(2 * rt)).to(torch.bfloat16)
    return z.reshape(b, h, wd, rt, 2, -1).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, rt * h, 2 * wd, -1)


@pytest.mark.parametrize("s2d,cin,cout", [(False, 64, 32), (False, 40, 48),
                                          (True, 32, 64), (True, 72, 16)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_pack_up_weight_keeps_z(s2d, cin, cout, with_bias):
    rng = np.random.default_rng(cin * 100 + cout + s2d)
    k = _jax_layout_kernel(rng, s2d, cin, cout)
    y_np = rng.normal(0, 1, (2, 5, 7, cin)).astype(np.float32)
    yj = jnp.asarray(y_np).astype(jnp.bfloat16)
    y = torch.from_numpy(np.array(yj).view(np.int16)).view(torch.bfloat16)
    bias_np = rng.normal(0, 0.5, cout).astype(np.float32) if with_bias \
        else None
    bias = None if bias_np is None else \
        torch.from_numpy(bias_np).to(torch.bfloat16)
    kt = torch.from_numpy(k)
    w = pack_up_weight(kt, s2d)
    taps = 2 if s2d else 4
    assert w.shape == (taps * cout, cin) and w.dtype == torch.bfloat16
    assert w.is_contiguous()
    # row t * Cout + c is the earlier layout's column t * Cout + c
    kk = kt.flip(1) if s2d else kt
    earlier = kk.permute(2, 0, 1, 3).reshape(cin, -1).to(torch.bfloat16)
    assert torch.equal(w, earlier.t())
    z = up_bf16_plain(y, w, bias, s2d)
    assert torch.equal(z, _earlier_z(y, kt, bias, s2d))
    # and the JAX package's bf16 transposed conv, within one bf16 ulp
    kb = jnp.asarray(k)
    bj = None if bias_np is None else jnp.asarray(bias_np)
    zj = JS._up4_s2d(yj, kb, bj) if s2d else \
        J._conv_transpose_k2s2(yj, kb, bj)
    zj = np.asarray(zj).astype(np.float32)
    zt = z.float().numpy()
    assert zt.shape == zj.shape
    ulp = np.maximum(np.spacing(np.abs(zj)) * 2.0 ** 16,
                     np.float32(2.0 ** -133))
    assert np.all(np.abs(zt - zj) <= ulp)


def test_up_concat_plain_takes_the_new_layout():
    """The CPU wrapper (the plain version) on the (N, K) weight: the skip's
    codes first, the requantized z after, the shape checked by the
    kernel's wrapper."""
    rng = np.random.default_rng(3)
    k = torch.from_numpy(_jax_layout_kernel(rng, False, 32, 16))
    y = torch.from_numpy(rng.normal(0, 1, (1, 3, 4, 32)).astype(np.float32)) \
        .to(torch.bfloat16)
    skip = torch.from_numpy(rng.integers(-127, 128, (1, 6, 8, 16),
                                         dtype=np.int8))
    out = up_concat_i8(y, pack_up_weight(k), None, skip, 0.02)
    assert out.shape == (1, 6, 8, 32) and out.dtype == torch.int8
    assert torch.equal(out[..., :16], skip)


def _codes(seed, shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


def test_counted_bar_passes_within_its_share():
    want = _codes(0, (2, 8, 8, 48))
    assert assert_up_codes_close(want.clone(), want, 16, 0.0) == (0, 0.0)
    got = want.clone()
    flat = got[..., 16:].reshape(-1)
    idx = torch.arange(0, flat.numel(), 64)  # 1 in 64 codes, +-1
    vals = flat[idx].to(torch.int16)
    flat[idx] = torch.where(vals < 127, vals + 1, vals - 1).to(torch.int8)
    got[..., 16:] = flat.reshape(got[..., 16:].shape)
    dmax, share = assert_up_codes_close(got, want, 16, 1 / 64)
    assert dmax == 1 and share == pytest.approx(len(idx) / flat.numel())


def test_counted_bar_raises_on_two():
    want = _codes(1, (1, 4, 4, 32))
    got = want.clone()
    v = int(want[0, 1, 2, 20])  # a ConvT code (channel 20 >= Cs 16)
    got[0, 1, 2, 20] = v + 2 if v < 100 else v - 2
    with pytest.raises(AssertionError, match="differs by 2"):
        assert_up_codes_close(got, want, 16, 1.0)


def test_counted_bar_raises_past_its_share():
    want = _codes(2, (1, 4, 4, 32))
    got = want.clone()
    vals = want[..., 16:].to(torch.int16)
    got[..., 16:] = torch.where(vals < 127, vals + 1, vals - 1) \
        .to(torch.int8)  # every code off by one
    with pytest.raises(AssertionError, match="of the codes differ"):
        assert_up_codes_close(got, want, 16, 0.5)
    assert assert_up_codes_close(got, want, 16, 1.0) == (1, 1.0)


def test_counted_bar_holds_the_skip_exactly():
    want = _codes(3, (1, 4, 4, 32))
    got = want.clone()
    v = int(want[0, 0, 0, 3])  # a skip code
    got[0, 0, 0, 3] = v + 1 if v < 127 else v - 1
    with pytest.raises(AssertionError, match="skip"):
        assert_up_codes_close(got, want, 16, 1.0)
    with pytest.raises(AssertionError, match="shape"):
        assert_up_codes_close(got[..., :31], want, 16, 1.0)
