"""Host-side rules of the tensor-core int8 convolutions K1 and K5a
(``insarseg_torch/kernels/conv_i8.py``): the weight repack pads Cin to a
multiple of 16 with zero codes, which leaves every code of the plain
versions as it was; the wrappers pad x to the same width; the N-tile
chooser ``tile_n`` is a pure function of Cout. The kernels themselves are
held to the plain versions on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from insarseg_torch.kernels import (
    conv3x3_i8,
    conv_i8,
    conv_i8_plain,
    repack_conv_weight,
    tile_n,
)
from insarseg_torch.kernels.conv_i8 import _check_cuda_args
from insarseg_torch.ops.quant import quant_weight


def _weight(rng, k, cin, cout):
    return torch.from_numpy(quant_weight(rng.normal(0, 1,
                                                    (k, k, cin, cout)))["q"])


@pytest.mark.parametrize("cin", [1, 2, 15, 16, 17, 40, 64, 96])
@pytest.mark.parametrize("k", [1, 3])
def test_repack_pads_to_16_with_zero_codes(cin, k):
    q = _weight(np.random.default_rng(cin), k, cin, 24)
    w = repack_conv_weight(q)
    cin16 = -(-cin // 16) * 16
    assert w.shape == (24, k, k, cin16) and w.dtype == torch.int8
    assert torch.equal(w[..., :cin], q.permute(3, 0, 1, 2))
    assert not w[..., cin:].any()


def test_repack_rejects_other_kernels():
    with pytest.raises(ValueError):
        repack_conv_weight(torch.zeros((5, 5, 4, 8), dtype=torch.int8))
    with pytest.raises(ValueError):
        repack_conv_weight(torch.zeros((3, 1, 4, 8), dtype=torch.int8))


def _args(rng, b, h, w, cin, cout, k):
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin))
                         .astype(np.int8))
    q = _weight(rng, k, cin, cout)
    acc_sd = 127.0 * 127.0 * np.sqrt(k * k * cin) / 3
    mult = torch.from_numpy((rng.uniform(0.5, 1.5, cout) * 60 / acc_sd)
                            .astype(np.float32))
    off = torch.from_numpy(rng.normal(0, 10, cout).astype(np.float32))
    return x, q, mult, off


@pytest.mark.parametrize("cin", [1, 2, 40])
@pytest.mark.parametrize("k,stride,dilation", [(3, 1, 1), (3, 2, 2),
                                               (1, 2, 1)])
@pytest.mark.parametrize("exit_", ["s8", "f32", "bf16"])
def test_plain_codes_unchanged_by_padding(cin, k, stride, dilation, exit_):
    """The 16-padded weight gives the codes of the unpadded weight and of
    the 4-padded one the kernels took before (zero codes are exact)."""
    rng = np.random.default_rng(cin * 10 + k)
    x, q, mult, off = _args(rng, 2, 11, 9, cin, 24, k)
    kw = {"stride": stride, "dilation": dilation,
          "out_s": 0.5 if exit_ == "s8" else None, "bf16": exit_ == "bf16"}
    outs = []
    for width in (cin, -(-cin // 4) * 4, -(-cin // 16) * 16):
        w = torch.zeros((24, k, k, width), dtype=torch.int8)
        w[..., :cin] = q.permute(3, 0, 1, 2)
        outs.append(conv_i8_plain(x, w, mult, off, **kw))
    assert outs[2].shape == (2, (11 - 1) // stride + 1, (9 - 1) // stride + 1,
                             24)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    # and the wrapper on CPU tensors is the plain version on the repack
    got = conv_i8(x, repack_conv_weight(q), mult, off, **kw)
    assert torch.equal(got, outs[0])
    if exit_ == "s8":
        assert len(torch.unique(got)) > 32  # the codes span a range
    if (k, stride, dilation) == (3, 1, 1) and exit_ != "f32":
        k1 = conv3x3_i8(x, repack_conv_weight(q), mult, off, kw["out_s"])
        assert torch.equal(k1, outs[0])


@pytest.mark.parametrize("cout,bn", [(1, 64), (2, 64), (16, 64), (40, 64),
                                     (64, 64), (65, 128), (80, 128),
                                     (128, 128), (192, 64), (256, 128),
                                     (320, 64), (512, 128), (1024, 128),
                                     (2048, 128)])
def test_tile_n_cases(cout, bn):
    assert tile_n(cout) == bn


def test_tile_n_is_a_pure_function_that_wastes_under_one_64_group():
    for cout in range(1, 4097):
        bn = tile_n(cout)
        assert bn in (64, 128) and tile_n(cout) == bn
        assert -(-cout // bn) * bn - cout < 64
        if cout <= 64:
            assert bn == 64


@pytest.mark.parametrize("cin", [1, 2, 16, 33, 48])
def test_wrapper_pads_x_to_the_weight_width(cin):
    """``_check_cuda_args`` (the checks before a launch, here on CPU
    tensors) pads x with zero codes to the 16-padded width and rejects a
    channel count the weight was not packed for."""
    rng = np.random.default_rng(cin)
    x, q, mult, off = _args(rng, 1, 3, 4, cin, 8, 3)
    w = repack_conv_weight(q)
    xp = _check_cuda_args(x, w, mult, off)
    assert xp.shape == (1, 3, 4, w.shape[-1])
    assert torch.equal(xp[..., :cin], x) and not xp[..., cin:].any()
    for bad in (w.shape[-1] - 16, w.shape[-1] + 1):
        if bad > 0:
            xb = torch.zeros((1, 3, 4, bad), dtype=torch.int8)
            with pytest.raises(ValueError):
                _check_cuda_args(xb, w, mult, off)


def _rn32(x):
    """The float32 nearest to the rational ``x`` (ties to even)."""
    from fractions import Fraction

    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        if best is None or d < best[0] or (
                d == best[0] and not int(np.float32(c).view(np.int32)) & 1):
            best = (d, c)
    return np.float32(best[1])


def test_kernel_requant_division_is_correctly_rounded():
    """The kernels' int8 exit divides by the scale as
    q0 = RN(y * r), q = RN(q0 + RN(y - q0 * s) * r) with r = RN(1 / s)
    (Markstein's correction, ``csrc/igemm_i8.cuh::requant``). Emulated here
    exactly (products of two float32 are exact in float64, the FMA's
    remainder is rounded once to float32, the last sum is rounded once from
    its exact rational value), it
    must equal RN(y / s), the plain version's division, on quotients at,
    and one ulp beside, every half-integer tie in the int8 range and on
    random ones, for scales over four decades."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    scales = [np.float32(v) for v in np.exp(rng.uniform(-9.2, 2.3, 24))]
    scales += [np.float32(v) for v in (0.5, 0.25, 1, 2, 3, 0.1, 0.3, 1 / 3,
                                       0.7, 6, 0.0173, 0.03)]
    n = 0
    for s in scales:
        k = np.arange(-128, 128)
        ties = ((k + 0.5) * np.float64(s)).astype(np.float32)
        y = np.concatenate([
            ties, np.nextafter(ties, np.float32(np.inf)),
            np.nextafter(ties, np.float32(-np.inf)),
            (rng.uniform(-130, 130, 200) * np.float64(s)).astype(np.float32),
            np.float32([0.0, -0.0])])
        # RN32 of the float64 quotient is RN32(y / s): double rounding of a
        # quotient of 24-bit numbers through 53 bits is innocuous
        want = (y.astype(np.float64) / np.float64(s)).astype(np.float32)
        r = np.float32(1.0 / np.float64(s))
        q0 = (y.astype(np.float64) * np.float64(r)).astype(np.float32)
        # the FMA's remainder: exact in float64 (Sterbenz), rounded once
        rem = (y.astype(np.float64) - q0.astype(np.float64)
               * np.float64(s)).astype(np.float32)
        got = np.array([_rn32(Fraction(float(a)) + Fraction(float(e))
                              * Fraction(float(r)))
                        for a, e in zip(q0, rem)], np.float32)
        assert np.array_equal(got, want), s
        assert np.array_equal(np.clip(np.rint(got), -127, 127),
                              np.clip(np.rint(want), -127, 127))
        n += y.size
    assert n == 36 * (3 * 256 + 202)
