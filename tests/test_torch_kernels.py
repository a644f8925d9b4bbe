"""Plain versions of the int8 kernels K1-K4 (insarseg_torch/kernels)
against the JAX functions they replace, on identical int8 codes:
K1 vs ``_conv_i8``, K1+K2 vs ``_dc_i8`` (the SE tail, both exits, both
layouts), K3 vs ``_maxpool_i8``, K4a vs the channel mean / max inside
``_sa_gate_i8``. Codes must be equal; at most a counted handful of
rounding ties (<= 1e-5 of the elements, |delta| = 1) may differ. (K3s:
tests/test_torch_s2d.py; the whole K4 gate: tests/test_torch_unet_sa.py.)

The CUDA kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.models import unet_int8 as J
from insarseg_torch.engines_io import to_torch_tree
from insarseg_torch.kernels import (
    conv3x3_i8,
    maxpool2x2_i8,
    repack_conv_weight,
    sa_gate_i8,
    sa_stats_i8,
    se_excite_i8,
    se_squeeze_i8,
)
from insarseg_torch.models import unet_int8 as T
from insarseg_torch.ops.quant import quant_weight

CPU = torch.device("cpu")


def _codes(rng, shape, lo=-127):
    return rng.integers(lo, 128, shape).astype(np.int8)


def _conv_blk(rng, cin, cout, out_s):
    """A JAX-format conv block whose epilogue spans the int8 range."""
    q = quant_weight(rng.normal(0, 1, (3, 3, cin, cout)))["q"]
    acc_sd = 127.0 * 127.0 * np.sqrt(9 * cin) / 3
    mult = (rng.uniform(0.5, 1.5, cout) * 60 / acc_sd).astype(np.float32)
    off = rng.normal(0, 10, cout).astype(np.float32)
    if out_s is not None:
        mult *= out_s
        off *= out_s
    return {"q": q, "mult": mult, "off": off, "out_s": out_s}


def _port_blk(blk):
    t = to_torch_tree(blk, CPU)
    t["w"] = repack_conv_weight(t["q"])
    return t


def assert_codes_equal(got, want, what):
    """Equal up to a counted handful of |delta| = 1 rounding ties."""
    if got.dtype == np.dtype("bfloat16") or str(got.dtype) == "bfloat16":
        got, want = got.astype(np.float32), want.astype(np.float32)
    diff = got.astype(np.float64) - want.astype(np.float64)
    n_bad = int(np.count_nonzero(diff))
    print(f"{what}: {n_bad} of {diff.size} differ")
    assert n_bad <= int(1e-5 * diff.size), (what, n_bad)
    if n_bad:
        assert np.abs(diff).max() <= 1, (what, np.abs(diff).max())


def _bf16_np(t):
    return np.asarray(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))


@pytest.mark.parametrize("cin", [1, 2, 16, 40])
@pytest.mark.parametrize("exit_", ["int8", "bf16"])
def test_k1_plain_matches_conv_i8(cin, exit_):
    rng = np.random.default_rng(cin)
    blk = _conv_blk(rng, cin, 32, 0.5 if exit_ == "int8" else None)
    x = _codes(rng, (2, 24, 40, cin))
    want = np.asarray(J._conv_i8(jnp.asarray(x), blk))
    pb = _port_blk(blk)
    got = conv3x3_i8(torch.from_numpy(x), pb["w"], pb["mult"], pb["off"],
                     pb["out_s"])
    if exit_ == "int8":
        assert got.dtype == torch.int8
        assert_codes_equal(got.numpy(), want, f"K1 cin={cin} int8")
        assert 0 < np.mean(np.abs(want) == 127) < 0.5  # range is exercised
    else:
        assert got.dtype == torch.bfloat16
        assert_codes_equal(_bf16_np(got), want, f"K1 cin={cin} bf16")


def _dc_blk(rng, cin, c, se_out_s):
    blk = {"c1": _conv_blk(rng, cin, c, 0.5),
           "c2": _conv_blk(rng, c, c, 0.25),
           "fc1": rng.normal(0, 0.3, (c, c // 16)).astype(np.float32),
           "fc2": rng.normal(0, 0.3, (c // 16, c)).astype(np.float32),
           "se_pre_s": 0.25, "se_out_s": se_out_s}
    return blk


@pytest.mark.parametrize("cin", [1, 16])
@pytest.mark.parametrize("se_out_s", [0.2, None])
@pytest.mark.parametrize("s2d", [False, True])
def test_k2_se_tail_matches_dc_i8(cin, se_out_s, s2d):
    """K1 twice, then the SE tail: squeeze (K2), torch MLP, excite (K2)
    with the requant exit (se_out_s set) or the bf16 exit; in s2d the
    squeeze averages the two parity halves of 2C = 32 channels and the
    gain tiles over them."""
    rng = np.random.default_rng(10 + cin)
    blk = _dc_blk(rng, cin, 32, se_out_s)
    if s2d:  # the MLP takes C = 16 channels
        blk["fc1"] = blk["fc1"][:16]
        blk["fc2"] = blk["fc2"][:, :16]
    x = _codes(rng, (3, 32, 32, cin))
    want = np.asarray(J._dc_i8(blk, jnp.asarray(x), s2d=s2d))
    pb = {k: _port_blk(v) if k in ("c1", "c2") else v
          for k, v in to_torch_tree(blk, CPU).items()}
    got = T._dc_i8(pb, torch.from_numpy(x), s2d=s2d)
    if se_out_s is None:
        assert got.dtype == torch.bfloat16
        assert_codes_equal(_bf16_np(got), want, f"K2 cin={cin} bf16")
    else:
        assert got.dtype == torch.int8
        assert_codes_equal(got.numpy(), want, f"K2 cin={cin} int8")


@pytest.mark.parametrize("se_out_s", [0.2, None])
def test_k2_squeeze_past_2_24_matches_dc_i8(se_out_s):
    """An SE DoubleConv at 384^2 whose conv2 codes sit near +124, so each
    channel's sum (about 18.3 M) passes 2^24: K2's exact integer sum,
    rounded once to f32, against JAX's f32 ``mean`` (a few ulps apart),
    through the MLP to the excite. Measured: 0 codes differ, both
    exits."""
    rng = np.random.default_rng(3)
    blk = _dc_blk(rng, 16, 16, se_out_s)
    blk["c2"]["mult"] *= np.float32(0.02)
    blk["c2"]["off"] = np.full(16, 124 * 0.25, np.float32)
    x = _codes(rng, (1, 384, 384, 16))
    yq = J._conv_i8(J._conv_i8(jnp.asarray(x), blk["c1"]), blk["c2"])
    sums = np.asarray(yq).astype(np.int64).sum(axis=(1, 2))
    assert sums.min() > 2 ** 24
    want = np.asarray(J._dc_i8(blk, jnp.asarray(x), s2d=False))
    pb = {k: _port_blk(v) if k in ("c1", "c2") else v
          for k, v in to_torch_tree(blk, CPU).items()}
    got = T._dc_i8(pb, torch.from_numpy(x))
    if se_out_s is None:
        assert_codes_equal(_bf16_np(got), want, "SE past 2^24, bf16")
    else:
        assert_codes_equal(got.numpy(), want, "SE past 2^24, int8")


def test_k2_squeeze_and_excite_plain():
    rng = np.random.default_rng(5)
    q = _codes(rng, (2, 16, 8, 32))
    sums = se_squeeze_i8(torch.from_numpy(q))
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(),
                                  q.astype(np.int64).sum(axis=(1, 2)))
    gain = rng.uniform(0, 2, (2, 32)).astype(np.float32)
    got = se_excite_i8(torch.from_numpy(q), torch.from_numpy(gain)).numpy()
    want = np.clip(np.rint(q.astype(np.float32) * gain[:, None, None]),
                   -127, 127)
    np.testing.assert_array_equal(got, want)


def test_k3_plain_matches_maxpool_i8():
    rng = np.random.default_rng(6)
    x = _codes(rng, (2, 16, 24, 32), lo=-128)
    want = np.asarray(J._maxpool_i8(jnp.asarray(x)))
    got = maxpool2x2_i8(torch.from_numpy(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_k4a_plain_matches_jax_channel_stats():
    """K4a's [mean, max] against the f32 ``mean`` / ``max`` of the
    dequantized codes that ``_sa_sigmoid`` takes: the max bit for bit (a
    positive scale commutes with max), the mean up to the order of the sum
    (the plain version rounds once, after the exact integer sum)."""
    rng = np.random.default_rng(7)
    q = _codes(rng, (2, 8, 12, 96), lo=-128)
    s = 0.0231
    deq = jnp.asarray(q).astype(jnp.float32) * s
    got = sa_stats_i8(torch.from_numpy(q), s).numpy()
    assert got.shape == (2, 8, 12, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 1],
                                  np.asarray(jnp.max(deq, axis=-1)))
    np.testing.assert_allclose(got[..., 0], np.asarray(jnp.mean(deq, -1)),
                               rtol=1e-6, atol=1e-7)
    want_mean = (q.astype(np.int64).sum(-1).astype(np.float32)
                 * np.float32(s)) / np.float32(96)
    np.testing.assert_array_equal(got[..., 0], want_mean)


def test_k4b_plain_is_rint_of_gated_codes():
    rng = np.random.default_rng(8)
    q = _codes(rng, (2, 8, 12, 32))
    g = rng.uniform(0, 1, (2, 8, 12)).astype(np.float32)
    got = sa_gate_i8(torch.from_numpy(q), torch.from_numpy(g))
    assert got.dtype == torch.int8
    want = np.clip(np.rint(q.astype(np.float32) * g[..., None]), -127, 127)
    np.testing.assert_array_equal(got.numpy(), want)
