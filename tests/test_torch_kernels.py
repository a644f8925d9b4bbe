"""Plain versions of the int8 kernels K1-K3 (insarseg_torch/kernels)
against the JAX functions they replace, on identical int8 codes:
K1 vs ``_conv_i8``, K1+K2 vs ``_dc_i8`` (the SE tail, both exits), K3 vs
``_maxpool_i8``. Codes must be equal; at most a counted handful of
rounding ties (<= 1e-5 of the elements, |delta| = 1) may differ.

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


@pytest.mark.parametrize("cin", [1, 16])
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
def test_k2_se_tail_matches_dc_i8(cin, se_out_s):
    """K1 twice, then the SE tail: squeeze (K2), torch MLP, excite (K2)
    with the requant exit (se_out_s set) or the bf16 exit."""
    rng = np.random.default_rng(10 + cin)
    blk = _dc_blk(rng, cin, 32, se_out_s)
    x = _codes(rng, (3, 32, 32, cin))
    want = np.asarray(J._dc_i8(blk, jnp.asarray(x), s2d=False))
    pb = {k: _port_blk(v) if k in ("c1", "c2") else v
          for k, v in to_torch_tree(blk, CPU).items()}
    got = T._dc_i8(pb, torch.from_numpy(x))
    if se_out_s is None:
        assert got.dtype == torch.bfloat16
        assert_codes_equal(_bf16_np(got), want, f"K2 cin={cin} bf16")
    else:
        assert got.dtype == torch.int8
        assert_codes_equal(got.numpy(), want, f"K2 cin={cin} int8")


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
