"""Port int8 primitives (insarseg_torch/ops/quant.py) against the JAX
package's insarseg/ops/quant.py: equal weight codes, half-to-even requant
ties, equal calibration statistics (absmax and the p99.9 percentile, the
latter also above 2^24 elements, where torch.quantile refuses)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.ops import quant as jq
from insarseg_torch.ops import quant as tq


def test_quant_weight_codes_equal():
    k = np.random.default_rng(0).normal(0, 0.05, (3, 3, 16, 32)) \
        .astype(np.float32)
    k[..., 3] = 0.0  # an all-zero output channel hits the 1e-12 floor
    ours, ref = tq.quant_weight(torch.from_numpy(k)), jq.quant_weight(k)
    np.testing.assert_array_equal(ours["q"], ref["q"])
    np.testing.assert_array_equal(ours["ws"], ref["ws"])
    assert tq.absmax_to_scale(3.5) == jq.absmax_to_scale(3.5)


def test_requant_rounds_ties_half_to_even():
    s = 0.25
    y = np.array([0.125, 0.375, 0.625, -0.125, -0.375, 31.875, 40.0, -40.0],
                 np.float32)  # y/s = .5, 1.5, 2.5, -.5, -1.5, 127.5, sat
    got = tq.requant(torch.from_numpy(y), s).numpy()
    np.testing.assert_array_equal(got, [0, 2, 2, 0, -2, 127, 127, -127])
    np.testing.assert_array_equal(got, np.asarray(jq.requant(jnp.asarray(y),
                                                             s)))
    assert got.dtype == np.int8


@pytest.mark.parametrize("stat", ["absmax", "p99.9", "p99"])
def test_calib_stat_matches_jnp(stat):
    t = np.random.default_rng(1).standard_normal((2, 17, 19, 5)) \
        .astype(np.float32)
    got = float(tq.calib_stat_fn(stat)(torch.from_numpy(t)))
    want = float(jq.calib_stat_fn(stat)(jnp.asarray(t)))
    assert got == pytest.approx(want, rel=1e-6, abs=0), (got, want)


def test_calib_percentile_above_2p24_elements():
    n = (1 << 24) + 4099
    t = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(t), 0.999)
    got = float(tq.calib_stat_fn("p99.9")(torch.from_numpy(t)))
    want = float(jq.calib_stat_fn("p99.9")(jnp.asarray(t)))
    assert got == pytest.approx(want, rel=1e-6, abs=0), (got, want)


@pytest.mark.parametrize("bad", ["p999", "p40", "median"])
def test_calib_stat_rejects_bad_names(bad):
    with pytest.raises(ValueError):
        tq.calib_stat_fn(bad)
