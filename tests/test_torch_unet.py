"""Port module forward (insarseg_torch UNet) against the JAX package's
``UNet.apply(train=False)`` on the same weights and inputs: <=1e-4 in f32,
the JAX package's own torch-parity bar."""

import numpy as np
import pytest
import torch

from insarseg_torch.ops.layers import nchw_to_nhwc, nhwc_to_nchw
from tests.test_torch_common import CPU, make_pair, smooth
from insarseg_torch.parallel.inference import make_predict_fn


@pytest.mark.parametrize("use_se,hw", [
    (True, (32, 32)),
    (False, (32, 48)),
    # 40x72 pools to odd sizes (5x9 at level 4), so the CA decoder's
    # bilinear shape fix fires at every level but the first
    (True, (40, 72)),
])
def test_module_forward_matches_jax(use_se, hw):
    jm, v, tm = make_pair(use_se=use_se)
    x = smooth(np.random.default_rng(1), (2,) + hw + (1,))
    want = np.asarray(jm.apply(v, x, train=False))
    with torch.no_grad():
        got = nchw_to_nhwc(tm(nhwc_to_nchw(torch.from_numpy(x)))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_predict_fn_argmax_and_bf16_input():
    jm, v, tm = make_pair(use_se=True)
    x = smooth(np.random.default_rng(2), (2, 32, 32, 1))
    logits = make_predict_fn(tm, device=CPU)(x)
    cls = make_predict_fn(tm, argmax=True, device=CPU)(x)
    assert cls.dtype == torch.int32 and cls.shape == (2, 32, 32)
    np.testing.assert_array_equal(cls.numpy(), logits.argmax(-1).numpy())
    bf = make_predict_fn(tm, input_dtype=torch.bfloat16, device=CPU)(x)
    assert bf.dtype == torch.bfloat16
    agree = (bf.float().argmax(-1) == logits.argmax(-1)).float().mean()
    assert float(agree) >= 0.98, float(agree)
