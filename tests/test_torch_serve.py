"""Port serve engine (BN folded, deferred SE gates) against the JAX
package's ``pack_unet_serve`` / ``unet_serve_apply`` on the same weights:
folded tree equal, logits <=1e-4 in f32, argmax agreement >= 99% for the
bf16-input path (bf16 rounds at other places in the two frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.models.unet_serve import pack_unet_serve as jax_pack
from insarseg.models.unet_serve import unet_serve_apply as jax_apply
from insarseg_torch.engines_io import to_torch_tree
from insarseg_torch.models.unet_serve import (
    make_serve_predict_fn,
    pack_unet_serve,
    unet_serve_apply,
)
from tests.test_torch_common import CPU, flat, make_pair, smooth


@pytest.mark.parametrize("use_se", [True, False])
def test_pack_serve_equals_jax(use_se):
    _, v, tm = make_pair(use_se=use_se)
    ours = dict(flat(pack_unet_serve(tm.state_dict())))
    ref = dict(flat(jax_pack(v)))
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        if r is None:
            assert ours[k] is None, k
            continue
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(r),
                                      err_msg=k)


@pytest.mark.parametrize("use_se", [True, False])
def test_serve_apply_matches_jax_f32(use_se):
    _, v, tm = make_pair(use_se=use_se)
    x = smooth(np.random.default_rng(3), (2, 32, 48, 1))
    want = np.asarray(jax_apply(jax_pack(v), jnp.asarray(x)))
    got = unet_serve_apply(pack_unet_serve(tm.state_dict()),
                           torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    cls = unet_serve_apply(pack_unet_serve(tm.state_dict()),
                           torch.from_numpy(x), argmax=True)
    assert cls.dtype == torch.int32
    np.testing.assert_array_equal(cls.numpy(), got.argmax(-1))


def test_serve_bf16_input_argmax_agreement():
    _, v, tm = make_pair(use_se=True)
    x = smooth(np.random.default_rng(4), (4, 32, 32, 1))
    want = np.asarray(jax_apply(jax_pack(v),
                                jnp.asarray(x).astype(jnp.bfloat16)))
    predict = make_serve_predict_fn(
        to_torch_tree(pack_unet_serve(tm.state_dict()), CPU),
        input_dtype=torch.bfloat16)
    got = predict(x)
    assert got.dtype == torch.bfloat16
    agree = float(np.mean(got.float().numpy().argmax(-1)
                          == want.astype(np.float32).argmax(-1)))
    assert agree >= 0.99, agree
