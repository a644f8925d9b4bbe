"""The port's H-space-to-depth layout (insarseg_torch/models/unet_s2d.py and
the s2d branches of unet_int8.py) against the JAX package's: weight
transforms and packed trees bit for bit, the f32 s2d graph within
1e-4 x max|logit| of JAX's and of the port module, the int8 tree's codes
equal and scales within rtol 1e-5, and the int8 forward on a JAX-packed
s2d tree within 2e-2 x max|logit| with argmax agreement >= 99.5% (the bf16
head rounds at other places in the two frameworks), and each decoder level
(K6's plain version) on JAX's own decoder inputs: the bf16 transposed conv
within one bf16 ulp and the concat codes equal up to a counted handful."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.models import unet_int8 as J
from insarseg.models import unet_s2d as JS
from insarseg.ops.quant import requant as jax_requant
from insarseg_torch.kernels import (
    maxpool_exit_s2d_i8,
    pack_up_weight,
    up_concat_i8,
)
from insarseg_torch.kernels.up_i8 import up_bf16_plain
from insarseg_torch.models import unet_int8 as T
from insarseg_torch.models import unet_s2d as TS
from insarseg_torch.models.unet import UNet
from insarseg_torch.ops.layers import nchw_to_nhwc, nhwc_to_nchw
from tests.test_torch_common import (
    CPU,
    assert_packed_equal,
    flat,
    make_pair,
    numpy_tree,
    smooth,
)
from tests.test_torch_kernels import assert_codes_equal

HW = 64


def _jit(fn, *args, **kw):
    """An f32 function of the JAX package, jitted over its last argument
    (one XLA compile instead of one per eager op: ~10x sooner on the
    CPU)."""
    return jax.jit(functools.partial(fn, *args, **kw))


@pytest.fixture(scope="module", params=[True, False], ids=["se", "plain"])
def pair(request):
    jm, v, tm = make_pair(use_se=request.param, hw=HW)
    x = smooth(np.random.default_rng(40), (2, HW, HW, 1))
    return jm, v, tm, x


@pytest.fixture(scope="module")
def int8_setup():
    """A CA pair, calibration batches and the JAX package's s2d int8 tree
    (packed once: its calibration replay is a jit compile)."""
    jm, v, tm = make_pair(use_se=True, hw=HW)
    rng = np.random.default_rng(41)
    calib = [smooth(rng, (2, HW, HW, 1)) for _ in range(2)]
    tree = J.pack_unet_int8(v, [jnp.asarray(c) for c in calib], s2d=True)
    return v, tm, calib, tree


@pytest.mark.parametrize("layout,c", [("identity", 1), ("identity", 16),
                                      ("concat", 16)])
def test_s2d_conv_kernel_equals_jax(layout, c):
    rng = np.random.default_rng(c)
    cin = 2 * c if layout == "concat" else c
    w = rng.normal(0, 1, (3, 3, cin, 8)).astype(np.float32)
    lay = (TS._concat_layout(c) if layout == "concat"
           else TS._identity_layout(c))
    jlay = (JS._concat_layout(c) if layout == "concat"
            else JS._identity_layout(c))
    for a, b in zip(lay, jlay):
        np.testing.assert_array_equal(a, b)
    got = TS.s2d_conv3x3_kernel(w, *lay)
    want = JS.s2d_conv3x3_kernel(w, *jlay)
    assert got.shape == want.shape == (3, 3, len(lay[0]), 16)
    np.testing.assert_array_equal(got, want)


def test_pack_s2d_equals_jax(pair):
    _, v, tm, _ = pair
    ours = dict(flat(TS.pack_unet_s2d(tm.state_dict())))
    ref = dict(flat(JS.pack_unet_s2d(v)))
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        if r is None or isinstance(r, int):
            assert ours[k] == r, k
            continue
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(r),
                                      err_msg=k)


def test_s2d_apply_matches_jax_and_module(pair):
    jm, v, tm, x = pair
    jpacked = JS.pack_unet_s2d(v)
    want = np.asarray(_jit(JS.unet_s2d_apply, jpacked)(x))
    packed = TS.pack_unet_s2d(tm.state_dict())
    got = TS.unet_s2d_apply(packed, torch.from_numpy(x)).numpy()
    with torch.no_grad():
        module = nchw_to_nhwc(tm(nhwc_to_nchw(torch.from_numpy(x)))).numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (2, HW, HW, 2)
    assert np.abs(got - want).max() <= 1e-4 * scale
    assert np.abs(got - module).max() <= 1e-4 * scale
    cls = TS.unet_s2d_apply(packed, torch.from_numpy(x), argmax=True)
    want_cls = np.asarray(_jit(JS.unet_s2d_apply, jpacked, argmax=True)(x))
    assert cls.dtype == torch.int32 and cls.shape == (2, HW, HW)
    np.testing.assert_array_equal(cls.numpy(), got.argmax(-1))
    assert np.mean(cls.numpy() == want_cls) >= 0.999


def test_s2d_predict_fn_rectangular(pair):
    _, _, tm, _ = pair
    x = smooth(np.random.default_rng(42), (1, 96, 64, 1))
    got = TS.make_s2d_predict_fn(tm.state_dict(), device=CPU)(x).numpy()
    with torch.no_grad():
        want = nchw_to_nhwc(tm(nhwc_to_nchw(torch.from_numpy(x)))).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_pack_s2d_refuses_sa():
    sd = UNet(base_features=16, use_sa=True).state_dict()
    with pytest.raises(ValueError, match="SA"):
        TS.pack_unet_s2d(sd)


def test_up4_s2d_matches_jax():
    rng = np.random.default_rng(43)
    f = 8
    y = rng.normal(0, 1, (2, 4, 6, 2 * f)).astype(np.float32)
    k = rng.normal(0, 1, (1, 2, 2 * f, 2 * f)).astype(np.float32)
    bias = rng.normal(0, 1, 2 * f).astype(np.float32)
    for b in (bias, None):
        want = np.asarray(JS._up4_s2d(jnp.asarray(y), jnp.asarray(k),
                                      None if b is None else jnp.asarray(b)))
        got = TS._up4_s2d(nhwc_to_nchw(torch.from_numpy(y)),
                          torch.from_numpy(k),
                          None if b is None else torch.from_numpy(b))
        got = nchw_to_nhwc(got).numpy()
        assert got.shape == want.shape == (2, 4, 12, 2 * f)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("w", [8, 9])
def test_maxpool_exit_s2d_matches_jax(w):
    rng = np.random.default_rng(44 + w)
    x = rng.normal(0, 1, (2, 3, w, 32)).astype(np.float32)
    want = np.asarray(JS._maxpool_exit_s2d(jnp.asarray(x)))
    got = nchw_to_nhwc(TS._maxpool_exit_s2d(
        nhwc_to_nchw(torch.from_numpy(x)))).numpy()
    np.testing.assert_array_equal(got, want)
    q = rng.integers(-128, 128, (2, 3, w, 32)).astype(np.int8)
    want_q = np.asarray(JS._maxpool_exit_s2d(jnp.asarray(q)))
    got_q = maxpool_exit_s2d_i8(torch.from_numpy(q))
    assert got_q.dtype == torch.int8 and got_q.shape == (2, 3, w // 2, 16)
    np.testing.assert_array_equal(got_q.numpy(), want_q)


def test_h_s2d_round_trip_matches_jax():
    x = np.random.default_rng(45).normal(0, 1, (2, 6, 4, 3)) \
        .astype(np.float32)
    got = TS._h_s2d(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JS._h_s2d(jnp.asarray(x))))
    np.testing.assert_array_equal(TS._h_d2s(got, 3).numpy(), x)


def test_pack_int8_s2d_equals_jax(int8_setup):
    _, tm, calib, tree = int8_setup
    ours = T.pack_unet_int8(tm.state_dict(), calib, device=CPU)
    assert ours["s2d"] is True and ours["inc"]["c1"]["q"].shape == (
        3, 3, 2, 32)
    assert_packed_equal(ours, tree)


def test_int8_level1_codes_match_jax(int8_setup):
    """On the JAX-packed tree: the codes after inc (K1 twice, the s2d SE
    tail) and after the s2d max-pool exit (K3s) equal JAX's."""
    _, _, _, tree = int8_setup
    x = smooth(np.random.default_rng(46), (2, HW, HW, 1))
    xq = np.array(jax_requant(JS._h_s2d(jnp.asarray(x)), tree["in_s"]))
    want = np.array(J._dc_i8(tree["inc"], jnp.asarray(xq), s2d=True))
    port = T.prepare_int8(numpy_tree(tree), CPU)
    got = T._dc_i8(port["inc"], torch.from_numpy(xq), s2d=True)
    assert got.dtype == torch.int8 and got.shape == (2, HW // 2, HW, 32)
    assert_codes_equal(got.numpy(), want, "inc (s2d)")
    np.testing.assert_array_equal(
        maxpool_exit_s2d_i8(torch.from_numpy(want)).numpy(),
        np.asarray(JS._maxpool_exit_s2d(jnp.asarray(want))))


def test_int8_apply_on_jax_s2d_tree_matches_jax(int8_setup):
    _, _, _, tree = int8_setup
    x = smooth(np.random.default_rng(47), (4, HW, HW, 1))
    # op by op: JAX's jitted graph rounds the fused bf16 ops elsewhere
    want = np.asarray(J.unet_int8_apply(tree, jnp.asarray(x))) \
        .astype(np.float32)
    port = T.prepare_int8(numpy_tree(tree), CPU)
    got = T.unet_int8_apply(port, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    agree = np.mean(got.argmax(-1) == want.argmax(-1))
    print(f"int8 s2d port vs jax: max rel err {rel:.3g}, argmax {agree:.5f}")
    assert rel <= 2e-2, rel
    assert agree >= 0.995, agree
    cls = T.unet_int8_apply(port, torch.from_numpy(x), argmax=True)
    assert cls.dtype == torch.int32 and cls.shape == (4, HW, HW)
    np.testing.assert_array_equal(cls.numpy(), got.argmax(-1))
    want_cls = np.asarray(J.unet_int8_apply(tree, jnp.asarray(x),
                                            argmax=True))
    assert np.mean(cls.numpy() == want_cls) >= 0.995


def test_int8_s2d_predict_checks_h(int8_setup):
    _, _, _, tree = int8_setup
    predict = T.make_int8_predict_fn(T.prepare_int8(numpy_tree(tree), CPU))
    with pytest.raises(ValueError, match="H divisible by 32"):
        predict(np.zeros((1, 48, 64, 1), np.float32))


def _bf16_torch(a):
    """A JAX bf16 array -> the same bits as a torch bf16 tensor."""
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


def _jax_up_levels(tree, x):
    """JAX's op-by-op int8 graph (``insarseg/models/unet_int8.py::
    unet_int8_apply``) on ``tree``, level by level: for up1-4 its bf16
    decoder input y, the skip codes, the bf16 transposed conv z (lines 347
    and 355-356) and its codes zq (lines 348 and 357)."""
    s2d = tree["s2d"]
    xq = jax_requant(JS._h_s2d(x) if s2d else x, tree["in_s"])
    x1 = J._dc_i8(tree["inc"], xq, s2d=s2d)
    y = JS._maxpool_exit_s2d(x1) if s2d else J._maxpool_i8(x1)
    skips = {"l1": x1}
    for i in range(1, 5):
        y = J._dc_i8(tree[f"down{i}"], y, s2d=False)
        skips[f"l{i + 1}"] = y
        if i < 4:
            y = J._maxpool_i8(y)
    levels = []
    for i, skip in ((1, "l4"), (2, "l3"), (3, "l2"), (4, "l1")):
        up = tree[f"up{i}"]
        conv_t = JS._up4_s2d if s2d and i == 4 else JS._conv_transpose_k2s2
        z = conv_t(y, up["k"], up["bias"])
        zq = jax_requant(z.astype(jnp.float32), up["cat_s"])
        levels.append((y, skips[skip], z, zq))
        if i < 4:
            y = J._dc_i8(tree[f"conv{i}"],
                         jnp.concatenate([skips[skip], zq], -1), s2d=False)
    return levels


@pytest.fixture(scope="module")
def up_levels(int8_setup):
    """JAX's decoder levels on the H-s2d tree and on a standard-layout tree
    of the same weights and calibration batches."""
    v, _, calib, tree = int8_setup
    std = J.pack_unet_int8(v, [jnp.asarray(c) for c in calib], s2d=False)
    x = jnp.asarray(smooth(np.random.default_rng(48), (4, HW, HW, 1)))
    return {"s2d": (numpy_tree(tree), _jax_up_levels(tree, x)),
            "standard": (numpy_tree(std), _jax_up_levels(std, x))}


@pytest.mark.parametrize("layout,level", [("s2d", 1), ("s2d", 2),
                                          ("s2d", 3), ("s2d", 4),
                                          ("standard", 4)])
def test_k6_plain_matches_jax_up_level(up_levels, layout, level):
    """K6's plain version on JAX's decoder input y of one level against
    JAX's lines 347-348 (up1-3) / 355-357 (up4, H-s2d or standard): the
    bf16 z within one bf16 ulp (the f32 sums run in other orders), the
    codes equal up to a counted handful of |delta| = 1, the skip's codes
    copied in front. Measured here: 0 differing z and 0 differing codes
    at every level."""
    tree, levels = up_levels[layout]
    y, skip, z, zq = levels[level - 1]
    up = tree[f"up{level}"]
    s2d = layout == "s2d" and level == 4
    w = pack_up_weight(torch.from_numpy(np.array(up["k"])), s2d)
    bias = None if up["bias"] is None else \
        torch.from_numpy(np.array(up["bias"])).to(torch.bfloat16)
    yt, skip = _bf16_torch(y), np.array(skip)
    got = up_concat_i8(yt, w, bias, torch.from_numpy(skip), up["cat_s"],
                       s2d).numpy()
    cs = skip.shape[-1]
    assert got.shape == skip.shape[:3] + (cs + np.asarray(zq).shape[-1],)
    np.testing.assert_array_equal(got[..., :cs], skip)
    zt = up_bf16_plain(yt, w, bias, s2d).float().numpy()
    zj = np.asarray(z).astype(np.float32)
    ulp = np.maximum(np.spacing(np.abs(zj)) * 2.0 ** 16,
                     np.float32(2.0 ** -133))  # bf16: 16 fewer bits
    print(f"K6 {layout} up{level}: {np.count_nonzero(zt != zj)} of "
          f"{zj.size} bf16 z differ")
    assert np.all(np.abs(zt - zj) <= ulp)
    assert_codes_equal(got[..., cs:], np.asarray(zq), f"K6 {layout} "
                       f"up{level} codes")
