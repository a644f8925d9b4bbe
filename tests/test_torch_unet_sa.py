"""The port's U-Net-SA (spatial attention after each decoder concat)
against the JAX package's ``UNet(use_sa=True)``, on one set of weights:
module and serve within 1e-4 in f32, the folded and int8 trees equal
(codes equal, scales within rtol 1e-5), the gate on int8 codes (K4a / K4b
plain versions) against ``_sa_gate_i8`` with at most 1e-3 of the codes one
step apart (the channel mean is summed in another order, which can move
the f32 gate by an ulp and flip a rounding tie), and the int8 forward on a
JAX-packed SA tree within 2e-2 x max|logit| of JAX's and correlated > 0.98
with the f32 module (the JAX package's SA bar)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.engines import engine_from_artifact as jax_from_artifact
from insarseg.engines import make_engine as jax_make_engine
from insarseg.engines import pack_engine as jax_pack_engine
from insarseg.engines_io import load_artifact as jax_load
from insarseg.engines_io import save_artifact as jax_save
from insarseg.models import unet_int8 as J
from insarseg.models.unet_serve import pack_unet_serve as jax_pack_serve
from insarseg.models.unet_serve import unet_serve_apply as jax_serve_apply
from insarseg_torch.engines import (
    engine_from_artifact,
    make_engine,
    pack_engine,
)
from insarseg_torch.engines_io import load_artifact, save_artifact, to_torch_tree
from insarseg_torch.models import unet_int8 as T
from insarseg_torch.models.registry import build
from insarseg_torch.models.unet_serve import (
    make_serve_predict_fn,
    pack_unet_serve,
    unet_serve_apply,
)
from insarseg_torch.ops.layers import nchw_to_nhwc, nhwc_to_nchw
from tests.test_torch_common import (
    CPU,
    assert_packed_equal,
    flat,
    make_pair,
    numpy_tree,
    smooth,
)

HW = 32


def _jit(fn, *args, **kw):
    """An f32 function of the JAX package, jitted over its last argument
    (one XLA compile instead of one per eager op: ~10x sooner on the
    CPU)."""
    return jax.jit(functools.partial(fn, *args, **kw))


@pytest.fixture(scope="module")
def sa():
    """An SA pair, an input batch, calibration batches and the JAX
    package's int8 SA tree (standard layout, packed once)."""
    jm, v, tm = make_pair(use_se=False, use_sa=True, hw=HW)
    rng = np.random.default_rng(50)
    x = smooth(rng, (2, HW, HW, 1))
    calib = [smooth(rng, (2, HW, HW, 1)) for _ in range(2)]
    tree = J.pack_unet_int8(v, [jnp.asarray(c) for c in calib], s2d=False)
    return jm, v, tm, x, calib, tree


def _module(tm, x):
    with torch.no_grad():
        return nchw_to_nhwc(tm(nhwc_to_nchw(torch.from_numpy(x)))).numpy()


def test_registry_builds_sa_unet():
    m = build("unet", "spatial")
    assert m.use_sa and not m.use_se and not m.shape_fix
    assert "sa4.compress_and_map.double_conv.0.weight" in m.state_dict()


@pytest.mark.parametrize("hw", [(32, 32), (32, 48)])
def test_sa_module_matches_jax(sa, hw):
    jm, v, tm, _, _, _ = sa
    x = smooth(np.random.default_rng(51), (2,) + hw + (1,))
    want = np.asarray(_jit(jm.apply, v, train=False)(x))
    got = _module(tm, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_pack_sa_serve_equals_jax(sa):
    _, v, tm, _, _, _ = sa
    ours = dict(flat(pack_unet_serve(tm.state_dict())))
    ref = dict(flat(jax_pack_serve(v)))
    assert sorted(ours) == sorted(ref)
    assert "sa1.k1" in ref and ref["sa1.k1"].shape == (3, 3, 2, 1)
    for k, r in ref.items():
        if r is None:
            assert ours[k] is None, k
            continue
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(r),
                                      err_msg=k)


def test_sa_serve_matches_jax(sa):
    _, v, tm, x, _, _ = sa
    want = np.asarray(_jit(jax_serve_apply, jax_pack_serve(v))(x))
    packed = pack_unet_serve(tm.state_dict())
    got = unet_serve_apply(packed, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, _module(tm, x), rtol=0, atol=1e-4)
    cls = unet_serve_apply(packed, torch.from_numpy(x), argmax=True)
    np.testing.assert_array_equal(cls.numpy(), got.argmax(-1))


def test_sa_serve_bf16_input_argmax_agreement(sa):
    _, v, tm, x, _, _ = sa
    want = np.asarray(_jit(jax_serve_apply, jax_pack_serve(v))(
        jnp.asarray(x).astype(jnp.bfloat16)))
    got = make_serve_predict_fn(to_torch_tree(pack_unet_serve(
        tm.state_dict()), CPU), input_dtype=torch.bfloat16)(x)
    assert got.dtype == torch.bfloat16
    agree = float(np.mean(got.float().numpy().argmax(-1)
                          == want.astype(np.float32).argmax(-1)))
    assert agree >= 0.99, agree


@pytest.mark.parametrize("c", [32, 64])
def test_k4_plain_pair_matches_sa_gate_i8(sa, c):
    """K4a's and K4b's plain versions around the f32 gate convs
    (``T._sa_gate_i8``) against ``J._sa_gate_i8`` on the same codes and
    the same folded gate params."""
    _, _, _, _, _, tree = sa
    pk = numpy_tree(tree)["sa1"]
    rng = np.random.default_rng(52 + c)
    q = rng.integers(-127, 128, (2, 16, 24, c)).astype(np.int8)
    cat_s = 0.0173
    want = np.asarray(J._sa_gate_i8(pk, jnp.asarray(q), cat_s))
    got = T._sa_gate_i8(to_torch_tree(pk, CPU), torch.from_numpy(q), cat_s)
    assert got.dtype == torch.int8 and got.shape == q.shape
    diff = got.numpy().astype(np.int32) - want.astype(np.int32)
    n_bad = int(np.count_nonzero(diff))
    print(f"K4 gate c={c}: {n_bad} of {diff.size} codes differ")
    assert n_bad <= 1e-3 * diff.size, n_bad
    assert np.abs(diff).max() <= 1
    assert np.mean(np.abs(got.numpy()) < np.abs(q)) > 0.5  # gated down


def test_pack_int8_sa_equals_jax(sa):
    _, _, tm, _, calib, tree = sa
    ours = T.pack_unet_int8(tm.state_dict(), calib, s2d=False, device=CPU)
    assert "sa1" in ours and "sa4" in ours and ours["s2d"] is False
    assert_packed_equal(ours, tree)


def test_pack_int8_sa_refuses_s2d(sa):
    _, _, tm, _, calib, _ = sa
    with pytest.raises(ValueError, match="SA"):
        T.pack_unet_int8(tm.state_dict(), calib, s2d=True, device=CPU)


def test_int8_apply_on_jax_sa_tree(sa):
    _, _, tm, _, _, tree = sa
    x = smooth(np.random.default_rng(53), (4, HW, HW, 1))
    # op by op: JAX's jitted graph rounds the fused bf16 ops elsewhere
    want = np.asarray(J.unet_int8_apply(tree, jnp.asarray(x))) \
        .astype(np.float32)
    port = T.prepare_int8(numpy_tree(tree), CPU)
    got = T.unet_int8_apply(port, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    f32 = _module(tm, x)  # within 1e-4 of JAX's (test_sa_module_...)
    rel = np.abs(got - want).max() / np.abs(want).max()
    corr = np.corrcoef(got.ravel(), f32.ravel())[0, 1]
    print(f"int8 SA port vs jax: max rel err {rel:.3g}; corr with f32 "
          f"module {corr:.5f}")
    assert rel <= 2e-2, rel
    assert corr > 0.98, corr
    cls = T.unet_int8_apply(port, torch.from_numpy(x), argmax=True)
    np.testing.assert_array_equal(cls.numpy(), got.argmax(-1))


@pytest.mark.parametrize("engine", ["module", "serve", "int8"])
def test_make_engine_sa_agrees_on_cpu(sa, engine):
    _, _, tm, x, calib, _ = sa
    got = make_engine("unet", "spatial", tm, None, engine,
                      calib_batches=calib, device=CPU)(x).float().numpy()
    want = _module(tm, x)
    assert got.shape == want.shape
    if engine == "int8":
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.98
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_serves_jax_sa_int8_artifact(tmp_path, sa):
    jm, v, _, x, calib, _ = sa
    art = jax_pack_engine("unet", "spatial", jm, v, "int8",
                          calib_batches=[jnp.asarray(c) for c in calib])
    assert art["tree"]["s2d"] is False and "sa1" in art["tree"]
    path = jax_save(str(tmp_path / "sa_int8"), art)
    want = np.asarray(jax_from_artifact(jax_load(path))(jnp.asarray(x)))
    got = engine_from_artifact(load_artifact(path), device=CPU)(x)
    got, want = got.float().numpy(), want.astype(np.float32)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.995


@pytest.mark.parametrize("engine", ["serve", "int8"])
def test_port_sa_artifact_serves_in_jax(tmp_path, sa, engine):
    jm, v, tm, x, calib, _ = sa
    calib = calib if engine == "int8" else None
    art = pack_engine("unet", "spatial", tm, None, engine,
                      calib_batches=calib, device=CPU)
    path = save_artifact(str(tmp_path / engine), art)
    ours = make_engine("unet", "spatial", tm, None, engine,
                       calib_batches=calib, device=CPU)(x).float().numpy()
    back = engine_from_artifact(load_artifact(path), device=CPU)(x)
    np.testing.assert_array_equal(back.float().numpy(), ours)
    theirs = np.asarray(jax_from_artifact(jax_load(path))(jnp.asarray(x))) \
        .astype(np.float32)
    if engine == "serve":
        want = np.asarray(jax_make_engine("unet", "spatial", jm, v, "serve")(
            jnp.asarray(x)))
        np.testing.assert_allclose(theirs, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(theirs, ours, rtol=0, atol=1e-4)
    else:
        assert np.abs(theirs - ours).max() <= 2e-2 * np.abs(theirs).max()
        assert np.mean(theirs.argmax(-1) == ours.argmax(-1)) >= 0.995
