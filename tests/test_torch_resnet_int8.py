"""Port int8 DeepLabV3 / FCN engine and the plain versions of its kernels
against the JAX package (``insarseg/models/resnet_int8.py``), every
attention cell at full ResNet-50 widths and 32^2:

- K5a plain version vs ``_conv_i8`` (plus the residual add of
  ``_block_i8``) and K5b plain version vs the SE tail of ``_block_i8``, on
  identical int8 codes: 0 differing codes, f32 exits equal;
- int8 pack: codes equal, scales within rtol 1e-5 (the calibration
  replays are two f32 graphs);
- backbone codes: from the same stem codes, the port's ``_block_i8`` chain
  over a JAX-packed tree against the JAX package's, after layer4: 0
  differing codes without SE; with SE (FCN-CA) the gate's f32 matmul sums
  in another order, so a few codes may differ by one (at most 1e-3 of
  them, none by more);
- end logits on a JAX-packed tree within 2e-2 x max|logit| with argmax
  agreement >= 99.5% (the bf16 stem, heads and classifier round at other
  places in the two frameworks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.models import resnet_int8 as J
from insarseg.models.resnet_serve import _ca as jax_ca
from insarseg.ops.layers import max_pool_2d as jax_max_pool
from insarseg.ops.quant import requant as jax_requant
from insarseg_torch.engines_io import to_torch_tree
from insarseg_torch.kernels import (
    conv_i8,
    repack_conv_weight,
    se_residual_i8,
)
from insarseg_torch.models import resnet_int8 as T
from insarseg_torch.models.resnet_serve import block_chain
from insarseg_torch.ops.quant import quant_weight
from tests.test_torch_common import (
    CPU,
    RESNET_CELLS,
    assert_packed_equal,
    make_resnet_pair,
    numpy_tree,
    smooth,
)


def _codes(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _conv_pack(rng, k, cin, cout, out_s, relu):
    """A JAX-format int8 conv pack whose epilogue spans the int8 range."""
    q = quant_weight(rng.normal(0, 1, (k, k, cin, cout)))["q"]
    acc_sd = 127.0 * 127.0 * np.sqrt(k * k * cin) / 3
    mult = (rng.uniform(0.5, 1.5, cout) * 60 / acc_sd).astype(np.float32)
    off = rng.normal(0, 10, cout).astype(np.float32)
    if out_s is not None:
        mult *= out_s
        off *= out_s
    return {"q": q, "mult": mult, "off": off, "out_s": out_s, "relu": relu}


def _port_args(c):
    t = to_torch_tree(c, CPU)
    return t["q"], (repack_conv_weight(t["q"]), t["mult"], t["off"])


def _np_codes(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


GEOMETRY = [(3, 1, 1), (3, 2, 1), (3, 1, 2), (3, 1, 4), (3, 1, 12),
            (3, 1, 36), (1, 1, 1), (1, 2, 1)]


@pytest.mark.parametrize("k,stride,dilation", GEOMETRY,
                         ids=[f"k{k}s{s}d{d}" for k, s, d in GEOMETRY])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("exit_", ["s8", "f32", "bf16"])
def test_k5a_plain_matches_conv_i8(k, stride, dilation, relu, exit_):
    """Dilation 12 and 36 exceed the 10^2 map: most taps read padding."""
    rng = np.random.default_rng(k * 100 + stride * 10 + dilation)
    c = _conv_pack(rng, k, 24, 32, 0.5 if exit_ == "s8" else None, relu)
    x = _codes(rng, (2, 10, 10, 24))
    want = J._conv_i8(jnp.asarray(x), c, stride=stride, dilation=dilation)
    if exit_ == "bf16":
        want = want.astype(jnp.bfloat16)
    want = np.asarray(want.astype(jnp.float32) if exit_ == "bf16" else want)
    _, (w, mult, off) = _port_args(c)
    got = conv_i8(torch.from_numpy(x), w, mult, off, stride, dilation, relu,
                  c["out_s"], bf16=exit_ == "bf16")
    assert got.dtype == {"s8": torch.int8, "f32": torch.float32,
                         "bf16": torch.bfloat16}[exit_]
    np.testing.assert_array_equal(_np_codes(got), want)
    assert len(np.unique(want)) > 32  # the codes span a range


def _identity(rng, kind, shape):
    if kind == "s8":
        return _codes(rng, shape), 0.03
    return rng.normal(0, 2, shape).astype(np.float32), None


@pytest.mark.parametrize("idn_kind", ["s8", "f32"])
def test_k5a_residual_matches_block_tail(idn_kind):
    """conv3 + identity + ReLU + requant in K5a's epilogue against
    ``_block_i8``'s ``requant(relu(_conv_i8(t2, c3) + idn), out_s)``."""
    rng = np.random.default_rng(7)
    c3 = _conv_pack(rng, 1, 32, 64, None, False)
    t2 = _codes(rng, (2, 8, 8, 32))
    idn, in_s = _identity(rng, idn_kind, (2, 8, 8, 64))
    jidn = jnp.asarray(idn).astype(jnp.float32)
    if in_s is not None:
        jidn = jidn * in_s
    want = np.asarray(jax_requant(jnp.maximum(
        J._conv_i8(jnp.asarray(t2), c3) + jidn, 0.0), 0.04))
    _, (w, mult, off) = _port_args(c3)
    got = conv_i8(torch.from_numpy(t2), w, mult, off, relu=True, out_s=0.04,
                  idn=torch.from_numpy(idn), in_s=in_s)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < np.mean(want == 0) < 1


@pytest.mark.parametrize("idn_kind", ["s8", "f32"])
def test_k5b_plain_matches_se_tail(idn_kind):
    rng = np.random.default_rng(8)
    y3q = _codes(rng, (2, 8, 8, 64))
    gate = rng.uniform(0, 0.05, (2, 64)).astype(np.float32)
    idn, in_s = _identity(rng, idn_kind, (2, 8, 8, 64))
    jidn = jnp.asarray(idn).astype(jnp.float32)
    if in_s is not None:
        jidn = jidn * in_s
    y = jnp.asarray(y3q).astype(jnp.float32) * jnp.asarray(gate)[
        :, None, None, :] + jidn
    want = np.asarray(jax_requant(jnp.maximum(y, 0.0), 0.02))
    got = se_residual_i8(torch.from_numpy(y3q), torch.from_numpy(gate),
                         torch.from_numpy(idn), in_s, 0.02)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the engine, per cell
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=RESNET_CELLS,
                ids=[f"{m}-{a}" for m, a in RESNET_CELLS])
def cell(request):
    model, attention = request.param
    _, v, tm = make_resnet_pair(model, attention)
    rng = np.random.default_rng(40)
    calib = [smooth(rng, (2, 32, 32, 1)) for _ in range(2)]
    jtree = J.pack_resnet_int8(v, [jnp.asarray(c) for c in calib])
    np_tree = numpy_tree(jtree)
    x = smooth(rng, (2, 32, 32, 1))
    return model, attention, tm, calib, jtree, np_tree, x


def test_pack_int8_equals_jax(cell):
    _, _, tm, calib, jtree, _, _ = cell
    assert_packed_equal(T.pack_resnet_int8(tm.state_dict(), calib,
                                           device=CPU), jtree)


def test_backbone_codes_match_jax(cell):
    model, attention, _, _, jtree, np_tree, x = cell
    y = jax_ca(jnp.asarray(x, jnp.bfloat16), jtree["stem"], stride=2)
    y = jax_max_pool(y, 3, stride=2, padding=1)
    jq = jax_requant(y.astype(jnp.float32), jtree["stem_out_s"])
    pt = T.prepare_resnet_int8(np_tree, CPU)
    tq = torch.from_numpy(np.array(jq))
    for name in J._block_chain(jtree):
        jq = J._block_i8(jtree[name], jq)
    for name in block_chain(pt):
        tq = T._block_i8(pt[name], tq)
    want = np.asarray(jq).astype(np.int64)
    diff = tq.numpy().astype(np.int64) - want
    n_off = int(np.count_nonzero(diff))
    print(f"{model}-{attention} layer4 codes: {n_off} of {diff.size} differ"
          f" (max |delta| {np.abs(diff).max()})")
    assert 0 < np.mean(want != 0)  # the chain carries signal to layer4
    if model == "fcn" and attention == "channel":
        assert np.abs(diff).max() <= 1
        assert n_off <= 1e-3 * diff.size
    else:
        assert n_off == 0


def test_end_logits_match_jax(cell):
    *_, jtree, np_tree, x = cell
    want = np.asarray(J.resnet_int8_apply(jtree, jnp.asarray(x))) \
        .astype(np.float32)
    predict = T.make_resnet_int8_predict_fn(
        T.prepare_resnet_int8(np_tree, CPU))
    got = predict(x)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    agree = np.mean(got.argmax(-1) == want.argmax(-1))
    print(f"int8 port vs jax: max rel err {rel:.3g}, argmax {agree:.5f}")
    assert rel <= 2e-2, rel
    assert agree >= 0.995, agree
    cls = T.make_resnet_int8_predict_fn(T.prepare_resnet_int8(np_tree, CPU),
                                        argmax=True)(x)
    assert cls.dtype == torch.int32
    np.testing.assert_array_equal(cls.numpy(), got.argmax(-1))
