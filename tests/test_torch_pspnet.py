"""The port's true PSPNet (``insarseg_torch/models/pspnet.py`` and its serve
and int8 graphs) against the JAX package (``insarseg/models/pspnet.py``),
every attention cell at full ResNet-50 widths, on weights made with numpy
from a seed in the JAX package's parameter tree:

- ``adaptive_avg_pool_2d`` against JAX's on (H, O) in {(5, 6), (5, 3),
  (7, 3), (64, 6), (6, 6)}: f32 within 1e-6 x max|x| (torch's CPU
  cumsum accumulates in f64, XLA's in f32 in order: the integral images
  differ in their last bits), bf16 equal;
- the bridge ``pspnet_variables_to_torch`` loads with ``strict=True``;
- module f32 and serve f32 within 1e-4 x max|logit| of
  ``PSPNet.apply(train=False)`` and ``resnet_serve_apply`` at 40^2 (a 5x5
  backbone map: bins 2, 3 and 6 have variable and over-sized windows),
  and the JAX package's folded tree serves in the port unchanged;
- int8: the pack equal to the JAX package's (codes equal, scales within
  rtol 1e-5); from the same stem codes, the backbone codes after layer4
  equal to the JAX package's op-by-op ``_block_i8`` chain (with SE, a few
  may differ by one: the gate's f32 matmul sums in another order, at most
  1e-3 of them); the end logits within 2e-2 x max|logit| of the JAX
  package's op-by-op ``resnet_int8_apply``, argmax agreement >= 99.5%
  (the bf16 head rounds at other places in the two frameworks);
- format-1 serve and int8 artifacts written by the JAX package serve in
  the port (``engine_from_artifact``) within the same bars;
- the int8 engine's bf16 head (``pspnet_head_i8``, calls of a fixed
  number of tiles), at a narrow width, gives three tiles alone the
  logits it gives them among seven and among ten, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.engines import pack_engine as jax_pack_engine
from insarseg.engines_io import save_artifact as jax_save
from insarseg.models import resnet_int8 as J
from insarseg.models.pspnet import PSPNet as JaxPSPNet
from insarseg.models.resnet_serve import _ca as jax_ca
from insarseg.models.resnet_serve import pack_resnet_serve as jax_pack_serve
from insarseg.models.resnet_serve import resnet_serve_apply as jax_serve_apply
from insarseg.ops.layers import adaptive_avg_pool_2d as jax_pool
from insarseg.ops.layers import max_pool_2d as jax_max_pool
from insarseg.ops.quant import requant as jax_requant
from insarseg_torch.compat import (
    pspnet_variables_to_torch,
    state_dict_to_torch,
)
from insarseg_torch.engines import engine_from_artifact
from insarseg_torch.engines_io import load_artifact, to_torch_tree
from insarseg_torch.models import resnet_int8 as T
from insarseg_torch.models.registry import build
from insarseg_torch.models.resnet_serve import (
    block_chain,
    make_resnet_serve_predict_fn,
    pack_resnet_serve,
    resnet_serve_apply,
)
from insarseg_torch.ops.layers import adaptive_avg_pool_2d
from tests.test_torch_common import (
    CPU,
    assert_packed_equal,
    numpy_tree,
    smooth,
)

BAR = 1e-4
ATTENTIONS = ("none", "channel", "spatial")
HW = 40


@pytest.mark.parametrize("h,o", [(5, 6), (5, 3), (7, 3), (64, 6), (6, 6)])
def test_adaptive_avg_pool_matches_jax(h, o):
    x = np.random.default_rng(h * 10 + o).standard_normal(
        (2, h, h, 16)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jax_pool(jnp.asarray(x).astype(jdt), (o, o))
                          .astype(jnp.float32))
        got = adaptive_avg_pool_2d(xt.to(tdt), o)
        assert got.dtype == tdt
        got = got.float().permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (2, o, o, 16)
        if tdt == torch.float32:
            err = np.abs(got - want).max()
            assert err <= 1e-6 * np.abs(x).max(), err
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h", [5, 6, 64])
def test_adaptive_avg_pools_share_one_integral_image(h):
    """The pyramid's sizes (1, 2, 3, 6) read from one integral image equal
    each size pooled on its own, bit for bit, in f32 and bf16."""
    from insarseg_torch.ops.layers import adaptive_avg_pools

    x = torch.from_numpy(np.random.default_rng(h).standard_normal(
        (2, 16, h, h)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        xt = x.to(dt)
        got = adaptive_avg_pools(xt, (1, 2, 3, 6))
        for o, g in zip((1, 2, 3, 6), got):
            assert torch.equal(g, adaptive_avg_pool_2d(xt, o)), (o, dt)
            assert g.shape == (2, 16, o, o) and g.dtype == dt


def numpy_pspnet_variables(attention, seed=0):
    """The JAX package's PSPNet tree filled with numpy draws from a seed:
    LeCun-normal conv kernels, conv biases N(0, 0.1), random BN affines and
    statistics (var > 0)."""
    shapes = jax.eval_shape(JaxPSPNet(attention=attention).init,
                            jax.random.key(0), jnp.zeros((1, HW, HW, 1)))
    rng = np.random.default_rng(seed)

    def fill(node, stats=False):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v, stats)
                continue
            shape = v.shape
            if stats:
                a = rng.normal(0, 0.1, shape) if k == "mean" \
                    else rng.uniform(0.5, 1.5, shape)
            elif k == "kernel":
                a = rng.normal(0, np.sqrt(1.0 / np.prod(shape[:-1])), shape)
            elif k == "scale":
                a = rng.uniform(0.5, 1.5, shape)
            else:  # a conv or BN bias
                a = rng.normal(0, 0.1, shape)
            out[k] = a.astype(np.float32)
        return out

    return {"params": fill(shapes["params"]),
            "batch_stats": fill(shapes["batch_stats"], stats=True)}


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=ATTENTIONS)
def cell(request):
    attention = request.param
    v = numpy_pspnet_variables(attention)
    tm = build("pspnet", attention).eval()
    tm.load_state_dict(state_dict_to_torch(
        pspnet_variables_to_torch(v, attention)), strict=True)
    x = np.random.default_rng(1).standard_normal((2, HW, HW, 1)) \
        .astype(np.float32)
    return attention, v, tm, x


def test_bridge_loads_strict(cell):
    attention, v, tm, _ = cell
    sd = pspnet_variables_to_torch(v, attention)
    assert set(sd) == set(tm.state_dict())
    for k, a in sd.items():
        assert tuple(a.shape) == tuple(tm.state_dict()[k].shape), k


def test_module_matches_jax(cell):
    attention, v, tm, x = cell
    want = np.asarray(JaxPSPNet(attention=attention).apply(
        v, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, HW, HW, 2)
    rel = _rel(got, want)
    print(f"pspnet-{attention} module vs jax: {rel:.3g} x max|logit|")
    assert rel <= BAR, rel


def test_serve_matches_jax(cell):
    _, v, tm, x = cell
    jtree = jax_pack_serve(v)
    want = np.asarray(jax_serve_apply(jtree, jnp.asarray(x)))
    got = resnet_serve_apply(pack_resnet_serve(tm.state_dict()),
                             torch.from_numpy(x)).numpy()
    rel = _rel(got, want)
    print(f"serve vs jax serve: {rel:.3g} x max|logit|")
    assert rel <= BAR, rel
    on_jax_tree = make_resnet_serve_predict_fn(
        to_torch_tree(numpy_tree(jtree), CPU))(x)
    assert _rel(on_jax_tree.numpy(), want) <= BAR


@pytest.fixture(scope="module")
def int8_cell(cell):
    attention, v, tm, x = cell
    rng = np.random.default_rng(40)
    calib = [smooth(rng, (2, HW, HW, 1)) for _ in range(2)]
    jtree = J.pack_resnet_int8(v, [jnp.asarray(c) for c in calib])
    return attention, tm, calib, jtree, numpy_tree(jtree), x


def test_pack_int8_equals_jax(int8_cell):
    _, tm, calib, jtree, _, _ = int8_cell
    ours = T.pack_resnet_int8(tm.state_dict(), calib, device=CPU)
    assert "head.in" not in ours["scales"]  # nothing past the backbone
    assert_packed_equal(ours, jtree)


def test_backbone_codes_match_jax(int8_cell):
    attention, _, _, jtree, np_tree, x = int8_cell
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
    print(f"pspnet-{attention} layer4 codes: {n_off} of {diff.size} differ")
    assert 0 < np.mean(want != 0)  # the chain carries signal to layer4
    if attention == "channel":
        assert np.abs(diff).max() <= 1
        assert n_off <= 1e-3 * diff.size
    else:
        assert n_off == 0


def test_end_logits_match_jax(int8_cell):
    *_, jtree, np_tree, x = int8_cell
    want = np.asarray(J.resnet_int8_apply(jtree, jnp.asarray(x))) \
        .astype(np.float32)
    predict = T.make_resnet_int8_predict_fn(
        T.prepare_resnet_int8(np_tree, CPU))
    got = predict(x)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    rel = _rel(got, want)
    agree = np.mean(got.argmax(-1) == want.argmax(-1))
    print(f"int8 port vs jax: max rel err {rel:.3g}, argmax {agree:.5f}")
    assert rel <= 2e-2, rel
    assert agree >= 0.995, agree


@pytest.mark.parametrize("engine", ["serve", "int8"])
def test_jax_artifact_serves(tmp_path, int8_cell, engine):
    attention, _, _, jtree, _, x = int8_cell
    art = jax_pack_engine("pspnet", attention, None,
                          numpy_pspnet_variables(attention), "serve")
    if engine == "int8":
        art = {**art, "engine": "int8", "tree": jtree}
        want = np.asarray(J.resnet_int8_apply(jtree, jnp.asarray(x)))
    else:
        want = np.asarray(jax_serve_apply(art["tree"], jnp.asarray(x)))
    path = jax_save(str(tmp_path / engine), art)
    got = engine_from_artifact(load_artifact(path), device=CPU)(x)
    got, want = got.float().numpy(), want.astype(np.float32)
    rel = _rel(got, want)
    if engine == "serve":
        assert rel <= BAR, rel
    else:
        assert rel <= 2e-2, rel
        assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.995


def _narrow_head(attention, c=32, cout=16, seed=0):
    """A folded PSPNet head tree at ``c`` backbone channels: the four bins'
    1x1 convs (c -> c / 4), the 3x3 bottleneck conv (2c -> cout), and the
    attention (channel: an MLP c -> c / 16 -> c; spatial: a 7x7 conv)."""
    g = torch.Generator().manual_seed(seed)

    def conv(k, cin, co):
        return {"k": torch.randn(k, k, cin, co, generator=g) / (k * cin) ** .5,
                "s": torch.rand(co, generator=g) + 0.5,
                "b": torch.randn(co, generator=g) * 0.1}

    ppm = {"bins": (1, 2, 3, 6)}
    for b in ppm["bins"]:
        ppm[f"bin{b}"] = conv(1, c, c // 4)
    att = None
    if attention == "channel":
        att = {"type": "channel",
               "fc1": torch.randn(c, c // 16, generator=g) / c ** .5,
               "fc2": torch.randn(c // 16, c, generator=g)}
    elif attention == "spatial":
        att = {"type": "spatial", "k": conv(7, 2, 1)["k"]}
    return {"ppm": ppm, "head": conv(3, 2 * c, cout), "attention": att}


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_int8_head_is_batch_invariant(attention):
    """The int8 engine runs the bf16 head in calls of ``HEAD_CHUNK`` tiles
    (8): three tiles alone, among seven (one padded call) and among ten
    (two calls) get the same logits, bit for bit."""
    packed = _narrow_head(attention)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (10, 12, 12, 32)).astype(np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        alone = T.pspnet_head_i8(packed, x[:3])
        among7 = T.pspnet_head_i8(packed, x[:7])
        among10 = T.pspnet_head_i8(packed, x)
    assert among10.shape == (10, 16, 12, 12)
    assert among10.dtype == torch.bfloat16
    assert torch.equal(among7[:3], alone)
    assert torch.equal(among10[:3], alone)
