"""CBAM's channel attention in train mode on K10a-K11b's plain versions in
their cbam mode (``insarseg_torch/kernels/se_train.py::cbam_train``,
through the train-mode ``ChannelAttentionModule``) against the JAX
package, on inputs made with numpy from a seed, torch on one thread:

- the port's train-mode ``ChannelAttentionModule`` against the JAX
  package's (``insarseg/ops/blocks.py:89-111``) through ``jax.vjp``, the
  weights crossed by name (``mlp.0`` / ``mlp_fc1``, ``mlp.2`` /
  ``mlp_fc2``): the output, dx and both MLP weights' gradients, at C 32
  and 64 (reduction 16) on 6x6 and 16x16 maps, the port's input NCHW and
  channels-last, in f32, bf16 and f64 (the JAX side under
  ``enable_x64``), with ties planted in the max over H and W: a whole
  zero plane (every position tied, as after a ReLU), a plane whose max
  sits at two positions and one whose max sits at three. Bars as
  ``tests/test_torch_se_train.py``'s for the SE tail: f32 every tensor
  within ``F32_BAR`` of its largest value, f64 within ``F64_BAR``, bf16
  the output within one bf16 ulp at the element (judged no finer than at
  2^-12 of the largest |output|), dx within ``BF16_DT_BAR`` of its
  largest value and each weight's gradient within ``BF16_JIT_BAR`` in
  the L2 norm, against the JAX VJP under ``jit`` and op by op.
  Readings (torch on one thread): bf16 the output bit-equal to the JAX
  program's, dx 0.0025-0.0038 of its largest value, the weights'
  gradients 0.013-0.14 in the L2 norm (XLA's CPU dots, as for the SE
  tail); f32 every tensor within 2.2e-6 of its largest value, f64 within
  1.5e-15;
- the planted ties through the plain K10a and K11b against the formula:
  the max's cotangent split equally over its positions;
- ``torch.autograd.gradcheck`` of ``cbam_train`` in f64 at 2x8x3x3 (x and
  both weights);
- 2 and 4 slabs of one map (``spatial.ThreadComm``, one thread a slab,
  uneven rows and one slab of 0 rows, rows placed with
  ``spatial.place``) through the train-mode module equal to the
  unsharded module in f64 within ``F64_BAR``: the output, dx and the
  weights' gradients summed over the slabs, with a plane whose max is
  tied on two slabs, a zero plane tied on every slab, and planes whose
  max lies on one slab only;
- a CUDA-typed call of each dtype reaches the four launchers in the order
  K10a, K10b, K11a, K11b with the cbam mode's code and its operands (K10a
  writes a max and a count, K11b reads x, them and the max's cotangent
  and writes no identity's gradient), never a plain version (the
  launcher, stream and device checks stubbed: the CPU tests run with no
  card).
"""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.ops.blocks import ChannelAttentionModule as JaxCAM
from insarseg_torch.kernels import se_train as S
from insarseg_torch.kernels.se_train import cbam_train
from insarseg_torch.ops.blocks import ChannelAttentionModule
from insarseg_torch.parallel import spatial
from tests.test_torch_se_train import (
    BF16_DT_BAR,
    BF16_JIT_BAR,
    F32_BAR,
    F64_BAR,
    _close,
    _cuda_typed,
    _nchw,
    _nhwc,
    _rel_l2,
    _within_one_bf16_ulp,
)

REDUCTION = 16
SHAPES = {"2x32x6x6": (2, 32, 6, 6), "2x64x16x16": (2, 64, 16, 16)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f64": (torch.float64, jnp.float64)}
NAMES = ("out", "dx", "dw1", "dw2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plant(x):
    """Ties in the max over H and W of NHWC ``x``: plane (0, 0) all zero,
    (0, 1) its max at two positions, (1, 2) at three (exact in bf16)."""
    n, h, w, c = x.shape
    x[0, :, :, 0] = 0.0
    x[0, [0, h - 1], [1, w - 2], 1] = np.abs(x[0, :, :, 1]).max() + 0.5
    x[1, [0, h // 2, h - 1], [0, w // 2, 1], 2] = \
        np.abs(x[1, :, :, 2]).max() + 0.25
    return x


def _draw(shape, seed):
    """(x NHWC, dout NHWC, w1 (C/r, C), w2 (C, C/r)) in numpy f64, x
    with planted ties."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    hid = c // REDUCTION
    x = _plant(rng.standard_normal((n, h, w, c)) + 0.3)
    return (x, rng.standard_normal((n, h, w, c)),
            rng.standard_normal((hid, c)) * 2 / np.sqrt(c),
            rng.standard_normal((c, hid)) * 2 / np.sqrt(hid))


def _jax_gate(x, dout, w1, w2, jdt, jit):
    """The JAX package's module and its VJP: (out, dx, dw1, dw2) as numpy
    f64, the images NHWC and the weights as (out, in) matrices."""
    pdt = jnp.float64 if jdt == jnp.float64 else jnp.float32
    m = JaxCAM(reduction=REDUCTION, dtype=jdt)
    params = {"mlp_fc1": {"kernel": jnp.asarray(w1.T[None, None], pdt)},
              "mlp_fc2": {"kernel": jnp.asarray(w2.T[None, None], pdt)}}

    def run(t, p, ct):
        out, vjp = jax.vjp(lambda a, q: m.apply({"params": q}, a), t, p)
        dx, dp = vjp(ct)
        return out, dx, dp["mlp_fc1"]["kernel"], dp["mlp_fc2"]["kernel"]

    fn = jax.jit(run) if jit else run
    out, dx, k1, k2 = fn(jnp.asarray(x).astype(jdt), params,
                         jnp.asarray(dout).astype(jdt))
    mat = lambda k: np.asarray(k, np.float64).reshape(-1, k.shape[-1]).T  # noqa
    return [np.asarray(out).astype(np.float64),
            np.asarray(dx).astype(np.float64), mat(k1), mat(k2)]


def _module(c, w1, w2, pdt):
    """The port's train-mode module with the JAX weights (in ``pdt``)."""
    m = ChannelAttentionModule(c).to(pdt)
    with torch.no_grad():
        m.mlp[0].weight.copy_(torch.from_numpy(w1[:, :, None, None]))
        m.mlp[2].weight.copy_(torch.from_numpy(w2[:, :, None, None]))
    return m.train()


def _port_gate(x, dout, w1, w2, tdt, channels_last):
    pdt = torch.float64 if tdt == torch.float64 else torch.float32
    m = _module(x.shape[3], w1, w2, pdt)
    xt = _nchw(x, tdt, channels_last).requires_grad_(True)
    out = m(xt)
    assert out.dtype == tdt
    out.backward(_nchw(dout, tdt, channels_last))
    g1, g2 = m.mlp[0].weight.grad, m.mlp[2].weight.grad
    assert g1.dtype == pdt and g2.dtype == pdt
    return [_nhwc(out), _nhwc(xt.grad), g1.double().numpy()[:, :, 0, 0],
            g2.double().numpy()[:, :, 0, 0]]


_JAX = {}


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gate_matches_jax(shape, dtype, layout):
    tdt, jdt = DTYPES[dtype]
    args = _draw(SHAPES[shape], seed=sum(SHAPES[shape]) + 21)
    key = shape, dtype
    if key not in _JAX:  # one JAX run (each way) for both layouts
        with (jax.enable_x64() if dtype == "f64"
              else contextlib.nullcontext()):
            _JAX[key] = [(_jax_gate(*args, jdt, jit=True), "jit")]
            if dtype == "bf16":
                _JAX[key].append((_jax_gate(*args, jdt, jit=False),
                                  "op by op"))
    got = _port_gate(*args, tdt, layout == "channels_last")
    for want, how in _JAX[key]:
        for k, (g, w) in enumerate(zip(got, want)):
            name = f"{NAMES[k]} ({how})"
            if dtype == "f32":
                _close(g, w, F32_BAR, name)
            elif dtype == "f64":
                _close(g, w, F64_BAR, name)
            elif NAMES[k] == "out":
                _within_one_bf16_ulp(g, w, name)
            elif NAMES[k] == "dx":
                _close(g, w, BF16_DT_BAR, name)
            else:
                _rel_l2(g, w, BF16_JIT_BAR, name)


def test_planted_ties_split_the_max_cotangent():
    """A plane whose max sits at k positions gives each of them 1/k of the
    max's cotangent (a zero plane: all of its positions), through the plain
    K10a and K11b against the formula."""
    x = torch.tensor([[[[2.0, 5.0], [5.0, 1.0]], [[0.0, 0.0], [0.0, 0.0]]]],
                     dtype=torch.float64)
    sums, mx, count = S.se_squeeze(x, "cbam")
    assert sums.tolist() == [[13.0, 0.0]]
    assert mx.tolist() == [[5.0, 0.0]] and count.tolist() == [[2, 4]]
    zero = torch.zeros(1, 2, dtype=torch.float64)
    dx = S.se_grad_apply(torch.zeros_like(x), zero, zero + 0.5, None,
                         "cbam", x=x, mx=mx, count=count,
                         dmax=torch.tensor([[3.0, 2.0]], dtype=torch.float64))
    assert dx.flatten().tolist() == [0.5, 2.0, 2.0, 0.5, 1.0, 1.0, 1.0, 1.0]
    # a map of no pixel: the max's identity and no tie
    _, mx, count = S.se_squeeze(x[:, :, :0], "cbam")
    assert mx.tolist() == [[-np.inf] * 2] and count.tolist() == [[0, 0]]


def test_gradcheck():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 8, 3, 3, generator=g, dtype=torch.float64)
    w1 = torch.randn(2, 8, generator=g, dtype=torch.float64) * 0.7
    w2 = torch.randn(8, 2, generator=g, dtype=torch.float64) * 0.7
    for t in (x, w1, w2):
        t.requires_grad_(True)
    assert torch.autograd.gradcheck(cbam_train, (x, w1, w2))


# (slab rows) of a 7-row map: two uneven slabs, and four with one empty
SLABS = {"2 slabs": (4, 3), "4 slabs, one empty": (2, 0, 1, 4)}


def _run(m, x, dout):
    """The module on x forward and backward: (out, dx, the weights'
    gradients)."""
    x = x.clone().requires_grad_(True)
    out = m(x)
    out.backward(dout)
    return [out.detach(), x.grad, m.mlp[0].weight.grad,
            m.mlp[2].weight.grad]


@pytest.mark.parametrize("slabs", list(SLABS))
def test_slabs_equal_the_unsharded_gate(slabs):
    rows = SLABS[slabs]
    n, c, h, w = 2, 32, sum(rows), 5
    g = torch.Generator().manual_seed(9)
    x, dout = (torch.randn(n, c, h, w, generator=g, dtype=torch.float64)
               for _ in range(2))
    x[0, 0] = 0.0  # tied at every position of every slab
    x[0, 1, 0, 1] = x[0, 1, h - 1, 3] = x[0, 1].abs().max() + 1  # two slabs
    x[1, 2, 0, 0] = x[1, 2].abs().max() + 1  # on the first slab alone
    x[1, 3, h - 1, 4] = x[1, 3].abs().max() + 1  # on the last slab alone

    def module():
        torch.manual_seed(3)
        return ChannelAttentionModule(c).double().train()

    want = _run(module(), x, dout)
    bounds = tuple(np.cumsum((0,) + rows).tolist())
    shared = spatial.ThreadExchange(len(rows))
    got, errors = {}, []
    mods = [module() for _ in rows]  # drawn before the threads

    def work(s):
        try:
            torch.set_num_threads(1)
            comm = spatial.ThreadComm(shared, s, torch.device("cpu"))
            spatial.place(comm, w, spatial.Rows(bounds))
            a, b = bounds[s], bounds[s + 1]
            with spatial.active(comm):
                got[s] = _run(mods[s], x[:, :, a:b], dout[:, :, a:b])
        except Exception as e:  # raised below
            errors.append(e)
            shared.barrier.abort()

    threads = [threading.Thread(target=work, args=(s,))
               for s in range(len(rows))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    parts = [got[s] for s in range(len(rows))]
    for k, name in enumerate(NAMES):
        if name in ("dw1", "dw2"):  # each slab's own, summed by the mesh
            joined = sum(p[k] for p in parts)
        else:
            joined = torch.cat([p[k] for p in parts], dim=2)
        _close(joined.numpy(), want[k].numpy(), F64_BAR, f"{name}, {slabs}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cbam_reaches_the_launchers(monkeypatch, dtype):
    tdt = DTYPES[dtype][0]
    launched = []

    def launch(kernel, fn, *args):
        launched.append((kernel, fn, args))

    monkeypatch.setattr(S, "launch", launch)
    monkeypatch.setattr(S, "stream_of", lambda t: 0)
    monkeypatch.setattr(S, "check_cuda", lambda *a: None)
    monkeypatch.setattr(S, "check_operand", lambda *a: None)
    monkeypatch.setattr(S, "_WORK", {})
    monkeypatch.setattr(S, "device_guard",
                        lambda dev: contextlib.nullcontext())
    for name in ("se_squeeze_plain", "se_excite_plain",
                 "se_grad_stats_plain", "se_grad_apply_plain"):
        monkeypatch.setattr(S, name, pytest.fail)
    x = _cuda_typed(torch.randn(2, 32, 4, 4, dtype=tdt)).requires_grad_(True)
    pdt = torch.float64 if tdt == torch.float64 else torch.float32
    w1 = torch.randn(2, 32, dtype=pdt, requires_grad=True)
    w2 = torch.randn(32, 2, dtype=pdt, requires_grad=True)
    out = cbam_train(x, w1, w2)
    out.backward(_cuda_typed(torch.ones_like(out)))
    assert [k for k, _, _ in launched] == [
        "se_squeeze", "se_excite", "se_grad_stats", "se_grad_apply"]
    code, m = S.DTYPES[tdt], S.MODES["cbam"]
    for _, _, args in launched:  # the dtype and mode codes
        assert args[-5] == code and args[-2] == m
    red = S.reduce_plan(x)
    assert launched[0][2][-5:-2] == (code, red.layout, red.vec)
    # K10a writes the max and the count; K10b and K11a take no third
    # operand; K11b reads x, the max, the count and dmax, writes no didn
    assert all(a is not None for a in launched[0][2][4:6])
    assert launched[1][2][2] is None and launched[2][2][2] is None
    apply_args = launched[3][2]
    assert apply_args[1] == x.data_ptr()
    assert all(a is not None for a in apply_args[4:7])
    assert apply_args[8] is None
    assert w1.grad is not None and w2.grad is not None
    with pytest.raises(ValueError, match="cbam"):
        S.se_train(x, w1, w2, None, "cbam")
