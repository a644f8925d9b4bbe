"""The spatial-attention gate in train mode on K12a-K13b's plain versions
(``insarseg_torch/kernels/sa_train.py``, through ``sa_tail``) against the
JAX package, on inputs made with numpy from a seed, torch on one thread:

- the train-mode ``SpatialAttentionConv`` (kernel 7 and 3) and
  ``SpatialAttentionDC`` (its DoubleConv(2 -> 1) on K8a-K9b's plain
  versions) against the JAX package's modules through ``jax.vjp`` under
  ``jit``: the output, dx and the middle's weight gradients, and for the
  DoubleConv its BatchNorms' updated running statistics, at C 8 and 64 on
  6x6 and 16x16 maps, the port's input NCHW and channels-last, in f32,
  bf16 and f64 (the JAX side under ``enable_x64``), with ties planted in
  the channel max (an all-zero pixel, as after a ReLU, and pixels whose
  largest value sits in two and three channels). Bars as
  ``tests/test_torch_se_train.py``'s: f32 every tensor within ``F32_BAR``
  of its largest value (the middle's weight gradients as one vector: the
  one-channel BatchNorm's gamma gradient is a sum that cancels, 3e-3 and
  0.16 from terms of order 1, and its f32 readings, JAX's and the port's
  alike, lie 6e-6 and 8e-5 of it from the f64 VJP, within 1.2e-6 of the
  middle's largest gradient); f64 within ``F64_BAR``; bf16 the output
  within one bf16 ulp at the element (judged no finer than at 2^-12 of
  the largest |output|), dx within ``BF16_DT_BAR`` of its largest value
  and the middle's weight gradients, as one vector, within
  ``BF16_JIT_BAR`` in the L2 norm (readings: the conv middles' output
  bit-equal, dx 0.004-0.005 of its largest value); with the DoubleConv
  middle in bf16 the output within ``BF16_DC_BAR`` and dx within
  ``BF16_DC_DX_BAR`` of their largest values (readings 0.0037-0.0064 and
  0.0073-0.065: the DoubleConv's bf16 output moves the gate 1-2 bf16
  ulps at 5-10% of the pixels, and each package's bf16 dx lies
  0.0044-0.42 of its largest value from the f64 VJP of the same bf16
  inputs, the one-channel BatchNorm's backward in bf16); case by case
  the port's dx lies from that f64 VJP (x and dout rounded to bf16, the
  params as they are, the JAX module in f64) at most
  ``BF16_DC_DX_NOISE`` times as far as the JAX package's bf16 dx does
  (readings: 0.0076 against 0.0044 of the largest |dx|, x1.74, at C 8;
  0.416 against 0.420, x0.99, at C 64), as ``chip_smoke.py``'s
  ``FLOAT_NOISE`` holds the ResNet steps; and the
  running statistics within ``BF16_DC_BAR``, as that file holds a bf16
  DoubleConv's; in f32 and f64 the running statistics, which the JAX
  package keeps in f32, within ``F32_BAR`` (as
  ``tests/test_torch_bn_resnet.py`` holds them);
- ``torch.autograd.gradcheck`` of the site in f64 at 2x8x5x5 (x and the
  middle's weights) for a conv and a DoubleConv middle;
- 2 and 3 slabs of one map (``spatial.ThreadComm``, one thread a slab,
  one slab of 0 rows, rows placed with ``spatial.place``) through the
  train-mode ``SpatialAttentionConv`` equal to the unsharded site in f64
  within ``F64_BAR``: the output, dx, and the conv's weight gradient
  summed over the slabs;
- a CUDA-typed call of each dtype and layout reaches the four launchers
  in the order K12a, K12b, K13a, K13b with the dtype's code and the plan
  and never a plain version (the launcher, stream and device checks
  stubbed: the CPU tests run with no card);
- the plans keep to the kernels' limits (``csrc/sa_train.cu::bad``).
"""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.ops.blocks import SpatialAttentionConv as JaxSAConv
from insarseg.ops.blocks import SpatialAttentionDC as JaxSADC
from insarseg_torch.kernels import sa_train as S
from insarseg_torch.kernels.sa_train import sa_tail
from insarseg_torch.ops.blocks import SpatialAttentionConv, SpatialAttentionDC
from insarseg_torch.parallel import spatial
from tests.test_torch_bn_act import BF16_DC_BAR
from tests.test_torch_se_train import (
    BF16_DT_BAR,
    BF16_JIT_BAR,
    F32_BAR,
    F64_BAR,
    _cuda_typed,
    _rel_l2,
    _within_one_bf16_ulp,
)

# x max|dx|: the DoubleConv middle in bf16 (see the docstring)
BF16_DC_DX_BAR = 0.1
# the DoubleConv middle in bf16: the port's dx distance from the f64 VJP of
# the same bf16 inputs, at most this times the JAX package's (see the
# docstring)
BF16_DC_DX_NOISE = 2.0

KINDS = ("conv7", "conv3", "dc")
SHAPES = {"2x8x6x6": (2, 8, 6, 6), "2x64x16x16": (2, 64, 16, 16)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f64": (torch.float64, jnp.float64)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(shape, seed):
    """(x NHWC, dout NHWC) in numpy f64, with ties planted in the channel
    max: pixel (0, 0, 0) all zero, (0, 1, 2) its max in channels 1 and
    c - 1, (1, 2, 1) in three channels."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    x = rng.standard_normal((n, h, w, c)) + 0.3
    x[0, 0, 0] = 0.0
    x[0, 1, 2, [1, c - 1]] = np.abs(x[0, 1, 2]).max() + 0.5
    x[1, 2, 1, [0, 2, c // 2]] = np.abs(x[1, 2, 1]).max() + 0.25
    return x, rng.standard_normal((n, h, w, c))


def _middle_params(kind, rng):
    """The middle's JAX params and batch stats (numpy f32): a bias-free
    k x k conv (2 -> 1), or a DoubleConv(2 -> 1)."""
    if kind != "dc":
        k = int(kind[-1])
        return {"conv": {"kernel": (rng.standard_normal((k, k, 2, 1))
                                    / k).astype(np.float32)}}, None

    def conv(ci):
        return {"kernel": (rng.standard_normal((3, 3, ci, 1)) / 3)
                .astype(np.float32),
                "bias": (rng.standard_normal(1) * 0.1).astype(np.float32)}

    def bn():
        return {"scale": rng.uniform(0.5, 1.5, 1).astype(np.float32),
                "bias": (rng.standard_normal(1) * 0.1).astype(np.float32)}

    params = {"compress_and_map": {"conv1": conv(2), "bn1": bn(),
                                   "conv2": conv(1), "bn2": bn()}}
    stats = {"compress_and_map": {
        k: {"mean": (rng.standard_normal(1) * 0.1).astype(np.float32),
            "var": rng.uniform(0.5, 2, 1).astype(np.float32)}
        for k in ("bn1", "bn2")}}
    return params, stats


def _jax_gate(kind, x, dout, params, stats, jdt):
    """The JAX package's module and its VJP under ``jit``: (out, dx, the
    params' gradients, the updated batch stats) as numpy, NHWC."""
    pdt = jnp.float64 if jdt == jnp.float64 else jnp.float32
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, pdt), params)
    if kind == "dc":
        m = JaxSADC(dtype=jdt)
        st = jax.tree_util.tree_map(jnp.asarray, stats)

        def f(t, q):
            return m.apply({"params": q, "batch_stats": st}, t, train=True,
                           mutable=["batch_stats"])
    else:
        m = JaxSAConv(kernel_size=int(kind[-1]), dtype=jdt)

        def f(t, q):
            return m.apply({"params": q}, t), {}

    @jax.jit
    def run(t, q, ct):
        out, vjp, new = jax.vjp(f, t, q, has_aux=True)
        dx, dq = vjp(ct)
        return out, dx, dq, new

    out, dx, dq, new = run(jnp.asarray(x).astype(jdt), p,
                           jnp.asarray(dout).astype(jdt))
    to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a).astype(np.float64), t)
    return to_np(out), to_np(dx), to_np(dq), to_np(new)


def _port_module(kind, params, stats):
    """The port's module in train mode with the JAX params (f32)."""
    if kind != "dc":
        m = SpatialAttentionConv(int(kind[-1]))
        w = params["conv"]["kernel"].transpose(3, 2, 0, 1)
        m.conv.weight.data = torch.from_numpy(np.ascontiguousarray(w))
        return m.train()
    m = SpatialAttentionDC()
    p, st = params["compress_and_map"], stats["compress_and_map"]
    dc = m.compress_and_map.double_conv
    with torch.no_grad():
        for i, k in ((0, "conv1"), (3, "conv2")):
            dc[i].weight.copy_(torch.from_numpy(
                np.ascontiguousarray(p[k]["kernel"].transpose(3, 2, 0, 1))))
            dc[i].bias.copy_(torch.from_numpy(p[k]["bias"]))
        for i, k in ((1, "bn1"), (4, "bn2")):
            dc[i].weight.copy_(torch.from_numpy(p[k]["scale"]))
            dc[i].bias.copy_(torch.from_numpy(p[k]["bias"]))
            dc[i].running_mean.copy_(torch.from_numpy(st[k]["mean"]))
            dc[i].running_var.copy_(torch.from_numpy(st[k]["var"]))
    return m.train()


def _nchw(a, tdt, channels_last):
    t = torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(tdt)
    return t if channels_last else t.contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).double().numpy()


def _port_gate(kind, x, dout, params, stats, tdt, channels_last):
    """(out, dx, {name: weight gradient as the JAX param}, {name: running
    statistics}) of the port's module, NHWC numpy f64."""
    m = _port_module(kind, params, stats)
    if tdt == torch.float64:
        m = m.double()
    xt = _nchw(x, tdt, channels_last).requires_grad_(True)
    out = m(xt)
    assert out.dtype == tdt
    out.backward(_nchw(dout, tdt, channels_last))
    grads, new = {}, {}
    if kind != "dc":
        grads["conv"] = m.conv.weight.grad.double().numpy().transpose(
            2, 3, 1, 0)
    else:
        dc = m.compress_and_map.double_conv
        for i, k in ((0, "conv1"), (3, "conv2")):
            grads[k] = dc[i].weight.grad.double().numpy().transpose(
                2, 3, 1, 0)
            assert dc[i].bias.grad is None
        for i, k in ((1, "bn1"), (4, "bn2")):
            grads[k + " scale"] = dc[i].weight.grad.double().numpy()
            grads[k + " bias"] = dc[i].bias.grad.double().numpy()
            new[k + " mean"] = dc[i].running_mean.double().numpy()
            new[k + " var"] = dc[i].running_var.double().numpy()
    return _nhwc(out), _nhwc(xt.grad), grads, new


def _jax_named(kind, dq, new):
    """The JAX gradients and statistics under ``_port_gate``'s names."""
    if kind != "dc":
        return {"conv": dq["conv"]["kernel"]}, {}
    p, st = dq["compress_and_map"], new.get("batch_stats", {}).get(
        "compress_and_map", {})
    grads = {k: p[k]["kernel"] for k in ("conv1", "conv2")}
    for k in ("bn1", "bn2"):
        grads[k + " scale"] = p[k]["scale"]
        grads[k + " bias"] = p[k]["bias"]
    stats = {f"{k} {s}": st[k][s] for k in ("bn1", "bn2")
             for s in ("mean", "var")}
    return grads, stats


def _close(got, want, bar, what, scale=None):
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * scale, f"{what}: {err:.3g} > {bar} x {scale:.3g}"


_JAX = {}


def _f64_dx_of_bf16(kind, shape, x, dout, params, stats):
    """dx of the JAX module in f64 on x and dout rounded to bf16 (the
    params as they are): the yardstick of both packages' bf16 dx."""
    key = kind, shape, "f64 of bf16"
    if key not in _JAX:
        bf = lambda a: np.asarray(  # noqa: E731
            jnp.asarray(a).astype(jnp.bfloat16)).astype(np.float64)
        with jax.enable_x64():
            _JAX[key] = _jax_gate(kind, bf(x), bf(dout), params, stats,
                                  jnp.float64)[1]
    return _JAX[key]


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", KINDS)
def test_gate_matches_jax(kind, shape, dtype, layout):
    tdt, jdt = DTYPES[dtype]
    seed = sum(SHAPES[shape]) + KINDS.index(kind)
    x, dout = _draw(SHAPES[shape], seed)
    params, stats = _middle_params(kind, np.random.default_rng(seed + 1))
    key = kind, shape, dtype
    if key not in _JAX:  # one JAX run for both layouts
        with (jax.enable_x64() if dtype == "f64"
              else contextlib.nullcontext()):
            _JAX[key] = _jax_gate(kind, x, dout, params, stats, jdt)
    out_j, dx_j, dq_j, new_j = _JAX[key]
    grads_j, stats_j = _jax_named(kind, dq_j, new_j)
    out, dx, grads, new = _port_gate(kind, x, dout, params, stats, tdt,
                                     layout == "channels_last")
    assert set(grads) == set(grads_j) and set(new) == set(stats_j)
    if dtype == "bf16" and kind == "dc":
        _close(out, out_j, BF16_DC_BAR, "out")
        _close(dx, dx_j, BF16_DC_DX_BAR, "dx")
        ref = _f64_dx_of_bf16(kind, shape, x, dout, params, stats)
        port, jax_ = (float(np.abs(d - ref).max()) for d in (dx, dx_j))
        assert port <= BF16_DC_DX_NOISE * jax_, (
            f"dx: the port {port:.3g} from the f64 VJP of the bf16 inputs, "
            f"over {BF16_DC_DX_NOISE} x JAX's {jax_:.3g}")
    elif dtype == "bf16":
        _within_one_bf16_ulp(out, out_j, "out")
        _close(dx, dx_j, BF16_DT_BAR, "dx")
    if dtype == "bf16":
        # the middle's gradients as one vector (see the docstring)
        flat = lambda g: np.concatenate(  # noqa: E731
            [np.ravel(g[k]) for k in sorted(g)])
        _rel_l2(flat(grads), flat(grads_j), BF16_JIT_BAR,
                "the middle's gradients")
        for k in new:  # the DoubleConv's bf16 statistics
            _close(new[k], stats_j[k], BF16_DC_BAR, k)
        return
    bar = F32_BAR if dtype == "f32" else F64_BAR
    _close(out, out_j, bar, "out")
    _close(dx, dx_j, bar, "dx")
    # in f32 the middle's gradients as one vector (see the docstring)
    joint = max(float(np.abs(v).max()) for v in grads_j.values())
    for k in grads:
        _close(grads[k], grads_j[k], bar, k,
               joint if dtype == "f32" else None)
    for k in new:
        _close(new[k], stats_j[k], F32_BAR, k)


def test_planted_ties_split_the_max_cotangent():
    """At a pixel whose max sits in k channels each of them gets 1/k of the
    max's cotangent: dx through the plain K13b against the formula."""
    x = torch.tensor([[[[2.0]], [[5.0]], [[5.0]], [[1.0]], [[5.0]]]],
                     dtype=torch.float64)
    m, count = S.sa_pool(x)
    assert int(count) == 3 and float(m[0, 1]) == 5.0
    assert float(m[0, 0]) == 18.0 / 5
    dm = torch.tensor([[[[0.5]], [[3.0]]]], dtype=torch.float64)
    dy = torch.zeros_like(x)
    gate = torch.ones(1, 1, 1, dtype=torch.float64)
    dx = S.sa_grad_apply(dy, x, gate, m, count, dm)
    assert dx.flatten().tolist() == [0.1, 1.1, 1.1, 0.1, 1.1]


@pytest.mark.parametrize("kind", ["conv3", "dc"])
def test_gradcheck(kind):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 5, 5, generator=g, dtype=torch.float64)
    x.requires_grad_(True)
    if kind == "dc":
        mod = SpatialAttentionDC().double().train()
        dc = mod.compress_and_map.double_conv
        weights = [dc[0].weight, dc[3].weight, dc[1].weight, dc[4].bias]
        middle = mod.compress_and_map
    else:
        mod = SpatialAttentionConv(3).double().train()
        weights = [mod.conv.weight]
        middle = mod.conv

    def site(t, *w):
        return sa_tail(t, middle)

    assert torch.autograd.gradcheck(site, (x, *weights))


# (slab rows) of a 7-row map: two slabs and three, one of them empty
SLABS = {"2 slabs": (4, 3), "3 slabs, one empty": (3, 0, 4)}


def _conv_module(k, seed):
    torch.manual_seed(seed)
    return SpatialAttentionConv(k).double().train()


def _run(m, x, dout):
    """The module on x forward and backward: (out, dx, the conv's weight
    gradient)."""
    x = x.clone().requires_grad_(True)
    out = m(x)
    out.backward(dout)
    return [out.detach(), x.grad, m.conv.weight.grad]


@pytest.mark.parametrize("slabs", list(SLABS))
@pytest.mark.parametrize("k", [3, 7])
def test_slabs_equal_the_unsharded_gate(k, slabs):
    rows = SLABS[slabs]
    n, c, h, w = 2, 16, sum(rows), 5
    g = torch.Generator().manual_seed(11)
    x, dout = (torch.randn(n, c, h, w, generator=g, dtype=torch.float64)
               for _ in range(2))
    want = _run(_conv_module(k, 5), x, dout)
    bounds = tuple(np.cumsum((0,) + rows).tolist())
    shared = spatial.ThreadExchange(len(rows))
    got, errors = {}, []
    mods = [_conv_module(k, 5) for _ in rows]  # drawn before the threads

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
    for i, name in enumerate(("out", "dx")):
        joined = torch.cat([p[i] for p in parts], dim=2)
        _close(joined.numpy(), want[i].numpy(), F64_BAR, f"{name}, {slabs}")
    # each slab's own weight gradient, summed by the mesh
    dw = sum(p[2] for p in parts)
    _close(dw.numpy(), want[2].numpy(), F64_BAR, f"dw, {slabs}")


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_the_gate_reaches_the_launchers(monkeypatch, dtype, layout):
    tdt = DTYPES[dtype][0]
    launched = []

    def launch(kernel, fn, *args):
        launched.append((kernel, fn, args))

    monkeypatch.setattr(S, "launch", launch)
    monkeypatch.setattr(S, "stream_of", lambda t: 0)
    monkeypatch.setattr(S, "check_cuda", lambda *a: None)
    monkeypatch.setattr(S, "check_operand", lambda *a: None)
    monkeypatch.setattr(S, "device_guard",
                        lambda dev: contextlib.nullcontext())
    for name in ("sa_pool_plain", "sa_apply_plain", "sa_grad_stats_plain",
                 "sa_grad_apply_plain"):
        monkeypatch.setattr(S, name, pytest.fail)
    x = torch.randn(2, 32, 4, 4, dtype=tdt)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    x = _cuda_typed(x).requires_grad_(True)
    mod = SpatialAttentionConv(3).to(tdt).train()
    out = mod(x)
    out.backward(_cuda_typed(torch.ones_like(out)))
    assert [k for k, _, _ in launched] == [
        "sa_pool", "sa_apply", "sa_grad_stats", "sa_grad_apply"]
    assert [f for _, f, _ in launched] == [
        "insarseg_sa_pool", "insarseg_sa_apply", "insarseg_sa_grad_stats",
        "insarseg_sa_grad_apply"]
    p = S.plan(x)
    assert p.layout == (layout == "channels_last")
    for _, _, args in launched:  # (..., B, HW, C, split, dtype, layout, vec)
        assert args[-8:-1] == (2, 16, 32, p.split, S.DTYPES[tdt], p.layout,
                               p.vec)
    assert mod.conv.weight.grad is not None and x.grad is not None
    assert x.grad.shape == x.shape


@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("es", [2, 4, 8])
def test_plans_keep_to_the_kernels_limits(es, layout):
    for n, c, h, w in ((8, 1024, 64, 64), (8, 128, 512, 512), (2, 2048, 64,
                                                               64),
                       (1, 1, 1, 1), (3, 7, 5, 3), (2, 64, 0, 124),
                       (8, 256, 256, 256)):
        for vec in (0, 1):
            v = 16 // es if vec else 1
            p = S.partition(n, c, h, w, es, layout, vec)
            assert p.split >= 1 and p.split & (p.split - 1) == 0
            if layout == 0:
                assert p.split <= S.MAX_SLICES <= S.THREADS // 4
                assert p.split == 1 or c >= p.split * S.MIN_SLICE
            else:
                assert p.split <= S.MAX_LANES
                assert p.split <= max(1, c // v)


def test_plan_constants_match_the_kernels():
    import re
    from pathlib import Path

    code = (Path(S.__file__).parent.parent / "csrc" / "sa_train.cu") \
        .read_text()
    for name in ("THREADS", "UNROLL"):
        m = re.search(rf"constexpr int {name} = (\d+);", code)
        assert m and int(m.group(1)) == getattr(S, name), name
    m = re.search(r"if \(layout == 0\) return S > (\d+) .*\n\s*return S > "
                  r"(\d+) ", code)
    assert m and (int(m.group(1)), int(m.group(2))) == (S.MAX_SLICES,
                                                        S.MAX_LANES)
