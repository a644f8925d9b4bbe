"""The ResNet families' train-mode BatchNorm on K8a-K9b's three modes
(``insarseg_torch/kernels/bn_act.py``: the plain versions through
``bn_relu_train``) against the JAX package, on inputs made with numpy
from a seed, torch on one thread:

- each mode against the JAX package's ``BatchNorm2d(train)`` on a
  bias-free conv output (the ResNet convs have no bias): ``"relu"``
  against ``relu(BN)``, ``"none"`` against ``BN`` and ``"residual"``
  against ``relu(BN + r)``, through ``jax.vjp``: the output, the input
  gradient dt, dgamma, dbeta, the residual's gradient dr and the running
  statistics, at (2, 8, 6, 6) and one value per channel (1, 5, 1, 1: the
  pooled 1x1 maps at batch 1, variance 0, the output the bias), the
  port's input NCHW and channels-last, in f32, bf16 and f64 (the JAX side
  under ``enable_x64``). Bars as ``tests/test_torch_bn_act.py``'s:
  f32 every tensor within ``F32_BAR`` of its largest value; bf16 the
  output within one bf16 ulp at the element (judged at no less than
  2^-12 of the largest |output|; in the residual mode at the magnitude
  of ``|out| + |r|``, which bounds the BatchNorm's own bf16 output that
  the sum rounds again), dt and dr within ``BF16_DT_BAR`` of their
  largest value and the f32 dgamma / dbeta / statistics within
  ``F32_BAR``; f64 the output, dt and dr within ``F64_BAR`` (the JAX
  package's f64 means against f64 sums in another order), the rest
  within ``F32_BAR`` (its statistics stay f32). The JAX side runs under
  ``jit`` (in bf16 its out, dt and dr equal the op-by-op run's: the
  BatchNorm output and the residual sum each round to bf16 there too);
- a slab of no row (a spatial mesh's empty slab) in each mode: zero sums,
  a zero count, empty outputs, and with another slab's buffers added the
  other slab's results unchanged;
- the ``rows_div`` divisor of a replicated map: sums that hold every row
  twice with ``rows_div=2`` give the output and running statistics of
  the rows once;
- the port's ``Bottleneck`` against the JAX package's ``Bottleneck`` at
  tiny widths (in_planes 8 or 16, planes 4) with and without downsample
  and SE, at stride 2 and at dilation 2, in train mode, against the JAX
  step under ``jit``: the output, the input gradient, every parameter
  gradient and the running statistics, f32 within ``F32_BAR`` of each
  tensor's largest value, ``num_batches_tracked`` 1. In bf16 the output
  and the statistics within ``BF16_BLOCK_BAR`` of the JAX block's under
  ``jit`` and op by op (the port's output equals the op-by-op one bit
  for bit in the four blocks without SE; under ``jit`` XLA keeps each
  conv output in f32 into its BatchNorm, XLA's excess precision, and
  21-27% of the outputs differ by about an ulp; readings: the output
  0.86% / 0.43% of its largest value against ``jit`` / op by op, the
  statistics 0.09% / 0); the VJP within
  ``BF16_JIT_DX_BAR`` (dx) and ``BF16_JIT_BAR`` (each parameter) of the
  JAX step's in the L2 norm, and within ``BF16_BLOCK_BAR`` of each
  tensor's largest value of the same port block whose BatchNorms are the
  moment rule in torch ops under autograd (``_autograd_bn``). The L2
  bars rest on these readings (this file's blocks, torch on one thread):
  the port against the JAX bf16 step, dx 0.005-0.081 and the parameters
  up to 0.275; the JAX bf16 step against its own f32 step, dx up to
  0.243 and the parameters up to 0.480 (a ReLU mask flips where bf16
  rounds a value near 0, and one flip moves a 32-128 term sum by a whole
  |dout|); a wrong residual mask (the BatchNorm output's sign), dr
  unmasked or dr zero, dx 0.517-0.765 in every block without SE. The
  largest reading against ``BF16_BLOCK_BAR``: 1.7%, a conv kernel's bf16
  gradient sum;
- a CUDA-typed call of each mode and dtype reaches the four launchers
  with the mode's and dtype's codes and never a plain version (the
  launcher, stream and device checks stubbed: this host has no card).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.models.resnet import Bottleneck as JaxBottleneck
from insarseg.ops.layers import BatchNorm2d as JaxBatchNorm2d
from insarseg_torch.kernels import bn_act
from insarseg_torch.kernels.bn_act import bn_relu_train
from insarseg_torch.models.resnet import Bottleneck

F32_BAR = 1e-5  # x max|tensor|: two packages' f32 arithmetic
F64_BAR = 1e-12  # x max|tensor|: two packages' f64 sums
BF16_DT_BAR = 2.0 ** -6  # x max|dt|: two bf16 ulps at the largest |dt|
BF16_BLOCK_BAR = 2e-2  # x max|tensor|: a Bottleneck in bf16 (three convs)
# x the L2 norm: a bf16 Bottleneck's VJP against the JAX step under jit
# (see the docstring for the readings these sit between)
BF16_JIT_DX_BAR = 0.25
BF16_JIT_BAR = 0.5
EPS, MOMENTUM = 1e-5, 0.1

MODES = ("relu", "none", "residual")
SHAPES = {"2x8x6x6": (2, 8, 6, 6), "1x1-b1": (1, 5, 1, 1)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f64": (torch.float64, jnp.float64)}
NAMES = ("out", "dt", "dgamma", "dbeta", "dr", "running_mean",
         "running_var")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x64(dtype: str):
    return jax.enable_x64() if dtype == "f64" else contextlib.nullcontext()


def _draw(shape, seed):
    """(y NHWC, gamma, beta, running mean, running var, dout NHWC, r NHWC)
    in numpy f64."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    return (rng.standard_normal((n, h, w, c)) * 2 + 0.5,
            rng.uniform(0.5, 1.5, c), rng.standard_normal(c) * 0.3,
            rng.standard_normal(c) * 0.1, rng.uniform(0.5, 2.0, c),
            rng.standard_normal((n, h, w, c)),
            rng.standard_normal((n, h, w, c)))


def _jax_site(mode, y, gamma, beta, rm, rv, dout, r, jdt):
    """The JAX package's BatchNorm2d(train) and what follows it with its
    VJP: (out, dt, dgamma, dbeta, dr, mean, var) as numpy f64 (NHWC)."""
    bn = JaxBatchNorm2d(use_running_average=False, dtype=jdt)
    f32 = jnp.float32
    stats = {"mean": jnp.asarray(rm, f32), "var": jnp.asarray(rv, f32)}
    pdt = jnp.float64 if jdt == jnp.float64 else f32

    def f(t, scale, shift, res):
        out, upd = bn.apply({"params": {"scale": scale, "bias": shift},
                             "batch_stats": stats}, t,
                            mutable=["batch_stats"])
        if mode == "residual":
            out = out + res
        if mode != "none":
            out = jax.nn.relu(out)
        return out, upd["batch_stats"]

    def run(t, scale, shift, res, ct):
        out, vjp, new = jax.vjp(f, t, scale, shift, res, has_aux=True)
        return (out,) + vjp(ct) + (new["mean"], new["var"])

    got = jax.jit(run)(jnp.asarray(y).astype(jdt), jnp.asarray(gamma, pdt),
              jnp.asarray(beta, pdt), jnp.asarray(r).astype(jdt),
              jnp.asarray(dout).astype(jdt))
    return [np.asarray(a).astype(np.float64) for a in got]


def _nchw(a, tdt, channels_last):
    t = torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(tdt)
    return t if channels_last else t.contiguous()


def _port_site(mode, y, gamma, beta, rm, rv, dout, r, tdt, channels_last):
    pdt = torch.float64 if tdt == torch.float64 else torch.float32
    yt = _nchw(y, tdt, channels_last).requires_grad_(True)
    rt = _nchw(r, tdt, channels_last).requires_grad_(True)
    g = torch.tensor(gamma, dtype=pdt, requires_grad=True)
    b = torch.tensor(beta, dtype=pdt, requires_grad=True)
    rmt, rvt = torch.tensor(rm, dtype=pdt), torch.tensor(rv, dtype=pdt)
    out = bn_relu_train(yt, None, g, b, rmt, rvt, EPS, MOMENTUM, None, mode,
                        rt if mode == "residual" else None)
    assert out.dtype == tdt and bn_act.layout_of(out) == bn_act.layout_of(yt)
    out.backward(_nchw(dout, tdt, channels_last))
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).double().numpy()  # noqa
    dr = nhwc(rt.grad) if mode == "residual" else np.zeros_like(r)
    return [nhwc(out), nhwc(yt.grad), g.grad.double().numpy(),
            b.grad.double().numpy(), dr, rmt.double().numpy(),
            rvt.double().numpy()]


def _close(got, want, bar, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * scale, f"{what}: {err:.3g} > {bar} x {scale:.3g}"


def _within_one_bf16_ulp(got, want, what, mag=None):
    """Each element within one bf16 ulp of ``want`` at its magnitude (or
    ``mag``'s), no finer than at 2^-12 of the largest |want|."""
    mag = np.abs(want) if mag is None else mag
    floor = float(np.abs(want).max()) * 2.0 ** -12
    mag = np.maximum(mag, floor)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    worst = float((np.abs(got - want) / ulp).max())
    assert worst <= 1.0, f"{what}: {worst:.3g} bf16 ulps"


_JAX_SITES = {}


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_jax_batchnorm(mode, shape, dtype, layout):
    tdt, jdt = DTYPES[dtype]
    args = _draw(SHAPES[shape], seed=sum(SHAPES[shape]) + MODES.index(mode))
    key = mode, shape, dtype
    if key not in _JAX_SITES:  # one JAX run for both layouts
        with _x64(dtype):
            _JAX_SITES[key] = _jax_site(mode, *args, jdt)
    want = _JAX_SITES[key]
    got = _port_site(mode, *args, tdt, layout == "channels_last")
    r = args[-1]
    for k, (g, w) in enumerate(zip(got, want)):
        name = NAMES[k]
        if name == "dr" and mode != "residual":
            continue
        if dtype == "f32" or name in ("dgamma", "dbeta") and dtype == "bf16" \
                or name.startswith("running"):
            _close(g, w, F32_BAR, name)
        elif dtype == "f64":
            _close(g, w, F64_BAR, name)
        elif name == "out":
            mag = np.abs(w) + np.abs(r) if mode == "residual" else None
            _within_one_bf16_ulp(g, w, name, mag)
        else:
            _close(g, w, BF16_DT_BAR, name)
    if shape == "1x1-b1":  # variance 0: the output is the bias
        beta = args[2]
        p = np.broadcast_to(beta, got[0].shape)
        if mode == "residual":
            p = np.maximum(p + r.astype(np.float32), 0)
        elif mode == "relu":
            p = np.maximum(p, 0)
        _close(got[0], want[0], 2.0 ** -7 if dtype == "bf16" else F32_BAR,
               "1x1 out")
        _close(got[0], p, 2.0 ** -6 if dtype == "bf16" else F32_BAR,
               "1x1 out is the bias")


def _steps(mode, y, r, dout, gamma, beta, rm, rv, stats=None, rows_div=1):
    """The four plain versions on one slab: (stats, out, gstats, dt[, dr]),
    the moments from ``stats`` when given (another slab's added)."""
    s = bn_act.bn_stats_plain(y, None) if stats is None else stats
    out = bn_act.bn_apply_relu_plain(y, None, s, gamma, beta, rm, rv, EPS,
                                     MOMENTUM, mode,
                                     r if mode == "residual" else None,
                                     rows_div)
    o = out if mode == "residual" else None
    gs = bn_act.bn_relu_grad_stats_plain(dout, y, None, s, gamma, beta, EPS,
                                         mode, o)
    dt = bn_act.bn_relu_grad_apply_plain(dout, y, None, s, gs, gamma, beta,
                                         EPS, mode, o)
    return s, out, gs, dt


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_a_slab_of_no_row(mode, dtype):
    tdt = DTYPES[dtype][0]
    pdt = torch.float64 if tdt == torch.float64 else torch.float32
    g = torch.Generator().manual_seed(3)
    full = [torch.randn(2, 8, 5, 6, generator=g).to(tdt) for _ in range(3)]
    empty = [t[:, :, :0] for t in full]
    gamma = torch.rand(8, generator=g, dtype=pdt) + 0.5
    beta = torch.randn(8, generator=g, dtype=pdt) * 0.3
    stats = bn_act.bn_stats_plain(empty[0], None)
    assert stats.shape == (17,) and not stats.any()
    rm, rv = torch.zeros(8, dtype=pdt), torch.ones(8, dtype=pdt)
    want = _steps(mode, *full, gamma, beta, rm.clone(), rv.clone())
    s = stats + want[0]  # the ranks' all-reduce
    got = _steps(mode, *empty, gamma, beta, rm.clone(), rv.clone(), stats=s)
    assert got[1].shape == empty[0].shape and not got[2].any()
    dts = got[3] if mode == "residual" else (got[3],)
    assert all(t.shape == empty[0].shape for t in dts)
    again = _steps(mode, *full, gamma, beta, rm.clone(), rv.clone(),
                   stats=s)
    for a, b in zip(again[1:], want[1:]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def test_rows_div_counts_each_row_once():
    g = torch.Generator().manual_seed(5)
    y = torch.randn(2, 6, 3, 4, generator=g)
    gamma, beta = torch.rand(6, generator=g) + 0.5, torch.randn(6, generator=g)
    twice = bn_act.bn_stats_plain(torch.cat([y, y]), None)
    once = bn_act.bn_stats_plain(y, None)
    assert torch.equal(twice[:12], 2 * once[:12]) and twice[12] == 2 * once[12]
    rm1, rv1 = torch.zeros(6), torch.ones(6)
    rm2, rv2 = torch.zeros(6), torch.ones(6)
    a = bn_act.bn_apply_relu_plain(y, None, once, gamma, beta, rm1, rv1, EPS,
                                   MOMENTUM)
    b = bn_act.bn_apply_relu_plain(y, None, twice, gamma, beta, rm2, rv2, EPS,
                                   MOMENTUM, rows_div=2)
    torch.testing.assert_close(b, a, rtol=0, atol=1e-6)
    torch.testing.assert_close(rm2, rm1, rtol=0, atol=1e-7)
    torch.testing.assert_close(rv2, rv1, rtol=0, atol=1e-7)
    rm3, rv3 = torch.zeros(6), torch.ones(6)
    bn_act.bn_apply_relu_plain(y, None, twice, gamma, beta, rm3, rv3, EPS,
                               MOMENTUM)
    assert not torch.allclose(rv3, rv1, rtol=0, atol=1e-4)  # 47/48 vs 23/24


# (in_planes, stride, dilation): downsample where in_planes != 4 planes
BLOCKS = {"identity": (16, 1, 1), "downsample-s2": (8, 2, 1),
          "dilated": (16, 1, 2), "downsample-d2": (8, 1, 2)}
PLANES = 4


def _block_variables(rng, jm, x):
    """The JAX Bottleneck's tree (``eval_shape``, no init run) filled with
    numpy draws: convs N(0, sqrt(2 / fan_in)), BN scale in [0.5, 1.5] and
    bias N(0, 0.1), statistics near (0, 1)."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                            train=False))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.standard_normal(leaf.shape) * np.sqrt(2 / fan_in)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape)
        if name in ("bias", "mean"):
            return rng.standard_normal(leaf.shape) * 0.1
        return rng.uniform(0.5, 2.0, leaf.shape)  # var

    return jax.tree_util.tree_map_with_path(
        lambda p, v: fill(p, v).astype(np.float32), shapes)


def _port_block(variables, in_planes, stride, dilation, use_se):
    m = Bottleneck(in_planes, PLANES, stride, dilation, use_se)
    params, stats = variables["params"], variables["batch_stats"]
    names = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
             "downsample_conv": "downsample.0"}
    bns = {"bn1": "bn1", "bn2": "bn2", "bn3": "bn3",
           "downsample_bn": "downsample.1"}
    sd = {}
    for j, t in names.items():
        if j in params:
            sd[f"{t}.weight"] = params[j]["kernel"].transpose(3, 2, 0, 1)
    for j, t in bns.items():
        if j in params:
            sd[f"{t}.weight"] = params[j]["scale"]
            sd[f"{t}.bias"] = params[j]["bias"]
            sd[f"{t}.running_mean"] = stats[j]["mean"]
            sd[f"{t}.running_var"] = stats[j]["var"]
            sd[f"{t}.num_batches_tracked"] = np.array(0)
    if use_se:
        for i, k in ((0, "fc1"), (2, "fc2")):
            sd[f"se_block.fc.{i}.weight"] = \
                params["se_block"][k]["kernel"].transpose(3, 2, 0, 1)
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in sd.items()}, strict=True)
    return m.train(), names, bns


def _autograd_bn(x, bn, mode="none", residual=None, bias=None):
    """The JAX moment rule with the port's f64 sums in torch ops, its
    gradient from autograd (the running statistics left alone)."""
    dims, n = (0, 2, 3), x.shape[0] * x.shape[2] * x.shape[3]
    xd = x.double()
    mean = (xd.sum(dims) * (1.0 / n)).float()
    var = ((xd * xd).sum(dims) * (1.0 / n)).float() - mean * mean
    a = torch.rsqrt(var.clamp_min(0) + bn.eps) * bn.weight
    y = ((x.float() - mean[:, None, None]) * a[:, None, None]
         + bn.bias[:, None, None]).to(x.dtype)
    if mode == "residual":
        y = y + residual
    return y if mode == "none" else torch.relu(y)


def _run_block(m, x, dout, tdt):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(tdt)
    xt.requires_grad_(True)
    out = m(xt)
    assert out.dtype == tdt
    out.backward(torch.from_numpy(dout).permute(0, 3, 1, 2).to(tdt))
    return out, xt.grad


def _port_grads(m, convs, bns, dx):
    """The port block's VJP in the JAX package's layouts: ``dx`` (NHWC)
    and each parameter's gradient by its JAX name."""
    mods = dict(m.named_modules())
    g = {"dx": dx.detach().permute(0, 2, 3, 1).float().numpy()}
    for j, t in convs.items():
        if t in mods:
            g[j] = mods[t].weight.grad.numpy().transpose(2, 3, 1, 0)
    for j, t in bns.items():
        if t in mods:
            g[f"{j}.scale"] = mods[t].weight.grad.numpy()
            g[f"{j}.bias"] = mods[t].bias.grad.numpy()
    if m.se_block is not None:
        for i, k in ((0, "fc1"), (2, "fc2")):
            g[f"se_block.{k}"] = \
                m.se_block.fc[i].weight.grad.numpy().transpose(2, 3, 1, 0)
    return g


def _jax_grads(gp, gx):
    """:func:`_port_grads`'s names over the JAX VJP."""
    g = {"dx": np.asarray(gx, np.float32)}
    for j, v in gp.items():
        for k, a in (v.items() if j != "se_block" else
                     ((k, w["kernel"]) for k, w in v.items())):
            g[j if k == "kernel" else f"{j}.{k}"] = np.asarray(a, np.float32)
    return g


def _rel_l2(got, want, bar, what):
    err = float(np.linalg.norm(got - want))
    scale = max(float(np.linalg.norm(want)), 1e-30)
    assert err <= bar * scale, f"{what}: {err / scale:.3g} > {bar} (L2)"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_se", [False, True], ids=["plain", "se"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_train_bottleneck_matches_jax(monkeypatch, block, use_se, dtype):
    tdt, jdt = DTYPES[dtype]
    in_planes, stride, dilation = BLOCKS[block]
    downsample = stride != 1 or in_planes != 4 * PLANES
    rng = np.random.default_rng(11 + 2 * list(BLOCKS).index(block) + use_se)
    x = rng.standard_normal((2, 8, 8, in_planes)).astype(np.float32)
    jm = JaxBottleneck(PLANES, stride, dilation, downsample, use_se,
                       dtype=jdt)
    variables = _block_variables(rng, jm, jnp.asarray(x))
    ho = 8 // stride
    dout = rng.standard_normal((2, ho, ho, 4 * PLANES)).astype(np.float32)

    def f(p, xin):
        out, upd = jm.apply({"params": p,
                             "batch_stats": variables["batch_stats"]}, xin,
                            train=True, mutable=["batch_stats"])
        return out, upd["batch_stats"]

    def run(p, xin, ct):
        out, vjp, new = jax.vjp(f, p, xin, has_aux=True)
        return (out, new) + vjp(ct)

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    xj = jnp.asarray(x).astype(jdt)
    out_j, new_j, gp_j, gx_j = jax.jit(run)(params, xj,
                                            jnp.asarray(dout).astype(jdt))
    want = _jax_grads(gp_j, gx_j)
    # the JAX step as the program states it: op by op (see the docstring)
    wants = [(out_j, new_j, "")]
    if dtype == "bf16":
        wants.append(f(params, xj) + (" op by op",))

    m, convs, bns = _port_block(variables, in_planes, stride, dilation,
                                use_se)
    assert (m.downsample is not None) == downsample
    out, dx = _run_block(m, x, dout, tdt)
    got = _port_grads(m, convs, bns, dx)
    bar = F32_BAR if dtype == "f32" else BF16_BLOCK_BAR
    mods = dict(m.named_modules())
    for out_w, new_w, how in wants:
        _close(out.detach().permute(0, 2, 3, 1).float().numpy(),
               np.asarray(out_w, np.float32), bar, "out" + how)
        for j, t in bns.items():
            if j in new_w:
                _close(mods[t].running_mean.numpy(),
                       np.asarray(new_w[j]["mean"]), bar, f"{j} mean{how}")
                _close(mods[t].running_var.numpy(),
                       np.asarray(new_w[j]["var"]), bar, f"{j} var{how}")
    for j, t in bns.items():
        if t in mods:
            assert int(mods[t].num_batches_tracked) == 1
    assert set(got) == set(want)
    if dtype == "f32":
        for k, w in want.items():
            _close(got[k], w, F32_BAR, k)
        return
    for k, w in want.items():  # the VJP against the JAX step under jit
        _rel_l2(got[k], w, BF16_JIT_DX_BAR if k == "dx" else BF16_JIT_BAR, k)
    # and against the same block whose BatchNorms are the moment rule under
    # autograd
    from insarseg_torch.ops import layers

    monkeypatch.setattr(layers, "bn_train", _autograd_bn)
    ref, _, _ = _port_block(variables, in_planes, stride, dilation, use_se)
    _, rdx = _run_block(ref, x, dout, tdt)
    for k, r in _port_grads(ref, convs, bns, rdx).items():
        _close(got[k], r, BF16_BLOCK_BAR, f"{k} (autograd BatchNorm)")


class _CudaTyped(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrappers take their
    launch path with it (its storage stays on the CPU)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_typed(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_CudaTyped, t, t.requires_grad)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_each_mode_reaches_the_launchers(monkeypatch, mode, dtype):
    tdt = DTYPES[dtype][0]
    pdt = torch.float64 if tdt == torch.float64 else torch.float32
    launched = []

    def launch(kernel, fn, *args):
        # the codes of the dtype and the mode close each launch's ints
        launched.append((kernel, args[-5:-1]))
        if kernel == "bn_relu_grad_apply":  # dr is written where expected
            assert (args[9] is not None) == (mode == "residual")

    monkeypatch.setattr(bn_act, "launch", launch)
    monkeypatch.setattr(bn_act, "stream_of", lambda t: 0)
    monkeypatch.setattr(bn_act, "check_cuda", lambda *a: None)
    monkeypatch.setattr(bn_act, "check_operand", lambda *a: None)
    monkeypatch.setattr(bn_act, "device_guard",
                        lambda dev: contextlib.nullcontext())
    for name in ("bn_stats_plain", "bn_apply_relu_plain",
                 "bn_relu_grad_stats_plain", "bn_relu_grad_apply_plain"):
        monkeypatch.setattr(bn_act, name, pytest.fail)
    y = _cuda_typed(torch.randn(2, 16, 4, 4, dtype=tdt)).requires_grad_(True)
    r = _cuda_typed(torch.randn(2, 16, 4, 4, dtype=tdt)).requires_grad_(True)
    vec = [_cuda_typed(torch.randn(16, dtype=pdt)) for _ in range(4)]
    gamma = vec[0].requires_grad_(True)
    out = bn_relu_train(y, None, gamma, vec[1], vec[2], vec[3], EPS,
                        MOMENTUM, None, mode,
                        r if mode == "residual" else None)
    out.backward(_cuda_typed(torch.ones_like(out)))
    code, m = bn_act.DTYPES[tdt], bn_act.MODES[mode]
    layout, vec16, _ = bn_act.plan(y)
    red = bn_act.reduce_plan(y)
    assert [k for k, _ in launched] == [
        "bn_stats", "bn_apply_relu", "bn_relu_grad_stats",
        "bn_relu_grad_apply"]
    assert launched[0][1] == (red.groups, code, red.layout, red.vec)
    assert launched[1][1] == (code, layout, vec16, m)
    assert launched[2][1][0] == code and launched[2][1][-1] == m
    assert launched[3][1] == (code, layout, vec16, m)
    if dtype == "f64":
        assert red.vec == 0  # the f64 reductions take one element a load
    if mode == "residual":
        assert r.grad is not None and r.grad.shape == r.shape
    with pytest.raises(ValueError, match="residual"):
        bn_relu_train(y, None, gamma, vec[1], vec[2], vec[3], EPS, MOMENTUM,
                      None, mode, None if mode == "residual" else r)
