"""The DoubleConv train epilogue (``insarseg_torch/kernels/bn_act.py``:
K8a / K8b / K9a / K9b's plain versions and ``bn_relu_train``) against the
JAX package, on inputs made with numpy from a seed, torch on one thread:

- ``relu(BatchNorm2d(train)(y + bias))`` through ``jax.vjp`` against
  ``bn_relu_train`` (the JAX package's moment rule; the bias with no
  gradient): the output, the input gradient dt, dgamma, dbeta and the
  running statistics, at (2, 8, 6, 6), C = 1 (3, 1, 5, 7) and a 1x1 map
  (4, 5, 1, 1), the port's input NCHW and channels-last. f32: every
  tensor within ``F32_BAR`` of its largest value (two sum orders; reading
  4.6e-7). bf16: the output within one bf16 ulp of the JAX package's at
  the element (judged at no less than 2^-12 of the largest |output|); dt
  within two bf16 ulps at its largest |value| (``BF16_DT_BAR``, 1.6e-2
  x max|dt|; reading 6.5e-3: the port rounds dt once, JAX's autodiff
  rounds the direct and the moments' cotangents to bf16 apart and adds
  them in bf16, since its BatchNorm converts x to f32 twice); dgamma /
  dbeta / the statistics within ``F32_BAR`` (reading 2.3e-7). The JAX
  side runs op by op in bf16 (under ``jit`` XLA keeps the bf16 bias add
  in f32), jitted in f32;
- a train-mode ``DoubleConv`` (with and without the SE tail) against the
  JAX package's ``DoubleConv(train=True)`` through crossed weights: the
  output, the input gradient, every parameter gradient (none for the conv
  biases) and the running statistics, in f32 within ``F32_BAR`` (reading
  7.2e-7) and in bf16 within ``BF16_DC_BAR`` (reading 8.0e-3: two bf16
  convs, the JAX step jitted) of each tensor's largest value;
- a CUDA-typed call reaches the launchers of all four kernels and never a
  plain version, in the relu mode with a bias and in the ResNet
  families' none and residual modes without one (the launcher, the
  stream and the device checks stubbed: this host has no card; each
  mode and dtype in ``tests/test_torch_bn_resnet.py``).

The synced case on two ranks is in ``tests/test_torch_mesh_bn.py``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BN_SHAPES
from insarseg.ops.blocks import DoubleConv as JaxDoubleConv
from insarseg.ops.layers import BatchNorm2d as JaxBatchNorm2d
from insarseg_torch.kernels import bn_act
from insarseg_torch.kernels.bn_act import bn_relu_train
from insarseg_torch.ops.blocks import DoubleConv

F32_BAR = 1e-5  # x max|tensor|: two packages' f32 arithmetic
BF16_DT_BAR = 2.0 ** -6  # x max|dt|: two bf16 ulps at the largest |dt|
BF16_DC_BAR = 2e-2  # x max|tensor|: a DoubleConv in bf16 (two convs)
EPS, MOMENTUM = 1e-5, 0.1

SHAPES = {"2x8x6x6": (2, 8, 6, 6), "c1": (3, 1, 5, 7), "1x1": (4, 5, 1, 1)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(shape, seed):
    """(y NHWC, bias, gamma, beta, running mean, running var, dout NHWC)
    in numpy f32."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    return (rng.standard_normal((n, h, w, c)).astype(np.float32) * 2 + 0.5,
            rng.standard_normal(c).astype(np.float32) * 0.5,
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.standard_normal(c).astype(np.float32) * 0.3,
            rng.standard_normal(c).astype(np.float32) * 0.1,
            rng.uniform(0.5, 2.0, c).astype(np.float32),
            rng.standard_normal((n, h, w, c)).astype(np.float32))


def _jax_site(y, bias, gamma, beta, rm, rv, dout, jdt):
    """The JAX package's conv-bias add, BatchNorm2d(train) and relu, with
    its VJP (jitted in f32; op by op in bf16, where XLA's jit fuses the
    bf16 bias add away): (out, dt, dgamma, dbeta, mean, var) as numpy
    (NHWC)."""
    bn = JaxBatchNorm2d(use_running_average=False, dtype=jdt)
    stats = {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}

    def f(t_in, scale, shift):
        t = t_in + jnp.asarray(bias).astype(jdt)
        out, upd = bn.apply({"params": {"scale": scale, "bias": shift},
                             "batch_stats": stats}, t,
                            mutable=["batch_stats"])
        return jax.nn.relu(out), upd["batch_stats"]

    def run(t_in, scale, shift, ct):
        out, vjp, new = jax.vjp(f, t_in, scale, shift, has_aux=True)
        return (out,) + vjp(ct) + (new["mean"], new["var"])

    if jdt == jnp.float32:  # one compile; f32 rounds as op by op
        run = jax.jit(run)
    return [np.asarray(a, np.float32) for a in
            run(jnp.asarray(y).astype(jdt), jnp.asarray(gamma),
                jnp.asarray(beta), jnp.asarray(dout).astype(jdt))]


def _port_site(y, bias, gamma, beta, rm, rv, dout, tdt, channels_last):
    yt = torch.from_numpy(y).permute(0, 3, 1, 2).to(tdt)
    if not channels_last:
        yt = yt.contiguous()
    yt.requires_grad_(True)
    g = torch.from_numpy(gamma).requires_grad_(True)
    b = torch.from_numpy(beta).requires_grad_(True)
    rmt, rvt = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    out = bn_relu_train(yt, torch.from_numpy(bias), g, b, rmt, rvt, EPS,
                        MOMENTUM)
    assert out.dtype == tdt and bn_act.layout_of(out) == bn_act.layout_of(yt)
    out.backward(torch.from_numpy(dout).permute(0, 3, 1, 2).to(tdt))
    assert yt.grad.dtype == tdt
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).float().numpy()  # noqa
    return [nhwc(out), nhwc(yt.grad), g.grad.numpy(), b.grad.numpy(),
            rmt.numpy(), rvt.numpy()]


def _close(got, want, bar, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * scale, f"{what}: {err:.3g} > {bar} x {scale:.3g}"


def _within_one_bf16_ulp(got, want, what):
    """Each element within one bf16 ulp of ``want`` at its magnitude, no
    finer than at 2^-12 of the largest |want|."""
    floor = float(np.abs(want).max()) * 2.0 ** -12
    mag = np.maximum(np.abs(want), floor)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    worst = float((np.abs(got - want) / ulp).max())
    assert worst <= 1.0, f"{what}: {worst:.3g} bf16 ulps"


_JAX_SITES = {}


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_jax_batchnorm_relu(shape, dtype, layout):
    tdt, jdt = DTYPES[dtype]
    args = _draw(SHAPES[shape], seed=sum(SHAPES[shape]))
    if (shape, dtype) not in _JAX_SITES:  # one JAX run for both layouts
        _JAX_SITES[shape, dtype] = _jax_site(*args, jdt)
    want = _JAX_SITES[shape, dtype]
    got = _port_site(*args, tdt, layout == "channels_last")
    names = ("out", "dt", "dgamma", "dbeta", "running_mean", "running_var")
    for k, (g, w) in enumerate(zip(got, want)):
        if dtype == "f32":
            _close(g, w, F32_BAR, names[k])
        elif k == 0:
            _within_one_bf16_ulp(g, w, names[k])
        elif k == 1:
            _close(g, w, BF16_DT_BAR, names[k])
        else:
            _close(g, w, F32_BAR, names[k])


def _dc_variables(rng, cin, c, use_se):
    """JAX DoubleConv variables in numpy (HWIO convs, (I, O) dense)."""
    def conv(ci, co):
        bound = 1 / np.sqrt(9 * ci)
        return {"kernel": rng.uniform(-bound, bound, (3, 3, ci, co))
                .astype(np.float32),
                "bias": rng.uniform(-bound, bound, co).astype(np.float32)}

    def bn():
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}

    params = {"conv1": conv(cin, c), "bn1": bn(), "conv2": conv(c, c),
              "bn2": bn()}
    if use_se:
        params["se"] = {
            "fc1": {"kernel": (rng.standard_normal((c, c // 16)) * 0.3)
                    .astype(np.float32)},
            "fc2": {"kernel": (rng.standard_normal((c // 16, c)) * 0.3)
                    .astype(np.float32)}}
    stats = {k: {"mean": (rng.standard_normal(c) * 0.1).astype(np.float32),
                 "var": rng.uniform(0.5, 2, c).astype(np.float32)}
             for k in ("bn1", "bn2")}
    return params, stats


def _port_dc(params, stats, cin, c, use_se):
    m = DoubleConv(cin, c, use_se=use_se)
    sd = {}
    for i, k in ((0, "conv1"), (3, "conv2")):
        sd[f"double_conv.{i}.weight"] = params[k]["kernel"].transpose(3, 2,
                                                                      0, 1)
        sd[f"double_conv.{i}.bias"] = params[k]["bias"]
    for i, k in ((1, "bn1"), (4, "bn2")):
        sd[f"double_conv.{i}.weight"] = params[k]["scale"]
        sd[f"double_conv.{i}.bias"] = params[k]["bias"]
        sd[f"double_conv.{i}.running_mean"] = stats[k]["mean"]
        sd[f"double_conv.{i}.running_var"] = stats[k]["var"]
        sd[f"double_conv.{i}.num_batches_tracked"] = np.array(0)
    if use_se:
        sd["double_conv.6.fc.0.weight"] = params["se"]["fc1"]["kernel"].T
        sd["double_conv.6.fc.2.weight"] = params["se"]["fc2"]["kernel"].T
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in sd.items()}, strict=True)
    return m.train()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_se", [False, True], ids=["plain", "se"])
def test_train_double_conv_matches_jax(use_se, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(7 + use_se)
    cin, c = 3, 16
    params, stats = _dc_variables(rng, cin, c, use_se)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    dout = rng.standard_normal((2, 8, 8, c)).astype(np.float32)

    jm = JaxDoubleConv(features=c, use_se=use_se, dtype=jdt)

    def f(p, xin):
        out, upd = jm.apply({"params": p, "batch_stats": stats}, xin,
                            train=True, mutable=["batch_stats"])
        return out, upd["batch_stats"]

    @jax.jit
    def run(p, xin, ct):
        out, vjp, new = jax.vjp(f, p, xin, has_aux=True)
        return (out, new) + vjp(ct)

    out_j, new_j, gp_j, gx_j = run(
        jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(x).astype(jdt), jnp.asarray(dout).astype(jdt))

    m = _port_dc(params, stats, cin, c, use_se)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(tdt)
    xt.requires_grad_(True)
    out = m(xt)
    out.backward(torch.from_numpy(dout).permute(0, 3, 1, 2).to(tdt))
    bar = F32_BAR if dtype == "f32" else BF16_DC_BAR
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).float().numpy()  # noqa
    _close(nhwc(out), np.asarray(out_j, np.float32), bar, "out")
    _close(nhwc(xt.grad), np.asarray(gx_j, np.float32), bar, "dx")
    dc = m.double_conv
    for i, k in ((0, "conv1"), (3, "conv2")):
        _close(dc[i].weight.grad.numpy().transpose(2, 3, 1, 0),
               np.asarray(gp_j[k]["kernel"]), bar, f"{k} kernel")
        assert dc[i].bias.grad is None
        assert not np.asarray(gp_j[k]["bias"]).any()
    for i, k in ((1, "bn1"), (4, "bn2")):
        _close(dc[i].weight.grad.numpy(), np.asarray(gp_j[k]["scale"]), bar,
               f"{k} scale")
        _close(dc[i].bias.grad.numpy(), np.asarray(gp_j[k]["bias"]), bar,
               f"{k} bias")
        _close(dc[i].running_mean.numpy(), np.asarray(new_j[k]["mean"]),
               bar, f"{k} mean")
        _close(dc[i].running_var.numpy(), np.asarray(new_j[k]["var"]), bar,
               f"{k} var")
        assert int(dc[i].num_batches_tracked) == 1
    if use_se:
        for i, k in ((0, "fc1"), (2, "fc2")):
            _close(dc[6].fc[i].weight.grad.numpy().T,
                   np.asarray(gp_j["se"][k]["kernel"]), bar, f"se {k}")


class _CudaTyped(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrappers take their
    launch path with it (its storage stays on the CPU)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_typed(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_CudaTyped, t, t.requires_grad)


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "nhwc"])
def test_a_cuda_tensor_reaches_the_launchers_not_the_plain_versions(
        monkeypatch, channels_last):
    launched = []
    monkeypatch.setattr(bn_act, "launch",
                        lambda kernel, fn, *args: launched.append(kernel))
    monkeypatch.setattr(bn_act, "stream_of", lambda t: 0)
    # the backward's allocations come back as plain CPU tensors
    monkeypatch.setattr(bn_act, "check_cuda", lambda *a: None)
    monkeypatch.setattr(bn_act, "check_operand", lambda *a: None)
    monkeypatch.setattr(bn_act, "device_guard",
                        lambda dev: contextlib.nullcontext())
    for name in ("bn_stats_plain", "bn_apply_relu_plain",
                 "bn_relu_grad_stats_plain", "bn_relu_grad_apply_plain"):
        monkeypatch.setattr(bn_act, name, pytest.fail)
    y = torch.randn(2, 16, 4, 4, dtype=torch.bfloat16)
    if channels_last:
        y = y.contiguous(memory_format=torch.channels_last)
    y = _cuda_typed(y).requires_grad_(True)
    vec = [_cuda_typed(torch.randn(16)) for _ in range(5)]
    gamma = vec[1].requires_grad_(True)
    out = bn_relu_train(y, vec[0], gamma, vec[2], vec[3], vec[4], EPS,
                        MOMENTUM)
    assert launched == ["bn_stats", "bn_apply_relu"]
    out.backward(_cuda_typed(torch.ones_like(out)))
    assert launched == ["bn_stats", "bn_apply_relu", "bn_relu_grad_stats",
                        "bn_relu_grad_apply"]
    assert bn_act.plan(y)[0] == int(channels_last)
    # the ResNet families' modes, bias-free, reach the same four launchers
    r = _cuda_typed(torch.randn_like(y)).requires_grad_(True)
    for mode in ("none", "residual"):
        launched.clear()
        out = bn_relu_train(y, None, gamma, vec[2], vec[3], vec[4], EPS,
                            MOMENTUM, None, mode,
                            r if mode == "residual" else None)
        out.backward(_cuda_typed(torch.ones_like(out)))
        assert launched == ["bn_stats", "bn_apply_relu",
                            "bn_relu_grad_stats", "bn_relu_grad_apply"]
    assert r.grad is not None
    with pytest.raises(ValueError, match="unsupported device"):
        bn_act.bn_stats(torch.Tensor._make_subclass(
            _Elsewhere, torch.zeros(1, 1, 1, 1)), vec[0])


class _Elsewhere(torch.Tensor):
    @property
    def device(self):
        return torch.device("xpu", 0)


# K8a / K9a's launch plan (``bn_act.reduce_partition``): the shapes of a
# bf16 512^2 b8 U-Net-CA train step (levels 0-4, channels-last, as cuDNN's
# bf16 convs return them), the f32 step's NCHW forms of the same levels,
# and chip_smoke.py's edge shapes
STEP_LEVELS = [(8, 64 * 2 ** k, 512 >> k, 512 >> k) for k in range(5)]
PLAN_CASES = ([(s, 2, 1) for s in STEP_LEVELS]
              + [(s, 4, 0) for s in STEP_LEVELS]
              + [((n, c, h, w), 2 if dt == "bfloat16" else 4,
                  int(cl and h * w > 1 and c > 1))
                 for n, c, h, w, dt, cl in BN_SHAPES])


def _cover(p, n, c, h, w, size):
    """How often the kernel's loops (csrc/bn_act.cu reduce_nchw /
    reduce_nhwc) visit each (unit element, channel): every count must be
    1. Mirrors the index arithmetic of the kernels."""
    v = bn_act.RED_V if p.vec else 1
    u = bn_act.unroll(size, v)
    threads = bn_act.THREADS
    if p.layout == 0:  # an item: THREADS * V * U elements of one plane
        off = (np.arange(threads)[:, None] * v
               + np.arange(u)[None, :] * threads * v).ravel()
        assert sorted(off) == list(range(0, p.item, v))
        per_plane = -(-h * w // p.item)
        seen = np.zeros(p.units, np.int64)
        for s in range(p.slices):
            seen[s * p.per:min(p.units, (s + 1) * p.per)] += 1
        assert p.units == n * per_plane
        return seen, np.ones(c, np.int64)  # one block a channel (grid.y)
    lanes = p.lanes
    rows_a_pass = threads // lanes
    assert p.trip == rows_a_pass * u
    seen = np.zeros(p.units, np.int64)
    start = (np.arange(rows_a_pass)[:, None]
             + np.arange(u)[None, :] * rows_a_pass).ravel()
    for s in range(p.slices):
        beg, end = s * p.per, min(p.units, (s + 1) * p.per)
        rows = (beg + start[None, :]
                + np.arange(0, end - beg, p.trip)[:, None]).ravel()
        np.add.at(seen, rows[rows < end], 1)
    chans = np.zeros(c, np.int64)
    for g in range(p.groups):
        for lane in range(lanes):
            cv = g * lanes + lane
            if cv * v < c:
                chans[cv * v:cv * v + v] += 1
    return seen, chans


@pytest.mark.parametrize("shape,size,layout", PLAN_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{z}-{lt}"
                              for s, z, lt in PLAN_CASES])
def test_reduce_plan_covers_each_unit_once(shape, size, layout):
    n, c, h, w = shape
    whole = (h * w if layout == 0 else c) % bn_act.RED_V == 0
    for vec, blocks in ((v, b) for v in sorted({0, int(whole)})
                        for b in (bn_act.STATS_BLOCKS, bn_act.GRAD_BLOCKS)):
        p = bn_act.reduce_partition(n, c, h, w, size, layout, vec, blocks)
        assert p.layout == layout and p.vec == vec
        assert p.per % p.trip == 0 and p.slices >= 1
        assert (p.slices - 1) * p.per < max(p.units, 1) <= p.slices * p.per
        assert p.runs == -(-p.slices // bn_act.TREE)
        seen, chans = _cover(p, n, c, h, w, size)
        assert (seen == 1).all() and (chans == 1).all()
        # from the shape alone: a second computation (no cache) agrees
        assert bn_act.reduce_partition.__wrapped__(
            n, c, h, w, size, layout, vec, blocks) == p
        # about the target: at most ceil(blocks / groups) slices a group
        assert p.slices <= -(-blocks // p.groups)


def test_reduce_plan_depends_on_the_shape_not_the_address():
    shape = (2, 48, 5, 7)
    numel = int(np.prod(shape))
    strides = (5 * 7 * 48, 1, 7 * 48, 48)

    def at(offset):  # channels-last views of one storage, `offset` in
        base = torch.empty(numel + 8, dtype=torch.bfloat16)
        return base.as_strided(shape, strides, offset)

    aligned = [at(0), at(4), torch.empty(shape, dtype=torch.bfloat16)
               .contiguous(memory_format=torch.channels_last)]
    assert len({t.data_ptr() for t in aligned}) == 3
    plans = {bn_act.reduce_plan(t) for t in aligned}
    assert len(plans) == 1 and plans.pop().vec == 1
    # a pointer off the 8-byte bf16 vector: one element a load
    assert bn_act.reduce_plan(at(1)).vec == 0
    assert bn_act.reduce_plan(aligned[0], at(1)).vec == 0


def test_reduce_workspace_holds_the_largest_site_and_is_reused():
    targets = (bn_act.STATS_BLOCKS, bn_act.GRAD_BLOCKS)
    need = [bn_act.reduce_partition(*s, size, layout, 1, b).workspace(s[1])
            for s in STEP_LEVELS for size, layout in ((2, 1), (4, 0))
            for b in targets]
    sums, counters = max(k[0] for k in need), max(k[1] for k in need)
    # K8a at level 0 in bf16: one group of slices, then their runs
    p0 = bn_act.reduce_partition(*STEP_LEVELS[0], 2, 1, 1, max(targets))
    assert p0.groups == 1 and p0.slices <= max(targets)
    assert sums == (p0.slices + p0.runs) * 2 * 64
    assert sums <= bn_act.WORK_SUMS and counters <= bn_act.WORK_COUNTERS
    y = torch.empty(1)
    key = (y.device.index, 12345)
    try:
        first = bn_act._workspace(y, 12345, sums, counters)
        assert bn_act._workspace(y, 12345, 10, 10) == first
        work = bn_act._WORK[key]
        assert work[0].numel() == bn_act.WORK_SUMS
        assert not work[1].any() and work[1].dtype == torch.int32
        grown = bn_act._workspace(y, 12345, bn_act.WORK_SUMS + 1, 1)
        assert bn_act._WORK[key][0].numel() == bn_act.WORK_SUMS + 1
        assert grown[1] == first[1]
    finally:
        bn_act._WORK.pop(key, None)


def test_reduce_constants_match_the_kernels():
    from pathlib import Path
    import re

    src = (Path(bn_act.__file__).parent.parent / "csrc" / "bn_act.cu") \
        .read_text()
    for name in ("THREADS", "RED_V", "GROUP_LANES", "TREE", "RED_BYTES"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(bn_act, name), name
    assert "return V == 1 ? 4 : RED_BYTES / (V * (int)sizeof(T));" in src
    assert [bn_act.unroll(2, 4), bn_act.unroll(4, 4), bn_act.unroll(2, 1),
            bn_act.unroll(4, 1)] == [bn_act.RED_BYTES // 8,
                                     bn_act.RED_BYTES // 16, 4, 4]
