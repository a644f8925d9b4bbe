"""The squeeze-excite tail in train mode on K10a-K11b's plain versions
(``insarseg_torch/kernels/se_train.py``, through ``se_train``) against the
JAX package, on inputs made with numpy from a seed, torch on one thread:

- both modes against the JAX package's modules through ``jax.vjp``:
  ``"scale"`` against ``SELayer`` (the U-Net's, a Linear MLP),
  ``"residual"`` against ``relu(SEBlock(x) + identity)`` (a CA ResNet's
  bn3 tail, a 1x1-conv MLP): the output, dx, the identity's gradient and
  both weights' gradients, at C 32 and 64 (reduction 16) on 6x6 and 16x16
  maps, the port's input NCHW and channels-last, in f32, bf16 and f64
  (the JAX side under ``enable_x64``). Bars as
  ``tests/test_torch_bn_resnet.py``'s: f32 every tensor within
  ``F32_BAR`` of its largest value; f64 within ``F64_BAR``; bf16 the
  output within one bf16 ulp at the element (judged no finer than at
  2^-12 of the largest |output|; in the residual mode at the magnitude of
  ``|out| + |identity|``, which bounds the rescale's own bf16 output that
  the sum rounds again), dx and the identity's gradient within
  ``BF16_DT_BAR`` of their largest value and the weights' gradients
  within ``BF16_JIT_BAR`` in the L2 norm (that file's bar for a
  parameter's gradient), against the JAX VJP under ``jit`` and op by op.
  Readings in bf16 (torch on one thread): the output bit-equal to the
  JAX program's (its ``logistic`` is ``1 / (1 + exp(-z))`` rounded at
  each op, which the port follows), dx and the identity's gradient
  0-0.0032 of their largest value, the weights' gradients 0.0048-0.084
  in the L2 norm: XLA's CPU dots that contract the batch axis (the
  weights' gradients ``dz^T h`` and ``da^T mean``) land up to 1.5 bf16
  ulps from the exact sum, where the port's are the exact sums rounded
  once;
- ``torch.autograd.gradcheck`` of the Function in f64 at 2x8x3x3, both
  modes (every input: x, both weights, the identity);
- 2 and 3 slabs of one map (``spatial.ThreadComm``, one thread a slab,
  one slab of 0 rows, rows placed with ``spatial.place``) through the
  train-mode ``SELayer`` and ``SEBlock(x, identity)`` equal to the
  unsharded Function in f64 within ``F64_BAR``: the output, dx, the
  identity's gradient and the weights' gradients summed over the slabs;
- a CUDA-typed call of each mode and dtype reaches the four launchers in
  the order K10a, K10b, K11a, K11b with the mode's and dtype's codes and
  never a plain version, and K11b writes the identity's gradient only in
  the residual mode (the launcher, stream and device checks stubbed: the
  CPU tests run with no card);
- K8a-K9b (``csrc/bn_act.cu``), K10a-K11b (``csrc/se_train.cu``) and
  K12a-K13b (``csrc/sa_train.cu``) take their dtype codes, arithmetic,
  vector loads and last-block counter from one header,
  ``csrc/train_common.cuh``, whose codes are ``_lib.DTYPES``;
  the reductions' cached workspace (``_lib.workspace``) is one pair a
  (device, stream) for each kernel family, grown and never shrunk.
"""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.ops.blocks import SEBlock as JaxSEBlock
from insarseg.ops.blocks import SELayer as JaxSELayer
from insarseg_torch.kernels import se_train as S
from insarseg_torch.kernels.se_train import se_train
from insarseg_torch.ops.blocks import SEBlock, SELayer
from insarseg_torch.parallel import spatial

F32_BAR = 1e-5  # x max|tensor|: two packages' f32 arithmetic
F64_BAR = 1e-12  # x max|tensor|: two packages' f64 sums
BF16_DT_BAR = 2.0 ** -6  # x max|dx|: two bf16 ulps at the largest |dx|
# x the L2 norm: a parameter's bf16 gradient against the JAX VJP (see the
# docstring for the readings)
BF16_JIT_BAR = 0.5
REDUCTION = 16

MODES = ("scale", "residual")
SHAPES = {"2x32x6x6": (2, 32, 6, 6), "2x64x16x16": (2, 64, 16, 16)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f64": (torch.float64, jnp.float64)}
NAMES = ("out", "dx", "didn", "dw1", "dw2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(shape, seed):
    """(x NHWC, identity NHWC, dout NHWC, w1 (C/r, C), w2 (C, C/r)) in
    numpy f64."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    hid = c // REDUCTION
    return (rng.standard_normal((n, h, w, c)) + 0.3,
            rng.standard_normal((n, h, w, c)),
            rng.standard_normal((n, h, w, c)),
            rng.standard_normal((hid, c)) * 2 / np.sqrt(c),
            rng.standard_normal((c, hid)) * 2 / np.sqrt(hid))


def _jax_tail(mode, x, idn, dout, w1, w2, jdt, jit):
    """The JAX package's SE tail and its VJP: (out, dx, didn, dw1, dw2) as
    numpy f64, the images NHWC and the weights as (out, in) matrices."""
    pdt = jnp.float64 if jdt == jnp.float64 else jnp.float32
    if mode == "scale":
        m = JaxSELayer(reduction=REDUCTION, dtype=jdt)
        params = {"fc1": {"kernel": jnp.asarray(w1.T, pdt)},
                  "fc2": {"kernel": jnp.asarray(w2.T, pdt)}}
    else:
        m = JaxSEBlock(reduction=REDUCTION, dtype=jdt)
        params = {"fc1": {"kernel": jnp.asarray(w1.T[None, None], pdt)},
                  "fc2": {"kernel": jnp.asarray(w2.T[None, None], pdt)}}

    def f(t, p, r):
        out = m.apply({"params": p}, t)
        return out if mode == "scale" else jax.nn.relu(out + r)

    def run(t, p, r, ct):
        out, vjp = jax.vjp(f, t, p, r)
        dx, dp, dr = vjp(ct)
        return out, dx, dr, dp["fc1"]["kernel"], dp["fc2"]["kernel"]

    fn = jax.jit(run) if jit else run
    out, dx, dr, k1, k2 = fn(jnp.asarray(x).astype(jdt), params,
                             jnp.asarray(idn).astype(jdt),
                             jnp.asarray(dout).astype(jdt))
    mat = lambda k: np.asarray(k, np.float64).reshape(-1, k.shape[-1]).T  # noqa
    got = [np.asarray(a).astype(np.float64) for a in (out, dx, dr)]
    return got + [mat(k1), mat(k2)]


def _nchw(a, tdt, channels_last):
    t = torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(tdt)
    return t if channels_last else t.contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).double().numpy()


def _port_tail(mode, x, idn, dout, w1, w2, tdt, channels_last):
    pdt = torch.float64 if tdt == torch.float64 else torch.float32
    xt = _nchw(x, tdt, channels_last).requires_grad_(True)
    rt = _nchw(idn, tdt, channels_last).requires_grad_(True)
    a = torch.tensor(w1, dtype=pdt, requires_grad=True)
    b = torch.tensor(w2, dtype=pdt, requires_grad=True)
    out = se_train(xt, a, b, rt if mode == "residual" else None, mode)
    assert out.dtype == tdt
    out.backward(_nchw(dout, tdt, channels_last))
    assert a.grad.dtype == pdt and b.grad.dtype == pdt
    didn = _nhwc(rt.grad) if mode == "residual" else np.zeros_like(idn)
    return [_nhwc(out), _nhwc(xt.grad), didn, a.grad.double().numpy(),
            b.grad.double().numpy()]


def _close(got, want, bar, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * scale, f"{what}: {err:.3g} > {bar} x {scale:.3g}"


def _rel_l2(got, want, bar, what):
    err = float(np.linalg.norm(got - want))
    scale = max(float(np.linalg.norm(want)), 1e-30)
    assert err <= bar * scale, f"{what}: {err / scale:.3g} > {bar} (L2)"


def _within_one_bf16_ulp(got, want, what, mag=None):
    """Each element within one bf16 ulp of ``want`` at its magnitude (or
    ``mag``'s), no finer than at 2^-12 of the largest |want|."""
    mag = np.abs(want) if mag is None else mag
    floor = float(np.abs(want).max()) * 2.0 ** -12
    mag = np.maximum(mag, floor)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    worst = float((np.abs(got - want) / ulp).max())
    assert worst <= 1.0, f"{what}: {worst:.3g} bf16 ulps"


_JAX = {}


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_tail_matches_jax(mode, shape, dtype, layout):
    tdt, jdt = DTYPES[dtype]
    args = _draw(SHAPES[shape], seed=sum(SHAPES[shape]) + MODES.index(mode))
    key = mode, shape, dtype
    if key not in _JAX:  # one JAX run (each way) for both layouts
        with (jax.enable_x64() if dtype == "f64"
              else contextlib.nullcontext()):
            _JAX[key] = [(_jax_tail(mode, *args, jdt, jit=True), "jit")]
            if dtype == "bf16":
                _JAX[key].append((_jax_tail(mode, *args, jdt, jit=False),
                                  "op by op"))
    got = _port_tail(mode, *args, tdt, layout == "channels_last")
    idn = args[1]
    for want, how in _JAX[key]:
        for k, (g, w) in enumerate(zip(got, want)):
            name = f"{NAMES[k]} ({how})"
            if NAMES[k] == "didn" and mode != "residual":
                continue
            if dtype == "f32":
                _close(g, w, F32_BAR, name)
            elif dtype == "f64":
                _close(g, w, F64_BAR, name)
            elif NAMES[k] == "out":
                mag = np.abs(w) + np.abs(idn) if mode == "residual" else None
                _within_one_bf16_ulp(g, w, name, mag)
            elif NAMES[k] in ("dx", "didn"):
                _close(g, w, BF16_DT_BAR, name)
            else:
                _rel_l2(g, w, BF16_JIT_BAR, name)


@pytest.mark.parametrize("mode", MODES)
def test_gradcheck(mode):
    g = torch.Generator().manual_seed(1 + MODES.index(mode))
    x, idn = (torch.randn(2, 8, 3, 3, generator=g, dtype=torch.float64)
              .requires_grad_(True) for _ in range(2))
    w1 = (torch.randn(2, 8, generator=g, dtype=torch.float64) * 0.7)
    w2 = (torch.randn(8, 2, generator=g, dtype=torch.float64) * 0.7)
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    if mode == "scale":
        assert torch.autograd.gradcheck(
            lambda a, b, c: se_train(a, b, c), (x, w1, w2))
    else:
        assert torch.autograd.gradcheck(
            lambda a, b, c, d: se_train(a, b, c, d, "residual"),
            (x, w1, w2, idn))


# (slab rows) of a 7-row map: two slabs and three, one of them empty
SLABS = {"2 slabs": (4, 3), "3 slabs, one empty": (3, 0, 4)}


def _module(mode, c, seed):
    torch.manual_seed(seed)
    m = SELayer(c) if mode == "scale" else SEBlock(c)
    return m.double().train()


def _run(m, mode, x, idn, dout):
    """The module on x (and the identity) forward and backward: (out, dx,
    didn, the weights' gradients)."""
    x = x.clone().requires_grad_(True)
    idn = idn.clone().requires_grad_(True)
    out = m(x) if mode == "scale" else m(x, idn)
    out.backward(dout)
    return [out.detach(), x.grad, idn.grad if mode == "residual" else None,
            m.fc[0].weight.grad, m.fc[2].weight.grad]


@pytest.mark.parametrize("slabs", list(SLABS))
@pytest.mark.parametrize("mode", MODES)
def test_slabs_equal_the_unsharded_tail(mode, slabs):
    rows = SLABS[slabs]
    n, c, h, w = 2, 32, sum(rows), 5
    g = torch.Generator().manual_seed(7)
    x, idn, dout = (torch.randn(n, c, h, w, generator=g, dtype=torch.float64)
                    for _ in range(3))
    want = _run(_module(mode, c, 3), mode, x, idn, dout)
    bounds = tuple(np.cumsum((0,) + rows).tolist())
    shared = spatial.ThreadExchange(len(rows))
    got, errors = {}, []
    mods = [_module(mode, c, 3) for _ in rows]  # drawn before the threads

    def work(s):
        try:
            torch.set_num_threads(1)
            comm = spatial.ThreadComm(shared, s, torch.device("cpu"))
            spatial.place(comm, w, spatial.Rows(bounds))
            a, b = bounds[s], bounds[s + 1]
            with spatial.active(comm):
                got[s] = _run(mods[s], mode, x[:, :, a:b],
                              idn[:, :, a:b], dout[:, :, a:b])
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
        if want[k] is None:
            continue
        if name in ("dw1", "dw2"):  # each slab's own, summed by the mesh
            joined = sum(p[k] for p in parts)
        else:
            joined = torch.cat([p[k] for p in parts], dim=2)
        _close(joined.numpy(), want[k].numpy(), F64_BAR, f"{name}, {slabs}")


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
    idn = _cuda_typed(torch.randn(2, 32, 4, 4, dtype=tdt))
    idn.requires_grad_(True)
    pdt = torch.float64 if tdt == torch.float64 else torch.float32
    w1 = torch.randn(2, 32, dtype=pdt, requires_grad=True)
    w2 = torch.randn(32, 2, dtype=pdt, requires_grad=True)
    out = se_train(x, w1, w2, idn if mode == "residual" else None, mode)
    out.backward(_cuda_typed(torch.ones_like(out)))
    assert [k for k, _, _ in launched] == [
        "se_squeeze", "se_excite", "se_grad_stats", "se_grad_apply"]
    assert [f for _, f, _ in launched] == [
        "insarseg_se_squeeze", "insarseg_se_excite",
        "insarseg_se_grad_stats", "insarseg_se_grad_apply"]
    code, m = S.DTYPES[tdt], S.MODES[mode]
    red, app = S.reduce_plan(x), S.apply_plan(x)
    assert launched[0][2][-5:-2] == (code, red.layout, red.vec)
    for _, _, args in launched:  # the dtype, layout, vec and mode codes
        assert args[-5] == code and args[-2] == m
    assert launched[1][2][-4:-2] == (app.layout, app.vec)
    # K10a's max and count, and K11b's, and the max's cotangent, only in
    # the cbam mode
    assert launched[0][2][4:6] == (None, None)
    assert launched[3][2][4:7] == (None, None, None)
    # K11b's second output (the identity's gradient) and K10b / K11a /
    # K11b's third operand only in the residual mode
    apply_args = launched[3][2]
    assert (apply_args[1] is not None) == (mode == "residual")
    assert (apply_args[8] is not None) == (mode == "residual")
    assert (launched[1][2][2] is not None) == (mode == "residual")
    assert (launched[2][2][2] is not None) == (mode == "residual")
    if mode == "residual":
        assert idn.grad is not None and idn.grad.shape == idn.shape
    assert w1.grad is not None and w2.grad is not None
    with pytest.raises(ValueError, match="identity"):
        se_train(x, w1, w2, None if mode == "residual" else idn, mode)


def test_train_kernels_share_one_header():
    import re
    from pathlib import Path

    from insarseg_torch.kernels import _lib

    csrc = Path(S.__file__).parent.parent / "csrc"
    header = (csrc / "train_common.cuh").read_text()
    m = re.search(r"constexpr int F32 = (\d+), BF16 = (\d+), F64 = (\d+);",
                  header)
    assert m and tuple(map(int, m.groups())) == (
        _lib.DTYPES[torch.float32], _lib.DTYPES[torch.bfloat16],
        _lib.DTYPES[torch.float64])
    for name in ("bn_act.cu", "se_train.cu", "sa_train.cu"):
        code = re.sub(r"//[^\n]*", "", (csrc / name).read_text())
        assert '#include "train_common.cuh"' in code, name
        for own in ("struct AccOf", "round_to(Acc", "void load(",
                    "void store(", "atomicAdd(", "constexpr int F32"):
            assert own not in code, (name, own)


@pytest.mark.parametrize("family", ["bn_act", "se_train"])
def test_workspace_is_one_pair_a_stream(family):
    import importlib

    from insarseg_torch.kernels import _lib

    mod = importlib.import_module(f"insarseg_torch.kernels.{family}")
    cache = {}
    t = torch.zeros(1)
    first = _lib.workspace(cache, t, 7, 10, 10, mod.WORK_SUMS,
                           mod.WORK_COUNTERS)
    sums, counters = cache[(None, 7)]
    assert sums.numel() == mod.WORK_SUMS and sums.dtype == torch.float64
    assert counters.numel() == mod.WORK_COUNTERS and not counters.any()
    assert _lib.workspace(cache, t, 7, mod.WORK_SUMS, 1, mod.WORK_SUMS,
                          mod.WORK_COUNTERS) == first
    grown = _lib.workspace(cache, t, 7, mod.WORK_SUMS + 1, 1,
                           mod.WORK_SUMS, mod.WORK_COUNTERS)
    assert grown[0] != first[0] and grown[1] == first[1]
    assert cache[(None, 7)][0].numel() == mod.WORK_SUMS + 1
    _lib.workspace(cache, t, 8, 1, 1, mod.WORK_SUMS, mod.WORK_COUNTERS)
    assert set(cache) == {(None, 7), (None, 8)}
