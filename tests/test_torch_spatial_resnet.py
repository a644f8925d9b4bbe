"""The ResNet families' layers with the H axis sharded
(``insarseg_torch/parallel/spatial.py``, ``ops/layers.py``,
``ops/resize.py``), slabs run as threads of one process
(``spatial.ThreadComm``), each against the unsharded torch op, forward
and backward, and DeepLabV3's H-sharded forward against the JAX
package's.

- the layers: a strided conv (the stem's 7x7 / 2, a 3x3 / 2, a 1x1 / 2),
  the stem's 3x3 / 2 max-pool (its -inf halo), dilated 3x3s whose halo
  reaches past one slab and past two, both resizes (a slab to the slab's
  rows of an 8x larger image; a whole map to the slab's rows), the
  pyramid pools at bins 2 / 3 / 6 and at the image's own size over
  slabs their bins cross, and the global max with ties on several slabs:
  each slab's output its rows of the unsharded op's output (or, for a
  map the slabs hold whole, that map), and the input gradients joined
  over the slabs the unsharded op's (each slab's loss taking its share
  of a whole map's gradient), within 1e-6 x the tensor's largest value;
  the weight gradients summed over the slabs, within rtol 1e-5;
- DeepLabV3 none / channel / spatial attention at full ResNet-50 widths:
  the port's ``make_predict_fn`` over ``make_mesh(data=4, spatial=2,
  devices=["cpu"] * 8)`` (32^2, global b8: 16-row slabs, 2 rows a slab
  at the output stride) against the JAX package's
  ``make_predict_fn(model, mesh=make_mesh(data=4, spatial=2))`` (the 8
  virtual CPU devices of ``tests/conftest.py``) on the same weights,
  within 1e-4 x max|logit| (the port's ResNet bar,
  ``tests/test_torch_resnet.py``), and the argmax form;
- the slabs the ResNet families' old slab rule refused (not a multiple
  of 8 rows) run: FCN-CA at 12-row slabs equals its unsharded forward,
  and a strided conv and pool on a 5-row slab equal the unsharded ops.

Every slab thread runs torch ops with its caller's thread count (set in
each thread: ``torch.set_num_threads`` holds for the thread that calls
it), as the port's ``parallel/mesh.py::spatial_engine`` does for its rank
threads. A slab's ops still sum in other orders than the unsharded ones
(oneDNN picks a conv's kernel by the input's height and padding; with
oneDNN off the order moves all the same): in f32 FCN-CA's logits at
12-row slabs read 3.6e-7 to 1.15e-6 of their largest over 12 seeds of
its weights, one of them past ``GRAD_BAR``. So that model runs in f64,
where the orders move the logits by about 1e-15 and ``GRAD_BAR`` still
tells a misplaced row or halo from rounding.

The JAX trees are numpy draws read in with the JAX package's importer
(``tests/test_torch_common.py::make_resnet_pair``), no eager JAX init."""

import copy
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from insarseg.parallel import make_mesh as jax_make_mesh
from insarseg.parallel import make_predict_fn as jax_predict_fn
from insarseg.parallel import replicate as jax_replicate
from insarseg.parallel import shard_batch as jax_shard_batch
from insarseg_torch.models.registry import build
from insarseg_torch.ops.layers import (
    Conv2d,
    adaptive_avg_pools,
    global_max_pool,
    max_pool_2d,
)
from insarseg_torch.ops.resize import resize_bilinear
from insarseg_torch.parallel import make_mesh, make_predict_fn, spatial
from tests.test_torch_common import CPU, make_resnet_pair, smooth

BAR = 1e-4  # x max|logit|: the port's ResNet bar
GRAD_BAR = 1e-6  # x max|value|: a slab's rows against the unsharded op's


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the layers, one thread a slab
# ---------------------------------------------------------------------------

def _slabs(fn, x, gy, n_s, whole_out=False, module=None):
    """``fn(module, slab)`` on each of ``n_s`` slabs of NCHW ``x``, one
    thread a slab under a ``ThreadComm`` (each with its own copy of
    ``module``), forward and backward: slab s's loss is its output times
    its rows of ``gy`` (``whole_out``: a map every slab holds whole,
    times ``gy`` scaled by the slab's share, the shares summing to 1).
    Returns the outputs, the input gradients joined along H and the
    modules' parameter gradients summed over the slabs."""
    h = x.shape[2] // n_s
    shared = spatial.ThreadExchange(n_s)
    outs, grads, mods, errors = {}, {}, {}, []
    total = n_s * (n_s + 1) / 2
    threads_here = torch.get_num_threads()

    def work(s):
        try:
            # the caller's thread count (a new thread's ops take every core)
            torch.set_num_threads(threads_here)
            mod = copy.deepcopy(module)
            xs = x[:, :, s * h:(s + 1) * h].clone().requires_grad_(True)
            with spatial.active(spatial.ThreadComm(shared, s, CPU)):
                y = fn(mod, xs)
                g = gy * ((s + 1) / total) if whole_out else \
                    gy[:, :, s * y.shape[2]:(s + 1) * y.shape[2]]
                (y * g).sum().backward()
            outs[s], grads[s], mods[s] = y.detach(), xs.grad, mod
        except Exception as e:  # raised below
            errors.append(e)
            shared.barrier.abort()

    threads = [threading.Thread(target=work, args=(s,)) for s in range(n_s)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    pgrads = None
    if module is not None:
        pgrads = [sum(dict(mods[s].named_parameters())[k].grad
                      for s in range(n_s))
                  for k, _ in module.named_parameters()]
    return ([outs[s] for s in range(n_s)],
            torch.cat([grads[s] for s in range(n_s)], dim=2), pgrads)


def _full(fn, x, gy, module=None):
    mod = copy.deepcopy(module)
    xr = x.clone().requires_grad_(True)
    y = fn(mod, xr)
    (y * gy).sum().backward()
    pgrads = None if mod is None else [p.grad for p in mod.parameters()]
    return y.detach(), xr.grad, pgrads


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=GRAD_BAR * float(want.abs().max()),
                               msg=what)


def _check(fn, x, n_s, module=None, whole_out=False, seed=0):
    """A sharded run of ``fn`` against the unsharded one (the module
    docstring's bars)."""
    want_y = fn(copy.deepcopy(module), x).detach()
    gy = torch.from_numpy(np.random.default_rng(seed).normal(
        size=want_y.shape).astype(np.float32))
    want_y, want_gx, want_gp = _full(fn, x, gy, module)
    ys, gx, gp = _slabs(fn, x, gy, n_s, whole_out, module)
    if whole_out:
        for s, y in enumerate(ys):
            _close(y, want_y, f"slab {s}'s whole map")
    else:
        _close(torch.cat(ys, dim=2), want_y, "the slabs' rows")
    _close(gx, want_gx, "the input gradient")
    for g, w in zip(gp or [], want_gp or []):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))
    return want_y


def _x(shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


@pytest.mark.parametrize("k,stride,n_s", [
    (7, 2, 2),   # the stem: a halo of 3 rows, 8-row slabs
    (7, 2, 8),   # ... of 2-row slabs: the halo reaches two slabs
    (3, 2, 4),   # conv2 of a strided Bottleneck
    (1, 2, 2),   # downsample.0: no halo, every other row
])
def test_strided_conv_matches_unsharded(k, stride, n_s):
    conv = Conv2d(3, 4, k, stride=stride, padding=k // 2, bias=False)
    _check(lambda m, x: m(x), _x((2, 3, 16, 10)), n_s, conv)


@pytest.mark.parametrize("n_s", [2, 4])
def test_stem_max_pool_matches_unsharded(n_s):
    """3x3 / 2, padding 1: the padding acts as -inf (every input negative
    here, so a zero halo would win the top and bottom rows' windows)."""
    x = -_x((2, 3, 16, 10)).abs() - 0.5
    _check(lambda m, x: max_pool_2d(x, 3, 2, 1), x, n_s)


@pytest.mark.parametrize("dilation,n_s", [
    (3, 4),   # a halo of 3 rows over 2-row slabs: one slab and a row
    (5, 4),   # 5 rows: past two slabs, the image's edge inside the reach
    (2, 2),   # a halo inside the 4-row slab: the one-hop form
])
def test_dilated_conv_halo_past_its_slabs(dilation, n_s):
    conv = Conv2d(3, 4, 3, padding=dilation, dilation=dilation, bias=False)
    _check(lambda m, x: m(x), _x((2, 3, 8, 6)), n_s, conv)


@pytest.mark.parametrize("n_s", [2, 4])
def test_resize_of_a_slab_matches_unsharded(n_s):
    """The final x8 up-sampling: a slab of ``8 / n_s`` rows to the slab's
    rows of the 64-row output, with the neighbours' edge rows."""
    _check(lambda m, x: resize_bilinear(x, (x.shape[2] * 8, 40)),
           _x((2, 3, 8, 5)), n_s)


def test_resize_of_a_whole_map_matches_unsharded():
    """A PSPNet bin map every slab holds whole (6 x 6) to the slab's rows
    of the 16-row output; its gradient is each slab's share."""
    x = _x((2, 3, 6, 6))
    gy = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 3, 16, 12)).astype(np.float32))
    xr = x.clone().requires_grad_(True)
    want = F.interpolate(xr, size=(16, 12), mode="bilinear",
                         align_corners=False)
    (want * gy).sum().backward()
    for n_s in (2, 4):
        h = 16 // n_s
        shared = spatial.ThreadExchange(n_s)
        outs, grads = {}, {}

        def work(s):
            xs = x.clone().requires_grad_(True)
            with spatial.active(spatial.ThreadComm(shared, s, CPU)):
                y = resize_bilinear(xs, (h, 12), replicated=True)
            (y * gy[:, :, s * h:(s + 1) * h]).sum().backward()
            outs[s], grads[s] = y.detach(), xs.grad

        threads = [threading.Thread(target=work, args=(s,))
                   for s in range(n_s)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _close(torch.cat([outs[s] for s in range(n_s)], dim=2),
               want.detach(), f"{n_s} slabs' rows")
        _close(sum(grads.values()), xr.grad, "the shares' sum")


@pytest.mark.parametrize("sizes,n_s", [
    ((1, 2, 3, 6), 4),   # 8 rows, 2-row slabs: bins 3 and 6 cross slabs
    ((2, 3, 6), 2),
    ((3, (8, 6)), 2),    # the image's own size: the gathered map
])
def test_pyramid_pools_over_slabs_match_unsharded(sizes, n_s):
    def pools(m, x):
        out = adaptive_avg_pools(x, sizes)
        return torch.cat([p.reshape(p.shape[0], p.shape[1], -1)
                          for p in out], dim=2)[:, :, None]

    _check(pools, _x((2, 3, 8, 6)), n_s, whole_out=True)


def test_global_max_with_ties_across_slabs():
    """CBAM's max-pool over 4 slabs: channel 0 all zeros (a ReLU'd dead
    channel: every position ties), channel 1 its max at three positions
    on two slabs, channel 2 one max; the gradient splits over the ties as
    ``torch.amax``'s does."""
    x = _x((2, 3, 8, 4)).abs()
    x[:, 0] = 0
    x[:, 1, 1, 2] = x[:, 1, 6, 0] = x[:, 1, 7, 3] = 9.0
    want = _check(lambda m, x: global_max_pool(x), x, 4, whole_out=True)
    assert torch.equal(want[:, 1], torch.full((2, 1, 1), 9.0))


def test_slab_rule_names_item_21c():
    """What this test once saw refused naming the slab rule now runs: a
    ResNet family at slabs off a multiple of 8 rows, and a strided conv
    and pool on an odd slab, each as unsharded. FCN-CA runs in f64 (the
    module docstring: in f32 the slabs' sums in other orders reach the
    bar). The model's weights come from a seed of their own: from torch's
    global generator they changed with the tests an xdist worker ran
    before this one."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build("fcn", "channel").eval().double()
    mesh = make_mesh(data=1, spatial=2, devices=["cpu", "cpu"])
    x = torch.from_numpy(smooth(np.random.default_rng(3), (1, 24, 16, 1)))
    f64 = torch.float64
    want = make_predict_fn(model, device="cpu", input_dtype=f64)(x)
    assert want.dtype == f64
    _close(make_predict_fn(model, mesh=mesh, input_dtype=f64)(x), want,
           "FCN-CA, 12-row slabs")
    conv = Conv2d(1, 1, 3, stride=2, padding=1)
    x = _x((1, 1, 5, 4))
    with spatial.active(spatial.ThreadComm(spatial.ThreadExchange(1), 0,
                                           CPU)):
        got = [conv(x), max_pool_2d(x, 3, 2, 1)]
    _close(got[0].detach(), conv(x).detach(), "a 3x3 / 2 conv of 5 rows")
    _close(got[1], F.max_pool2d(x, 3, 2, 1), "a 3x3 / 2 pool of 5 rows")


# ---------------------------------------------------------------------------
# DeepLabV3's forward against the JAX package's H-sharded forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def images():
    return smooth(np.random.default_rng(9), (8, 32, 32, 1))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def jax_mesh_forward(jmodel, variables, x):
    """The JAX package's forward of ``x`` on ``make_mesh(data=4,
    spatial=2)``."""
    jmesh = jax_make_mesh(data=4, spatial=2)
    return np.asarray(jax_predict_fn(jmodel, mesh=jmesh)(
        jax_replicate(variables, jmesh),
        jax_shard_batch({"image": x}, jmesh)["image"]))


def check_sharded_forward(model, want, x):
    """The port's forward over the 4 x 2 mesh against ``want`` (the
    JAX package's), the argmax form against one device's."""
    mesh = make_mesh(data=4, spatial=2, devices=["cpu"] * 8)
    got = make_predict_fn(model, mesh=mesh)(torch.from_numpy(x))
    assert got.shape == x.shape[:3] + (2,)
    assert _rel(got.numpy(), want) < BAR, _rel(got.numpy(), want)
    cls = make_predict_fn(model, argmax=True, mesh=mesh)(
        torch.from_numpy(x[:3]))
    one = make_predict_fn(model, device="cpu")(torch.from_numpy(x[:3]))
    assert cls.shape == (3,) + x.shape[1:3] and cls.dtype == torch.int32
    assert float((cls == one.argmax(-1)).float().mean()) > 0.999


@pytest.mark.parametrize("attention", ["none", "channel", "spatial"])
def test_deeplabv3_h_sharded_forward_matches_jax_mesh(attention, images):
    jmodel, v, model = make_resnet_pair("deeplabv3", attention, seed=2)
    check_sharded_forward(model, jax_mesh_forward(jmodel, v, images),
                          images)
