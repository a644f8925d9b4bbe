"""The ``spatial`` mesh axis at slab heights of any size
(``insarseg_torch/parallel/spatial.py``: row ranges, the halo of any
reach, empty slabs), in one process, one thread a slab:

- the forward: the port's ``make_predict_fn`` over ``make_mesh(data,
  spatial, devices=["cpu"] * n)`` against the JAX package's
  ``make_predict_fn(model, mesh=make_mesh(data, spatial))`` (the 8
  virtual CPU devices of ``tests/conftest.py``; GSPMD pads) on the same
  weights, within atol 1e-5 (``tests/test_parallel.py:80-93``): the JAX
  test's own geometry (``UNet(base_features=4)`` at 16^2, global b8,
  data 4 x spatial 2: 8-row slabs, half a row a slab at the
  bottleneck); U-Net-CA base 16 at 96x32 over 4 slabs (24 rows), 80x32
  over 8 (10 rows: the bottleneck's 5 rows leave three slabs empty) and
  100x32 over 4 (25 rows: ``shape_fix`` at the odd levels); the fast
  cell (U-Net-fast-CA, level 1 = 16) at 96x64 over 8 (12-row slabs,
  space-to-depth by 2 after a re-slab);
- the layers over slabs of given uneven bounds, one of them empty and
  one a single row (13 rows over 4 slabs): stride-1, strided and
  dilated convs, the 3x3 / 2 and 2x2 / 2 max-pools (an odd map drops its
  last row), the 2x2 / 2 transposed conv, the SE squeeze's mean over the
  whole map, the pyramid pools at bins 2 / 3 / 6 and at the map's own
  size, the global average and max (an empty slab gives the max's
  identity), both resizes, a re-slab and ``halo`` with other counts
  above and below: each slab's output its rows of the unsharded op's
  (a replicated map, the whole of it), the input gradients joined over
  the slabs the unsharded op's (each slab's loss a share of a whole
  map's gradient), within 1e-6 x the tensor's largest value; the weight
  gradients summed over the slabs, within rtol 1e-5.

The weights are drawn in the port (numpy BN statistics) and read into the
JAX package with its importers."""

import copy
import math
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from insarseg.compat.torch_io import unet_variables_from_torch
from insarseg.models.unet import UNet as JaxUNet
from insarseg.models.unet_stem import UNetFastS2D as JaxFast
from insarseg.parallel import make_mesh as jax_make_mesh
from insarseg.parallel import make_predict_fn as jax_predict_fn
from insarseg.parallel import replicate as jax_replicate
from insarseg.parallel import shard_batch as jax_shard_batch
from insarseg_torch.models.unet import UNet
from insarseg_torch.models.unet_stem import UNetFastS2D
from insarseg_torch.ops.blocks import SELayer
from insarseg_torch.ops.layers import (
    Conv2d,
    ConvTranspose2d,
    adaptive_avg_pools,
    global_avg_pool,
    global_max_pool,
    max_pool_2d,
)
from insarseg_torch.ops.resize import resize_bilinear
from insarseg_torch.parallel import make_mesh, make_predict_fn, spatial
from tests.test_torch_common import CPU, smooth
from tests.test_torch_spatial import _with_stats

GRAD_BAR = 1e-6  # x max|value|: a slab's rows against the unsharded op's
# 13 rows over 4 slabs: 5, none, 1, 7
BOUNDS = (0, 5, 5, 6, 13)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the forward against the JAX package's H-sharded make_predict_fn
# ---------------------------------------------------------------------------

def _pair(kind, base):
    """The port's module, the JAX module and its variables: ``kind`` none
    / ca (U-Net) or fast (U-Net-fast-CA), the same weights."""
    if kind == "fast":
        model = _with_stats(UNetFastS2D(2, base, use_se=True), 4)
        sd = {k[len("unet."):]: v.numpy()
              for k, v in model.state_dict().items()}
        inner = unet_variables_from_torch(sd, use_se=True)
        jv = {c: {"unet": inner[c]} for c in ("params", "batch_stats")}
        return model, JaxFast(num_classes=2, level1_features=base,
                              use_se=True), jv
    use_se = kind == "ca"
    model = _with_stats(UNet(2, base, use_se=use_se), 4)
    jv = unet_variables_from_torch(
        {k: v.numpy() for k, v in model.state_dict().items()},
        use_se=use_se)
    return model, JaxUNet(num_classes=2, base_features=base,
                          use_se=use_se), jv


@pytest.mark.parametrize("kind, base, shape, data, n_s", [
    ("none", 4, (8, 16, 16), 4, 2),
    ("ca", 16, (2, 96, 32), 2, 4),
    ("ca", 16, (1, 80, 32), 1, 8),
    ("ca", 16, (2, 100, 32), 2, 4),
    ("fast", 16, (1, 96, 64), 1, 8),
], ids=["jax-test-16x16-4x2", "ca-96-over-4", "ca-80-over-8",
        "ca-100-over-4", "fast-96-over-8"])
def test_uneven_forward_matches_jax_mesh(kind, base, shape, data, n_s):
    model, jmodel, jv = _pair(kind, base)
    x = smooth(np.random.default_rng(11), shape + (1,))
    jmesh = jax_make_mesh(data=data, spatial=n_s)
    want = np.asarray(jax_predict_fn(jmodel, mesh=jmesh)(
        jax_replicate(jv, jmesh), jax_shard_batch({"image": x},
                                                  jmesh)["image"]))
    mesh = make_mesh(data=data, spatial=n_s, devices=["cpu"] * (data * n_s))
    got = make_predict_fn(model, mesh=mesh)(torch.from_numpy(x))
    assert got.shape == shape + (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the layers over slabs of uneven bounds
# ---------------------------------------------------------------------------

def _uneven(fn, x, grad_of, bounds=BOUNDS, module=None, places=()):
    """``fn(module, slab)`` on the slabs of NCHW ``x`` cut at ``bounds``
    (placed as ``x``'s map, and each (width, bounds) of ``places`` as
    another map), one thread a slab under a ``ThreadComm``, forward and
    backward: slab s's loss is its output times ``grad_of(s, y, comm)``.
    Returns the outputs, the input gradients joined along H and the
    modules' parameter gradients summed over the slabs."""
    rows = spatial.Rows(tuple(bounds))
    n_s = rows.size
    shared = spatial.ThreadExchange(n_s)
    outs, grads, mods, errors = {}, {}, {}, []

    def work(s):
        try:
            mod = copy.deepcopy(module)
            comm = spatial.ThreadComm(shared, s, CPU)
            spatial.place(comm, x.shape[3], rows)
            for width, other in places:
                spatial.place(comm, width, spatial.Rows(other))
            a, b = rows.of(s)
            xs = x[:, :, a:b].clone().requires_grad_(True)
            with spatial.active(comm):
                y = fn(mod, xs)
                (y * grad_of(s, y, comm)).sum().backward()
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


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=GRAD_BAR * float(want.abs().max()),
                               msg=what)


def _x(shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _check(fn, x, module=None, whole=False, places=(), seed=0):
    """The uneven sharded run of ``fn`` against the unsharded one: slab
    s's loss takes its rows of the output gradient (by the rows the op
    placed), or with ``whole`` (a map every slab holds) a share of it,
    the shares summing to 1."""
    want_y = fn(copy.deepcopy(module), x).detach()
    gy = _x(want_y.shape, seed)
    mod = copy.deepcopy(module)
    xr = x.clone().requires_grad_(True)
    (fn(mod, xr) * gy).sum().backward()
    n_s = len(BOUNDS) - 1

    def grad_of(s, y, comm):
        if whole:
            return gy * ((s + 1) / (n_s * (n_s + 1) / 2))
        c, d = spatial.rows_of(y, comm).of(s)
        return gy[:, :, c:d]

    ys, gx, gp = _uneven(fn, x, grad_of, module=module, places=places)
    if whole:
        for s, y in enumerate(ys):
            _close(y, want_y, f"slab {s}'s whole map")
    else:
        _close(torch.cat(ys, dim=2), want_y, "the slabs' rows")
    _close(gx, xr.grad, "the input gradient")
    for g, w in zip(gp or [], [] if mod is None else
                    [p.grad for p in mod.parameters()]):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))
    return want_y


@pytest.mark.parametrize("kernel, stride, dilation", [
    (3, 1, 1), (3, 2, 1), (7, 2, 1), (1, 2, 1), (3, 1, 4), (1, 1, 1)],
    ids=["3x3", "3x3-s2", "7x7-s2", "1x1-s2", "3x3-d4", "1x1"])
def test_conv_over_uneven_slabs(kernel, stride, dilation):
    conv = Conv2d(3, 4, kernel, stride=stride,
                  padding=dilation * (kernel - 1) // 2, dilation=dilation)
    _check(lambda m, t: m(t), _x((2, 3, 13, 6)), module=conv)


@pytest.mark.parametrize("window, stride, padding", [(3, 2, 1), (2, 2, 0)],
                         ids=["3x3-s2-p1", "2x2-s2"])
def test_max_pool_over_uneven_slabs(window, stride, padding):
    want = _check(lambda m, t: max_pool_2d(t, window, stride, padding),
                  _x((2, 3, 13, 6)))
    assert want.shape[2] == (13 + 2 * padding - window) // stride + 1


def test_transposed_conv_and_reslab_over_uneven_slabs():
    """The 2x2 / 2 transposed conv on each slab (the empty one too) gives
    the rows twice its own; a re-slab moves them to other bounds."""
    up = ConvTranspose2d(3, 2, 2, stride=2)

    def fn(m, t):
        comm = spatial.current()
        if comm is None:
            return m(t)
        src = spatial.rows_of(t, comm)
        return spatial.reslab(m(t), src.scaled(2), spatial.Rows(dst), comm)

    dst = (0, 9, 9, 10, 26)
    _check(fn, _x((2, 3, 13, 6)), module=up, places=((12, dst),))


def test_means_and_pools_over_uneven_slabs():
    """The SE squeeze (a mean over the whole map), the global average and
    max (a slab of no row gives the max's identity) and the pyramid
    pools, whose bins follow the global rows."""
    x = _x((2, 16, 13, 6))
    se = SELayer(16)
    _check(lambda m, t: m(t), x, module=se)
    _check(lambda m, t: global_avg_pool(t), x, whole=True)
    x[:, 0] = 0  # every position ties
    _check(lambda m, t: global_max_pool(t), x, whole=True)
    for size in (2, 3, 6, (13, 6)):
        _check(lambda m, t: adaptive_avg_pools(t, [size])[0], x, whole=True)


def test_resizes_over_uneven_slabs():
    """A slab to its rows of a 30 x 20 map of other bounds (the rows past
    the slab from a halo), and a whole 6 x 6 map to those rows."""
    out = (0, 9, 9, 17, 30)
    rows = spatial.Rows(out)

    def size():
        comm = spatial.current()
        if comm is None:
            return 30, 20
        a, b = rows.of(comm.index)
        return b - a, 20

    _check(lambda m, t: resize_bilinear(t, size()),
           _x((2, 3, 13, 6)), places=((20, out),))
    whole = _x((2, 3, 6, 6))
    want = F.interpolate(whole, size=(30, 20), mode="bilinear",
                         align_corners=False)
    ys, _, _ = _uneven(
        lambda m, t: resize_bilinear(whole, size(),
                                     replicated=True) + 0 * t.sum(),
        _x((2, 3, 13, 6)), lambda s, y, comm: 1.0, places=((20, out),))
    _close(torch.cat(ys, dim=2), want, "the whole map's rows")


@pytest.mark.parametrize("fill", [0.0, -math.inf], ids=["zeros", "-inf"])
def test_halo_of_other_counts_above_and_below(fill):
    """Each slab asks its own rows above and below, past the empty slab
    and the one-row slab: the rows of the full map padded with ``fill``;
    each row's gradient summed over every slab that read it."""
    need = ((2, 7), (3, 3), (6, 1), (4, 2))
    x = _x((2, 3, 13, 5))
    rows = spatial.Rows(BOUNDS)
    spans = [(8 + a - u, 8 + b + d)
             for (a, b), (u, d) in zip(map(rows.of, range(4)), need)]
    wants = [F.pad(x, (0, 0, 8, 8), value=fill)[:, :, i:j] for i, j in spans]
    gys = [_x(w.shape, 3 + s) for s, w in enumerate(wants)]
    xr = x.clone().requires_grad_(True)
    padded = F.pad(xr, (0, 0, 8, 8))
    sum((padded[:, :, i:j] * g).sum()
        for (i, j), g in zip(spans, gys)).backward()
    ys, gx, _ = _uneven(
        lambda m, t: spatial.halo(t, need, spatial.current(), fill), x,
        lambda s, y, comm: gys[s])
    for s, (y, w) in enumerate(zip(ys, wants)):
        assert torch.equal(y, w), s
    _close(gx, xr.grad, "the input gradient")
