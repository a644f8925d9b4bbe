"""The port's ``spatial`` mesh axis in one process
(``insarseg_torch/parallel/mesh.py``, ``parallel/spatial.py``,
``parallel/inference.py``): the H axis of a batch sharded over the slabs of
a ``make_mesh(data, spatial)`` mesh, one thread a slab.

- ``make_mesh`` / ``shard_batch`` / ``slab_of`` / ``coords`` with the JAX
  helpers' semantics (``tests/test_parallel.py:108-112``): the mesh shapes,
  the errors, each device's rows and slab;
- the forward: the port's ``make_predict_fn`` over ``make_mesh(data=4,
  spatial=2, devices=["cpu"] * 8)`` against the JAX package's
  ``make_predict_fn(model, mesh=make_mesh(data=4, spatial=2))`` (the 8
  virtual CPU devices of ``tests/conftest.py``) on the same weights, U-Net
  none / CA / SA and the fast cell (base 16, 64^2, global b8: 32-row
  slabs), within atol 1e-5 (the bar of ``tests/test_parallel.py:80-93``),
  and the argmax form equal to one device's;
- the slab heights off the slab rules that the port refused before
  slabs of any height (24-row U-Net slabs, 16-row fast-cell slabs,
  12-row FCN-CA slabs) run and equal the unsharded forward; S not
  dividing H raises, as ``jax.device_put`` does; the layers that read
  across the slabs (a strided conv, a padded max-pool, a resize along H,
  an adaptive pool, the global max-pool) equal their unsharded forms on
  one slab, a failing thread raises in the caller; the packed engines
  split a spatial mesh over its data axis alone;
- the CLI: ``eval`` and ``predict`` with ``--mesh-spatial 2`` run as the
  JAX CLI's do (the spatial axis ignored); ``train --device cpu
  --mesh-spatial 2`` trains on two gloo ranks and writes the history of
  one process within rtol 1e-5; ``train --preset pspnet --mesh-spatial
  2`` (FCN-ResNet50) runs on two gloo ranks, as the JAX CLI's does.

The weights are drawn in the port (``init_weights``, numpy BN
statistics) and read into the JAX package with its importers."""

import functools
import json

import numpy as np
import pytest
import torch

from insarseg.compat.torch_io import unet_variables_from_torch
from insarseg.models.unet import UNet as JaxUNet
from insarseg.models.unet_stem import UNetFastS2D as JaxFast
from insarseg.parallel import make_mesh as jax_make_mesh
from insarseg.parallel import make_predict_fn as jax_predict_fn
from insarseg.parallel import replicate as jax_replicate
from insarseg.parallel import shard_batch as jax_shard_batch
from insarseg_torch.cli import main as port_main
from insarseg_torch.data.synthetic import make_synthetic_voc
from insarseg_torch.models.unet import UNet
from insarseg_torch.models.unet_stem import UNetFastS2D
from insarseg_torch.parallel import (
    coords,
    make_mesh,
    make_predict_fn,
    shard_batch,
    slab_of,
)
from insarseg_torch.train.engine import init_weights
from tests.test_torch_common import CPU, smooth

CPUS8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------

def test_mesh_shapes_follow_the_jax_helper():
    for data, spatial in ((-1, 4), (4, 2), (-1, 2), (1, 8), (2, 1)):
        assert make_mesh(data, spatial, devices=CPUS8).shape == \
            dict(jax_make_mesh(data=data, spatial=spatial).shape)
    mesh = make_mesh(data=-1, spatial=4, devices=CPUS8)
    assert mesh.shape == {"data": 2, "spatial": 4} and mesh.size == 8
    assert make_mesh(1, 2, devices=CPUS8).devices == (CPU, CPU)
    assert make_mesh(2, 2, devices=CPUS8).over_data().shape == \
        {"data": 2, "spatial": 1}
    with pytest.raises(AssertionError):
        jax_make_mesh(data=-1, spatial=3)
    with pytest.raises(ValueError, match="do not split"):
        make_mesh(-1, 3, devices=CPUS8)
    with pytest.raises(AssertionError):
        jax_make_mesh(data=3, spatial=4)
    with pytest.raises(ValueError, match="needs 12 devices"):
        make_mesh(3, 4, devices=CPUS8)
    with pytest.raises(ValueError, match="spatial must be >= 1"):
        make_mesh(1, 0, devices=CPUS8)


def test_shard_batch_slabs_and_coords():
    """Device (d, s) of ``shard_batch`` holds rows d of the data axis and
    slab s of their H, as the JAX sharding's addressable shards do."""
    mesh = make_mesh(data=2, spatial=2, devices=["cpu"] * 4)
    image = np.arange(4 * 8 * 2, dtype=np.float32).reshape(4, 8, 2, 1)
    mask = np.arange(4 * 8 * 2, dtype=np.int32).reshape(4, 8, 2)
    batch = {"image": image, "mask": mask, "n_valid": 4}
    ours = shard_batch(batch, mesh)
    theirs = jax_shard_batch(batch, jax_make_mesh(data=2, spatial=2))
    assert ours["n_valid"] == 4
    for k in ("image", "mask"):
        assert len(ours[k]) == 4
        shards = {(s.index[0].start or 0, s.index[1].start or 0):
                  np.asarray(s.data) for s in
                  theirs[k].addressable_shards}
        for i, part in enumerate(ours[k]):
            d, s = coords(2, i)
            np.testing.assert_array_equal(
                part.numpy(), shards[(2 * d, 4 * s)], err_msg=f"{k} {i}")
    assert slab_of(64, 1, 2) == slice(32, 64)
    assert [coords(2, r) for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    with pytest.raises(ValueError, match="3 equal slabs"):
        slab_of(64, 0, 3)


# ---------------------------------------------------------------------------
# the forward against the JAX package's H-sharded make_predict_fn
# ---------------------------------------------------------------------------

def _with_stats(model, seed):
    """``model`` drawn from ``seed`` with numpy BN running statistics (a
    fresh init's 0 / 1 would hide the eval-mode BN)."""
    init_weights(model, seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    return model


def _jax_pair(kind):
    """The port's module and the JAX module with its variables, the same
    weights."""
    use_se, use_sa = kind in ("ca", "fast"), kind == "sa"
    if kind == "fast":
        model = _with_stats(UNetFastS2D(2, 16, use_se=True), 4)
        sd = {k[len("unet."):]: v.numpy()
              for k, v in model.state_dict().items()}
        inner = unet_variables_from_torch(sd, use_se=True)
        jv = {c: {"unet": inner[c]} for c in ("params", "batch_stats")}
        return model, JaxFast(num_classes=2, level1_features=16,
                              use_se=True), jv
    model = _with_stats(UNet(2, 16, use_se=use_se, use_sa=use_sa), 4)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jv = unet_variables_from_torch(sd, use_se=use_se, use_sa=use_sa)
    return model, JaxUNet(num_classes=2, base_features=16, use_se=use_se,
                          use_sa=use_sa), jv


@pytest.mark.parametrize("kind", ["none", "ca", "sa", "fast"])
def test_h_sharded_forward_matches_jax_mesh(kind):
    model, jmodel, jv = _jax_pair(kind)
    x = smooth(np.random.default_rng(9), (8, 64, 64, 1))
    jmesh = jax_make_mesh(data=4, spatial=2)
    want = np.asarray(jax_predict_fn(jmodel, mesh=jmesh)(
        jax_replicate(jv, jmesh), jax_shard_batch({"image": x},
                                                  jmesh)["image"]))
    mesh = make_mesh(data=4, spatial=2, devices=CPUS8)
    got = make_predict_fn(model, mesh=mesh)(torch.from_numpy(x))
    assert got.shape == (8, 64, 64, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    one = make_predict_fn(model, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0, atol=1e-5)
    # the argmax form, and an uneven data split (3 rows over 4)
    cls = make_predict_fn(model, argmax=True, mesh=mesh)(
        torch.from_numpy(x[:3]))
    assert cls.shape == (3, 64, 64) and cls.dtype == torch.int32
    agree = (cls == one[:3].argmax(-1)).float().mean()
    assert float(agree) > 0.999


def test_slab_rules_and_resnet_raise():
    """The geometries that raised naming the slab rules before slabs of
    any height now run and equal the unsharded forward; S not dividing H
    still raises."""
    mesh = make_mesh(data=1, spatial=2, devices=["cpu", "cpu"])
    rng = np.random.default_rng(5)

    def same(model, shape, bar):
        x = torch.from_numpy(smooth(rng, shape))
        got = make_predict_fn(model, mesh=mesh)(x)
        want = make_predict_fn(model, device="cpu")(x)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=bar * float(want.abs().max()))

    unet = _with_stats(UNet(2, 8), 0)
    same(unet, (1, 48, 32, 1), 1e-5)  # 24-row slabs
    fast = _with_stats(UNetFastS2D(2, 8), 0)
    same(fast, (1, 32, 32, 1), 1e-5)  # 16-row slabs
    with pytest.raises(ValueError, match="equal slabs"):
        make_predict_fn(unet, mesh=make_mesh(1, 3, devices=["cpu"] * 3))(
            torch.zeros(1, 64, 32, 1))
    from insarseg_torch.models.registry import build, check_spatial

    for name in ("deeplabv3", "fcn", "pspnet", "unet-fast"):
        check_spatial(name)
    with pytest.raises(NotImplementedError, match="registry's families"):
        check_spatial(torch.nn.Conv2d(1, 1, 1))
    fcn = init_weights(build("fcn", "channel"), 0)
    same(fcn, (1, 24, 32, 1), 1e-4)  # 12-row slabs
    same(fcn, (2, 32, 32, 1), 1e-4)


def test_layers_refuse_what_crosses_slabs():
    """The layers that read across the slabs (a strided conv, a padded
    max-pool, a resize along H, an adaptive pool, the global max-pool),
    which raised naming item 21b before the ResNet families shard H, run
    their sharded forms under a spatial context; on one slab they equal
    the unsharded ops (``tests/test_torch_spatial_resnet.py`` holds them
    over several slabs). A stride-1 "same" conv and the slab-local ops
    run too."""
    import torch.nn.functional as F

    from insarseg_torch.ops.layers import (
        Conv2d,
        adaptive_avg_pools,
        global_max_pool,
        max_pool_2d,
    )
    from insarseg_torch.ops.resize import resize_bilinear
    from insarseg_torch.parallel import spatial

    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2, 8, 8)).astype(np.float32))
    strided = Conv2d(2, 2, 3, stride=2, padding=1)
    cases = [(lambda: strided(x),
              lambda: F.conv2d(x, strided.weight, strided.bias, 2, 1)),
             (lambda: max_pool_2d(x, 3, 2, 1),
              lambda: F.max_pool2d(x, 3, 2, 1)),
             (lambda: resize_bilinear(x, (16, 16)),
              lambda: F.interpolate(x, size=(16, 16), mode="bilinear",
                                    align_corners=False)),
             (lambda: adaptive_avg_pools(x, [2])[0],
              lambda: F.adaptive_avg_pool2d(x, 2)),
             (lambda: global_max_pool(x),
              lambda: x.amax(dim=(2, 3), keepdim=True))]
    with spatial.active(spatial.ThreadComm(spatial.ThreadExchange(1), 0,
                                           CPU)):
        got = [fn() for fn, _ in cases]
        conv = Conv2d(2, 3, 3, padding=1)
        torch.testing.assert_close(conv(x), F.conv2d(x, conv.weight,
                                                     conv.bias, padding=1))
    # another image (the context keys its maps by their width)
    with spatial.active(spatial.ThreadComm(spatial.ThreadExchange(1), 0,
                                           CPU)):
        assert resize_bilinear(x, (8, 16)).shape == (1, 2, 8, 16)
    for g, (_, plain) in zip(got, cases):
        want = plain().detach()
        torch.testing.assert_close(g, want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()))


def test_a_failing_slab_raises_in_the_caller():
    """One slab's error breaks its row's barrier: the other slab stops
    waiting and the caller gets the error."""
    from insarseg_torch.parallel import spatial_engine

    mesh = make_mesh(data=1, spatial=2, devices=["cpu", "cpu"])

    def ok(x):
        from insarseg_torch.parallel import spatial

        return spatial.current().sum(x)

    def bad(x):
        raise RuntimeError("slab 1 failed")

    with pytest.raises(RuntimeError, match="slab 1 failed"):
        spatial_engine([ok, bad], mesh)(torch.zeros(1, 4, 4, 1))


def test_thread_comm_under_switching_stress():
    """16 slab threads (more than the cores) with a short switch interval,
    200 rounds of ``gather`` (slab s posting s % 3 rows) and ``sum``:
    every thread gets every slab's rows of that round and the round's
    sum, and every thread ends."""
    import sys
    import threading

    from insarseg_torch.parallel import spatial

    n, rounds = 16, 200
    shared = spatial.ThreadExchange(n)
    bad = []

    def work(s):
        try:
            comm = spatial.ThreadComm(shared, s, CPU)
            for r in range(rounds):
                up = torch.full((1, 1, s % 3, 1), float(1000 * r + s))
                got = comm.gather(up, [i % 3 for i in range(n)])
                if [tuple(g.shape) for g in got] != \
                        [(1, 1, i % 3, 1) for i in range(n)] or any(
                            bool((g != 1000 * r + i).any())
                            for i, g in enumerate(got)):
                    bad.append((s, r))
                one = torch.full((1,), float(1000 * r + s))
                if float(comm.sum(one)) != \
                        sum(1000 * r + i for i in range(n)):
                    bad.append((s, r, "sum"))
        except Exception as e:  # counted below
            bad.append((s, repr(e)))
            shared.barrier.abort()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,))
                   for s in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def test_packed_engines_split_over_data_alone(monkeypatch):
    """Given a spatial mesh, the serve and int8 engines split the batch
    over its data axis (``jit_engine``'s ``spatial_axis=None``): a serve
    engine over make_mesh(2, 2) runs on two replicas and equals one
    device."""
    from insarseg_torch import engines

    sizes = []
    real = engines.mesh_engine

    def spy(predicts, mesh):
        sizes.append(mesh.shape)
        return real(predicts, mesh)

    monkeypatch.setattr(engines, "mesh_engine", spy)
    model = _with_stats(UNet(2, 16, use_se=True), 2)
    x = torch.from_numpy(smooth(np.random.default_rng(3), (4, 32, 32, 1)))
    mesh = make_mesh(data=2, spatial=2, devices=["cpu"] * 4)
    got = engines.make_engine("unet", "channel", model, engine="serve",
                              mesh=mesh)(x)
    want = engines.make_engine("unet", "channel", model, engine="serve",
                               device="cpu")(x)
    assert sizes == [{"data": 2, "spatial": 1}]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

BASE = ["--preset", "unet-channelattention", "--image-size", "32",
        "--batch-size", "4", "--voc-root", "voc"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("torch_spatial_cli")
    make_synthetic_voc(str(d / "voc"), n_train=6, n_val=3, size=32)
    rng = np.random.default_rng(0)
    Image.fromarray((rng.random((48, 48)) * 255).astype(np.uint8),
                    "L").save(str(d / "scene.png"))
    return d


@pytest.fixture
def cwd(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    return workdir


@pytest.fixture
def narrow(monkeypatch):
    """The registry's U-Net at base 16 (in this process only)."""
    from insarseg_torch.models import registry

    monkeypatch.setattr(registry, "UNet",
                        functools.partial(registry.UNet, base_features=16))


def port(*argv):
    return port_main([*argv, "--device", "cpu"])


def _train(tag, *flags):
    hist = f"h{tag}.json"
    assert port("train", *BASE, "--num-epochs", "1", "--model-save-path",
                f"m{tag}/best.ckpt", "--metrics-save-path", hist,
                *flags) == 0
    with open(hist) as f:
        return json.load(f)


def test_cli_train_mesh_spatial_matches_one_process(cwd):
    """``train --mesh-spatial 2`` (two gloo ranks, 16-row slabs of the
    32^2 tiles; the ranks build the published width, as a fresh process
    does) writes the history of ``--mesh-spatial 1`` within rtol 1e-5."""
    two = _train("s2", "--mesh-spatial", "2")
    one = _train("s1", "--mesh-spatial", "1", "--mesh-data", "1")
    assert [sorted(h) for h in two] == [sorted(h) for h in one]
    for h, w in zip(two, one):
        for k, v in w.items():
            assert h[k] == pytest.approx(v, rel=1e-5), k


@pytest.mark.parametrize("command", ["eval", "predict"])
def test_cli_eval_predict_ignore_mesh_spatial(cwd, narrow, command,
                                              capsys):
    """As the JAX CLI: ``eval`` and ``predict`` run with ``--mesh-spatial
    2`` and print or write what they do without it."""
    if command == "eval":
        argv = ["eval", *BASE, "--split", "val"]
    else:
        argv = ["predict", *BASE, "--input", "scene.png", "--tile", "32",
                "--overlap", "8", "--output", "p.png"]
    outs = []
    for flags in ([], ["--mesh-spatial", "2"]):
        capsys.readouterr()
        assert port(*argv, *flags) == 0
        if command == "eval":
            outs.append(capsys.readouterr().out.strip().splitlines()[-1])
        else:
            from PIL import Image

            outs.append(np.asarray(Image.open("p.png")))
    if command == "eval":
        assert outs[0] == outs[1]
    else:
        np.testing.assert_array_equal(outs[0], outs[1])


def test_cli_train_resnet_mesh_spatial_raises(cwd):
    """``train --preset pspnet --mesh-spatial 2`` (FCN-ResNet50, which
    raised naming item 21b before the ResNet families shard H) trains on
    two gloo ranks, as the JAX CLI's does: a finite history and rank 0's
    checkpoint."""
    assert port("train", "--preset", "pspnet", "--image-size", "32",
                "--batch-size", "4", "--num-epochs", "1", "--voc-root",
                "voc", "--model-save-path", "psp/best.ckpt",
                "--metrics-save-path", "hpsp.json", "--mesh-spatial",
                "2") == 0
    with open("hpsp.json") as f:
        hist = json.load(f)
    assert [h["epoch"] for h in hist] == [1]
    assert np.isfinite([hist[0]["train_loss"], hist[0]["val_loss"]]).all()
    assert any((cwd / "psp").iterdir())
