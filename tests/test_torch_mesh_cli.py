"""The port's CLI on a data mesh with ``--device cpu`` (``insarseg_torch/
cli.py``): ``train --mesh-data 2`` starts two gloo ranks
(``parallel.launch``; the ranks build the published U-Net, base 64, as a
fresh process does) and writes the history of ``train --mesh-data 1``
within rtol 1e-5, its checkpoints once, and so does ``train`` under
``torchrun`` (two CPU ranks, ``--standalone``); ``--device cuda:K
--mesh-data N`` takes N cards from K on, each rank on its own (the card
count patched); ``eval --mesh-data 2`` over two
CPU replicas of the int8 engine prints the metrics of one device, equal;
``predict --mesh-data 2`` (and ``--stream``) writes the PNG of one device,
equal. The in-process cases build U-Net base 16 through the registry, as
``tests/test_torch_cli.py`` does, with torch on one thread."""

import ast
import functools
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from insarseg_torch.cli import main as port_main
from insarseg_torch.data.synthetic import make_synthetic_voc

BASE = ["--preset", "unet-channelattention", "--image-size", "32",
        "--batch-size", "4", "--voc-root", "voc"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("torch_mesh_cli")
    make_synthetic_voc(str(d / "voc"), n_train=6, n_val=3, size=32)
    rng = np.random.default_rng(0)
    scene = (rng.random((64, 80)) * 255).astype(np.uint8)
    Image.fromarray(scene, "L").save(str(d / "scene.png"))
    np.save(str(d / "scene.npy"), scene)
    return d


@pytest.fixture(autouse=True)
def cwd(workdir, monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.chdir(workdir)
    yield workdir
    torch.set_num_threads(n)


@pytest.fixture
def narrow(monkeypatch):
    from insarseg_torch.models import registry

    monkeypatch.setattr(registry, "UNet",
                        functools.partial(registry.UNet, base_features=16))


def port(*argv):
    return port_main([*argv, "--device", "cpu"])


@pytest.fixture
def meshes(monkeypatch):
    """The sizes of the meshes the engines are built over."""
    from insarseg_torch import engines

    sizes = []

    def spy(predicts, mesh):
        sizes.append(mesh.size)
        return real(predicts, mesh)

    real = engines.mesh_engine
    monkeypatch.setattr(engines, "mesh_engine", spy)
    return sizes


def _train(cwd, tag, *flags, torchrun=False):
    hist = f"h{tag}.json"
    argv = ["train", *BASE, "--num-epochs", "1", "--model-save-path",
            f"m{tag}/best.ckpt", "--metrics-save-path", hist, *flags]
    if torchrun:
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "GLOO_SOCKET_IFNAME": "lo",
               "PYTHONPATH": str(Path(__file__).resolve().parents[1])}
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "insarseg_torch.cli", *argv,
             "--device", "cpu"], cwd=cwd, env=env, check=True, timeout=600,
            capture_output=True, text=True).stdout
        # one run of two ranks: rank 0 alone reports
        assert out.count(f"history saved to {hist}") == 1, out
    else:
        assert port(*argv) == 0
    assert sorted(p.name for p in (cwd / f"m{tag}" / "best").iterdir()) \
        == ["best.pt", "best_miou.json", "latest.pt"]
    return json.loads((cwd / hist).read_text())


@pytest.fixture(scope="module")
def one_process(workdir):
    """``train --mesh-data 1``'s history (the published U-Net, base 64)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return _train(workdir, "1", "--mesh-data", "1")
    finally:
        os.chdir(cwd)
        torch.set_num_threads(n)


def _same_history(got, want):
    assert [h["epoch"] for h in got] == [1]
    for k, v in want[0].items():
        assert got[0][k] == pytest.approx(v, rel=1e-5), k


def test_train_on_two_ranks(cwd, one_process):
    _same_history(_train(cwd, "2", "--mesh-data", "2"), one_process)


def test_train_under_torchrun(cwd, one_process):
    """Each rank that torchrun starts joins its group from the environment
    and runs ``train`` as one rank of the mesh."""
    _same_history(_train(cwd, "t", torchrun=True), one_process)


def test_named_card_starts_the_mesh(cwd, monkeypatch):
    """``--device cuda:1 --mesh-data 2`` on four cards: ranks on cuda:1 and
    cuda:2, each training on its own; -1 with a named card pins it; more
    cards than there are from K on raises."""
    from insarseg_torch import cli
    from insarseg_torch.config import get_preset
    from insarseg_torch.parallel import mesh as P

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = [torch.device("cuda", i) for i in range(4)]

    def devices(n, dev):
        return cli._mesh_devices(get_preset("unet", mesh_data=n),
                                 torch.device(dev))

    assert devices(2, "cuda:1") == cuda[1:3]
    assert devices(-1, "cuda:1") == cuda[1:2]
    assert devices(1, "cuda:2") == cuda[2:3]
    assert devices(-1, "cuda") == cuda
    assert devices(3, "cuda") == cuda[:3]
    with pytest.raises(ValueError, match="needs 4 devices; 3 are given"):
        devices(4, "cuda:1")
    ran = []

    def launch(fn, n, devs, args):
        assert devs == cuda[1:3]
        for r in range(n):
            monkeypatch.setattr(P, "rank", lambda r=r: r)
            fn(*args)

    monkeypatch.setattr(P, "launch", launch)
    monkeypatch.setattr(cli, "_train", lambda args, cfg, dev: ran.append(dev))
    assert port_main(["train", *BASE, "--device", "cuda:1", "--mesh-data",
                      "2"]) == 0
    assert ran == cuda[1:3]


def _metrics(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert port(*argv) == 0
    return ast.literal_eval(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.usefixtures("narrow")
def test_eval_over_two_replicas(cwd, meshes):
    got = {n: _metrics(["eval", *BASE, "--engine", "int8", "--mesh-data",
                        n]) for n in ("1", "2")}
    assert meshes == [2]
    assert got["1"] == got["2"]
    assert np.isfinite(got["2"]["val_loss"])


@pytest.mark.usefixtures("narrow")
@pytest.mark.parametrize("scene,flags", [("scene.png", []),
                                         ("scene.npy", ["--stream"])],
                         ids=["in-memory", "stream"])
def test_predict_over_two_replicas(cwd, meshes, scene, flags):
    from PIL import Image

    png = {}
    for n in ("1", "2"):
        out = f"pred{n}.png"
        assert port("predict", *BASE, "--engine", "int8", "--input", scene,
                    "--tile", "32", "--overlap", "8", "--tile-batch", "5",
                    "--mesh-data", n, "--output", out, *flags) == 0
        png[n] = np.asarray(Image.open(cwd / out))
    assert meshes == [2]
    assert png["1"].shape == (64, 80)
    np.testing.assert_array_equal(png["2"], png["1"])
