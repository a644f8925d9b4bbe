"""Guards of the port's boundaries: insarseg_torch (its CLI and data path,
the streaming module among them, included, and chip_smoke.py and tools/)
import nothing of JAX or of the JAX package, the native loader builds the
port's own ``insarseg_torch/csrc/tileops.cpp``, entry points (the CLI
among them) default to CUDA and raise without a card, and chip_smoke.py
refuses to run without one."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "insarseg_torch"
FORBIDDEN = ("jax", "flax", "insarseg", "jaxlib", "optax", "orbax")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_insarseg_imports_in_port():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "tools").glob("*.py"))
    for module in ("cli.py", "data/serve.py", "data/stitch.py",
                   "kernels/sa_train.py"):
        assert PORT / module in files, module
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'jaxlib'):\n"
        "    sys.modules[m] = None\n"
        "import insarseg_torch\n"
        "for info in pkgutil.walk_packages(insarseg_torch.__path__,\n"
        "                                  'insarseg_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'insarseg' or m.startswith('insarseg.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    from insarseg_torch.config import Config
    from insarseg_torch.data.serve import stream_scene_inference
    from insarseg_torch.data.stitch import sliding_window_inference
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.engines import make_engine
    from insarseg_torch.models.resnet_int8 import pack_resnet_int8
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.models.unet_int8 import pack_unet_int8
    from insarseg_torch.models.unet_s2d import make_s2d_predict_fn
    from insarseg_torch.models.unet_stem import UNetFastS2D
    from insarseg_torch.parallel.inference import make_predict_fn
    from insarseg_torch.train.engine import (
        create_state,
        fit,
        make_engine_eval_step,
    )

    model = UNet(base_features=16, use_se=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine("unet", "channel", model, None, "serve")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine("unet", "spatial", UNet(base_features=16, use_sa=True),
                    None, "serve")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_s2d_predict_fn(model.state_dict())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine("unet-fast", "channel", UNetFastS2D(level1_features=16,
                                                        use_se=True),
                    None, "serve")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_unet_int8(model.state_dict(),
                       [np.zeros((1, 32, 32, 1), np.float32)])
    for name in ("deeplabv3", "fcn", "pspnet"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_engine(name, "channel", torch.nn.Identity(), None, "serve")
    for engine in ("module", "int8"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_engine("pspnet", "spatial", torch.nn.Identity(), None,
                        engine, calib_batches=[np.zeros((1, 32, 32, 1))])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_state(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(model, Config(), [synthetic_batch(1, 16)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine_eval_step(lambda t: t, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_resnet_int8({}, [np.zeros((1, 32, 32, 1), np.float32)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_predict_fn(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sliding_window_inference(lambda t: t, np.zeros((32, 32, 1)), 32, 0)
    for device_stitch in (True, False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stream_scene_inference(lambda t: t, np.zeros((32, 32)),
                                   (32, 32), 1, 32, 0,
                                   device_stitch=device_stitch)


def test_kernel_wrappers_refuse_other_devices():
    from insarseg_torch.kernels import (
        conv_i8,
        maxpool2x2_i8,
        maxpool_exit_s2d_i8,
        sa_gate_i8,
        sa_stats_i8,
        se_residual_i8,
        stem_pool_i8,
        up_concat_i8,
    )

    q = torch.zeros((1, 2, 2, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        maxpool2x2_i8(q)
    for fn, args in ((maxpool_exit_s2d_i8, ()), (sa_stats_i8, (1.0,)),
                     (sa_gate_i8, (None,))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, *args)
    with pytest.raises(ValueError, match="unsupported device"):
        conv_i8(q, torch.zeros((16, 1, 1, 16), dtype=torch.int8), None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        se_residual_i8(q, None, q, 1.0, 1.0)
    y = torch.zeros((1, 16, 2, 2), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        stem_pool_i8(y, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        up_concat_i8(y, None, None, q, 1.0)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_port_reads_its_own_native_source():
    from insarseg_torch.data import native_loader

    assert native_loader.SOURCE == PORT / "csrc" / "tileops.cpp"
    assert native_loader.SOURCE.is_file()
    assert native_loader.BUILD_ROOT == PORT / "_build"
    for f in PORT.rglob("*.py"):
        assert "insarseg/native" not in f.read_text(), f


@pytest.mark.parametrize("argv", [
    ["train", "--voc-root", "voc"],
    ["eval", "--voc-root", "voc"],
    ["predict", "--input", "scene.png"],
    ["predict", "--input", "scene.npy", "--stream"],
    ["export-torch", "--output", "x.pth"],
])
def test_cli_without_a_card_exits_with_the_no_cuda_error(argv, tmp_path,
                                                         monkeypatch):
    """Without --device cpu the CLI runs on cuda: without a card every
    command stops before any work, with the port's error, and writes
    nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from insarseg_torch.cli import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([argv[0], "--preset", "unet", *argv[1:]])
    assert not list(tmp_path.iterdir())


def test_cli_module_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "insarseg_torch.cli",
                        "export-torch", "--output", "never.pth"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not (ROOT / "never.pth").exists()
