"""The train steps and ``halo`` with the H axis sharded at slab heights
of any size (``insarseg_torch/parallel/spatial.py``), over 4 gloo ranks
(``insarseg_torch.parallel.launch`` on the CPU, one torch thread a rank,
``spatial.GroupComm``), against the JAX package's train step (on
``make_mesh(data=1, spatial=4)``, the 8 virtual CPU devices of
``tests/conftest.py``, where GSPMD pads; for DeepLabV3 on one device):

- ``halo`` over 13 rows cut 5 / 0 / 1 / 7 (an empty slab, a one-row
  slab), each slab asking other counts above and below, zeros and -inf
  past the image: each slab gets the full map's rows padded with the
  fill, and each row's gradient is summed over every slab that read it;
- one SGD 0.1 step of U-Net-CA (base 16) at 48x32, global b4, data 1 x
  spatial 4 (12-row slabs: 6, 3, 1.5 and 0.75 rows a slab down the
  levels, so the pools' windows cross slabs and the up path re-slabs)
  at the JAX package's mesh bars (``tests/test_parallel.py:66-78``: loss
  rtol 1e-5, counts equal, parameters atol 1e-4, BN statistics atol
  1e-5), an ignored block on one slab; the ranks' weights equal;
- one SGD 0.1 step of DeepLabV3 (dropout off) at 36^2, global b2, 1 x 4
  (9-row slabs; 2 / 1 / 1 / 1 rows at the output stride, where ASPP's
  rates reach past every slab) in float64 against the JAX step in
  float64 (a subprocess with ``JAX_ENABLE_X64``, as
  ``tests/test_torch_spatial_resnet_train.py`` runs the even slabs' step:
  in f32 the ResNet step is not reproducible to its bar), at the same
  bars. The JAX step runs on one device: the JAX package's own step on
  ``make_mesh(1, 4)`` gives the same loss but misses its one-device step
  here (``backbone.conv1.weight`` by 0.594 after the step, on the CPU),
  where at 18-row slabs (``make_mesh(1, 2)``) the two agree within
  1e-11: GSPMD's gradient at these padded slabs is not the one-device
  gradient, and the port's is.

The weights are drawn in the port (U-Net) or with numpy (DeepLabV3), and
read into the JAX package with its importers."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.1
BOUNDS = (0, 5, 5, 6, 13)
NEED = ((2, 7), (3, 3), (6, 1), (4, 2))
FILLS = (0.0, -float("inf"))
DEEPLAB_SIZE = 36


def _deeplab_batch():
    """Global b2 at 36^2, an ignored block inside slab 2."""
    rng = np.random.default_rng(17)
    image = rng.standard_normal((2, DEEPLAB_SIZE, DEEPLAB_SIZE, 1))
    mask = rng.integers(0, 2, (2, DEEPLAB_SIZE, DEEPLAB_SIZE)
                        ).astype(np.int32)
    mask[0, 19:26, 4:12] = 255
    return image, mask


def _unet_batch():
    """Global b4 at 48x32, an ignored block inside slab 1 of image 2."""
    from tests.test_torch_common import smooth

    rng = np.random.default_rng(19)
    image = smooth(rng, (4, 48, 32, 1))
    mask = rng.integers(0, 2, (4, 48, 32)).astype(np.int32)
    mask[2, 14:22, 3:20] = 255
    return image, mask


def _jax_deeplab_step(path):
    """Runs in its own process with JAX_ENABLE_X64=1: the JAX package's
    DeepLabV3 step on one device in float64; saves its outputs and
    state, in the port's names, to ``path``."""
    import jax
    import jax.numpy as jnp
    import optax

    jax.config.update("jax_default_matmul_precision", "highest")
    from insarseg.compat.torch_io import segmentation_variables_from_torch
    from insarseg.models.deeplab import DeepLabV3
    from insarseg.parallel import make_mesh, replicate, shard_batch
    from insarseg.train import engine as JE
    from insarseg_torch.compat import segmentation_variables_to_torch
    from tests.test_torch_spatial_resnet_train import _weights

    v = segmentation_variables_from_torch(_weights(), "deeplabv3", "none")
    v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
    tx = optax.sgd(LR)
    mesh = make_mesh(data=1, spatial=1)
    state = JE.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]), tx=tx)
    state = state.replace(params=replicate(state.params, mesh),
                          batch_stats=replicate(state.batch_stats, mesh),
                          opt_state=replicate(state.opt_state, mesh))
    image, mask = _deeplab_batch()
    sb = shard_batch({"image": image, "mask": mask}, mesh)
    state, out = JE.make_train_step(DeepLabV3(2, "none", dropout_rate=0.0),
                                    2)(state, sb["image"], sb["mask"],
                                       jax.random.key(0))
    sd = segmentation_variables_to_torch(
        {"params": state.params, "batch_stats": state.batch_stats},
        "deeplabv3", "none")
    np.savez(path, **{f"sd/{k}": np.asarray(a) for k, a in sd.items()},
             **{f"out/{k}": np.asarray(a) for k, a in out.items()})
    print("RESULT " + json.dumps({"ok": True}))


def _halo_inputs():
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.normal(size=(2, 3, 13, 5)).astype(np.float32))
    spans = [(8 + a - u, 8 + b + d) for (a, b), (u, d) in
             zip(zip(BOUNDS[:-1], BOUNDS[1:]), NEED)]
    gys = [torch.from_numpy(rng.normal(size=(2, 3, j - i, 5))
                            .astype(np.float32)) for i, j in spans]
    return x, spans, gys


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX DeepLabV3 step's subprocess and, meanwhile, the 4-rank
    launch and the JAX U-Net-CA step."""
    from insarseg.compat.torch_io import unet_variables_from_torch
    from insarseg.models.unet import UNet as JaxUNet
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.parallel import launch
    from insarseg_torch.train.engine import init_weights
    from tests import torch_spatial_ranks as R
    from tests.test_torch_mesh_train import _np_sd
    from tests.test_torch_spatial_resnet_train import _weights, f64
    from tests.test_torch_spatial_train import _jax_step

    torch.set_num_threads(1)
    path = str(tmp_path_factory.mktemp("jax_step") / "step.npz")
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), path],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    x, _, gys = _halo_inputs()
    sd = {k: v.clone() for k, v in init_weights(
        UNet(num_classes=2, base_features=16, use_se=True),
        seed=8).state_dict().items()}
    deeplab = f64({k: torch.from_numpy(v) for k, v in _weights().items()})
    ranks = launch(R.run_cases, 4, ["cpu"] * 4, args=(
        [("uneven_halo", (x, BOUNDS, NEED, gys, fill)) for fill in FILLS]
        + [("steps", ("unet-ca", sd, [_unet_batch()], 4, False)),
           ("steps", ("deeplabv3-none", deeplab, [_deeplab_batch()], 4,
                      False, False, LR, True))],))
    jv = unet_variables_from_torch(_np_sd(sd), use_se=True)
    unet_want = _jax_step(JaxUNet(num_classes=2, base_features=16,
                                  use_se=True), jv, _unet_batch(), 1, 4)
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0 and "RESULT" in stdout, stderr[-4000:]
    with np.load(path) as f:
        deeplab_want = {k: f[k] for k in f.files}
    return ranks, unet_want, deeplab_want


@pytest.mark.parametrize("case", range(len(FILLS)), ids=["zeros", "-inf"])
def test_uneven_halo_on_4_ranks(runs, case):
    ranks = runs[0]
    x, spans, gys = _halo_inputs()
    fill = FILLS[case]
    xr = x.clone().requires_grad_(True)
    padded = F.pad(xr, (0, 0, 8, 8))
    sum((padded[:, :, i:j] * g).sum()
        for (i, j), g in zip(spans, gys)).backward()
    full = F.pad(x, (0, 0, 8, 8), value=fill)
    for s, r in enumerate(ranks):
        got = r[case]
        i, j = spans[s]
        assert torch.equal(got["y"], full[:, :, i:j]), s
        want = xr.grad[:, :, BOUNDS[s]:BOUNDS[s + 1]]
        torch.testing.assert_close(got["gx"], want, rtol=0,
                                   atol=1e-6 * float(xr.grad.abs().max()))


def test_unet_ca_1x4_step_at_12_row_slabs_matches_jax_mesh_step(runs):
    from insarseg.compat.torch_io import unet_variables_from_torch
    from tests.test_torch_mesh_train import _assert_step, _np_sd

    ranks, (want, jstate), _ = runs
    sds = []
    for ranked in ranks:
        (out, sd), = ranked[len(FILLS)]
        back = unet_variables_from_torch(_np_sd(sd), use_se=True)
        _assert_step((out, sd), want, back, jstate, 1e-4)
        sds.append(sd)
    for k in sds[0]:
        for sd in sds[1:]:
            assert torch.equal(sd[k], sds[0][k]), k


def test_deeplabv3_1x4_step_at_odd_slabs_matches_jax_step(runs):
    from tests.test_torch_spatial_resnet_train import assert_step

    ranks, _, want = runs
    want_out = {k[4:]: v for k, v in want.items() if k.startswith("out/")}
    want_sd = {k[3:]: v for k, v in want.items() if k.startswith("sd/")
               and not k.endswith("batches_tracked")}
    for r, ranked in enumerate(ranks):
        (out, sd), = ranked[len(FILLS) + 1]
        assert_step(out, sd, want_out, want_sd, f"rank {r}")
        for k in sd:
            assert torch.equal(sd[k], ranks[0][len(FILLS) + 1][0][1][k]), \
                (r, k)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _jax_deeplab_step(sys.argv[1])
