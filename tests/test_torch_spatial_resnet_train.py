"""DeepLabV3's train step with the H axis sharded over 4 gloo ranks, data
2 x spatial 2 (``insarseg_torch.parallel.launch`` on the CPU, one torch
thread a rank), against the JAX package's train step on
``make_mesh(data=2, spatial=2)``, and the synced BatchNorm of a map
every slab holds whole (FCN-CA's and the PSPNet-CA's steps:
``tests/test_torch_spatial_resnet_fit.py``).

- One SGD 0.1 step from the same weights on the same global batch (32^2,
  b4: 16-row slabs, 2 rows a slab at the output stride, where ASPP's
  rates 12 / 24 / 36 and layer4's dilation 4 reach past the slab), at the
  JAX package's mesh bars (``tests/test_torch_mesh_train.py``): the loss
  within rtol 1e-5, the counts equal, every parameter within atol 1e-4
  and every BN statistic within atol 1e-5, the ASPP pool's BN's running
  variance among them; the ranks' weights equal. Dropout is off on both
  sides. Both run in float64 (the port's ranks on a float64 module, the
  JAX step in a subprocess with ``JAX_ENABLE_X64``, as
  ``tests/test_torch_train_resnet.py`` runs its steps): in float32 this
  step is not reproducible to its own bar, one process's parameters
  moving by up to 1.7e-3 between one torch thread and four (the ASPP
  head's BatchNorm backward amplifies the summation order's rounding).
- The synced ``MomentBatchNorm2d`` over a map every slab holds whole (a
  pooled map), under the 2 x 2 mesh, each slab's loss taking a share of
  the gradient: marked ``replicated``, the output, the running
  statistics and the parameters' gradients (summed over the ranks) equal
  one process's over the global batch (within 1e-6 x their largest
  value), and the input gradient summed over a row's slabs equals its
  rows of one process's; unmarked, the running variance's factor counts
  each row S times, and it misses.

The weights are numpy draws (``tests/test_torch_common.py::
resnet_numpy_state_dict``), read into the JAX tree with the JAX
package's importer."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.1
SIZE, BATCH, SEED = 32, 4, 7
# the JAX package's mesh bars: loss rtol, parameters' atol, statistics'
MESH_BARS = (1e-5, 1e-4, 1e-5)


def _weights():
    """The numpy weights (f32 draws) of DeepLabV3 in the port's names."""
    from insarseg_torch.models.registry import build
    from tests.test_torch_common import resnet_numpy_state_dict

    shapes = {k: tuple(v.shape)
              for k, v in build("deeplabv3").state_dict().items()}
    return resnet_numpy_state_dict(shapes, SEED)


def batch(n=BATCH, seed=SEED):
    """Global batch ``n`` at 32^2, an ignored block inside image 1's
    slab 1."""
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((n, SIZE, SIZE, 1))
    mask = rng.integers(0, 2, (n, SIZE, SIZE)).astype(np.int32)
    mask[1, 20:28, 4:12] = 255
    return image, mask


def f64(sd):
    return {k: v.double() if v.is_floating_point() else v.clone()
            for k, v in sd.items()}


def _jax_step(path):
    """Runs in its own process with JAX_ENABLE_X64=1 and 8 virtual CPU
    devices: the JAX package's DeepLabV3 step on make_mesh(2, 2) in
    float64; saves its outputs and state, in the port's names, to
    ``path``."""
    import jax
    import jax.numpy as jnp
    import optax

    jax.config.update("jax_default_matmul_precision", "highest")
    from insarseg.compat.torch_io import segmentation_variables_from_torch
    from insarseg.models.deeplab import DeepLabV3
    from insarseg.parallel import make_mesh, replicate, shard_batch
    from insarseg.train import engine as JE
    from insarseg_torch.compat import segmentation_variables_to_torch

    v = segmentation_variables_from_torch(_weights(), "deeplabv3", "none")
    v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
    tx = optax.sgd(LR)
    mesh = make_mesh(data=2, spatial=2)
    state = JE.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]), tx=tx)
    state = state.replace(params=replicate(state.params, mesh),
                          batch_stats=replicate(state.batch_stats, mesh),
                          opt_state=replicate(state.opt_state, mesh))
    image, mask = batch()
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


def _bn_case():
    rng = np.random.default_rng(SEED + 1)
    x = torch.from_numpy(rng.normal(0.5, 1.0, (4, 6, 2, 3))
                         .astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    return x, gy


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX step's subprocess and, meanwhile, the 4-rank launch."""
    from insarseg_torch.parallel import launch
    from tests import torch_spatial_ranks as R

    torch.set_num_threads(1)
    path = str(tmp_path_factory.mktemp("jax_step") / "step.npz")
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), path],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    sd = f64({k: torch.from_numpy(v) for k, v in _weights().items()})
    ranks = launch(R.run_cases, 4, ["cpu"] * 4, args=([
        ("steps", ("deeplabv3-none", sd, [batch()], 2, False, False, LR,
                   True)),
        ("bn", (*_bn_case(), 2))],))
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0 and "RESULT" in stdout, stderr[-4000:]
    with np.load(path) as f:
        want = {k: f[k] for k in f.files}
    return ranks, want


def assert_step(out, sd, want_out, want_sd, where):
    """A step's outputs and state_dict against the reference's at
    ``MESH_BARS`` (``want_sd``'s tensors, ``num_batches_tracked``
    aside)."""
    assert float(out["loss"]) == pytest.approx(float(want_out["loss"]),
                                               rel=MESH_BARS[0]), where
    for k in ("tp", "fp", "fn", "correct", "valid"):
        assert torch.equal(out[k], torch.as_tensor(want_out[k])), (where, k)
    assert sorted(want_sd) == sorted(k for k in sd
                                     if not k.endswith("batches_tracked"))
    for k, w in want_sd.items():
        bar = MESH_BARS[2] if k.endswith(("running_mean", "running_var")) \
            else MESH_BARS[1]
        err = float((sd[k] - torch.as_tensor(w)).abs().max())
        assert err <= bar, (where, k, err)


def test_deeplabv3_2x2_step_matches_jax_mesh_step(runs):
    ranks, want = runs
    want_out = {k[4:]: v for k, v in want.items() if k.startswith("out/")}
    want_sd = {k[3:]: v for k, v in want.items() if k.startswith("sd/")
               and not k.endswith("batches_tracked")}
    for r, ranked in enumerate(ranks):
        (out, sd), = ranked[0]
        assert_step(out, sd, want_out, want_sd, f"rank {r}")
        for k in sd:
            assert torch.equal(sd[k], ranks[0][0][0][1][k]), (r, k)
    # the pooled branch's BN statistics moved: the replicated count is
    # read by this step
    k = "classifier.0.convs.4.2.running_var"
    assert not np.allclose(want_sd[k], 1.0)


def test_replicated_bn_counts_each_row_once(runs):
    from torch import nn

    from insarseg_torch.ops.layers import MomentBatchNorm2d

    ranks, _ = runs
    x, gy = _bn_case()
    c = x.shape[1]
    bn = MomentBatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, c))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, c))
    xr = x.clone().requires_grad_(True)
    y = nn.Sequential(bn)(xr)
    (y * gy).sum().backward()
    want = {"y": y.detach(), "gw": bn.weight.grad, "gb": bn.bias.grad,
            "rm": bn.running_mean, "rv": bn.running_var}
    for row in (ranks[:2], ranks[2:]):
        got = [r[1] for r in row]
        rows = got[0]["rows"]
        for k, w in want.items():
            w = w[rows] if k == "y" else w
            for g in got:
                torch.testing.assert_close(
                    g[True][k], w, rtol=0,
                    atol=1e-6 * float(w.abs().max()), msg=k)
        gx = got[0][True]["gx"] + got[1][True]["gx"]
        torch.testing.assert_close(gx, xr.grad[rows], rtol=0,
                                   atol=1e-6 * float(xr.grad.abs().max()))
        # unmarked: the factor n / (n - 1) of 2 x 4 rows, not of 4
        assert not torch.allclose(got[0][False]["rv"], want["rv"],
                                  rtol=0, atol=1e-4)
        torch.testing.assert_close(got[0][False]["rm"], want["rm"])


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _jax_step(sys.argv[1])
