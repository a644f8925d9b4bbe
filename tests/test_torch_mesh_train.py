"""The port's train step on a data mesh (``insarseg_torch.parallel.launch``:
gloo ranks on the CPU, each with one torch thread) against the JAX
package's train step on ``make_mesh(data=n)`` (the 8 virtual CPU devices
of ``tests/conftest.py``), one SGD 0.1 step from the same weights on the
same global batch, at the JAX package's own mesh bars
(``tests/test_parallel.py:67-79``): the loss within rtol 1e-5, the
confusion counts equal, every parameter within atol 1e-4 and every BN
running statistic within 1e-5.

- U-Net-CA (base 16, 32^2, global b8) on 4 ranks, on a batch of random
  masks and on one whose last rank holds only ignored (255) pixels, which
  a loss averaged per rank gets wrong;
- FCN-ResNet50-CA (32^2, global b4) on 2 ranks with dropout off on both
  sides, its parameters at atol 1e-3 (``tests/test_engines_mesh.py:
  121-163``, the drift-compounding case).

The JAX trees are the port's weights read in with the JAX package's
importers (no eager JAX init)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from insarseg.compat.torch_io import unet_variables_from_torch
from insarseg.models.fcn import FCN as JaxFCN
from insarseg.models.unet import UNet as JaxUNet
from insarseg.parallel import make_mesh, replicate, shard_batch
from insarseg.train import engine as JE
from insarseg_torch.models.unet import UNet
from insarseg_torch.parallel import launch
from insarseg_torch.train.engine import init_weights
from tests import torch_mesh_ranks as R
from tests.test_torch_common import make_resnet_pair, smooth

LR = 0.1


def _jax_step(step, variables, batch, n):
    """One SGD step of the JAX package's train step ``step`` on
    ``make_mesh(data=n)``: its outputs and its state."""
    tx = optax.sgd(LR)
    params = variables["params"]
    state = JE.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(params), tx=tx)
    mesh = make_mesh(data=n)
    state = state.replace(params=replicate(state.params, mesh),
                          batch_stats=replicate(state.batch_stats, mesh),
                          opt_state=replicate(state.opt_state, mesh))
    image, mask = batch
    sb = shard_batch({"image": image, "mask": mask}, mesh)
    state, out = step(state, sb["image"], sb["mask"], jax.random.key(7))
    return {k: np.asarray(v) for k, v in out.items()}, state


def _assert_step(port, want, port_vars, jstate, param_atol):
    out, _ = port
    assert float(out["loss"]) == pytest.approx(float(want["loss"]),
                                               rel=1e-5)
    for k in ("tp", "fp", "fn", "correct", "valid"):
        np.testing.assert_array_equal(out[k].numpy(), want[k], err_msg=k)
    got_p = jax.tree_util.tree_leaves_with_path(port_vars["params"])
    want_p = dict(jax.tree_util.tree_leaves_with_path(jstate.params))
    assert len(got_p) == len(want_p)
    for path, x in got_p:
        np.testing.assert_allclose(np.asarray(x), np.asarray(want_p[path]),
                                   rtol=0, atol=param_atol,
                                   err_msg=jax.tree_util.keystr(path))
    got_s = jax.tree_util.tree_leaves_with_path(port_vars["batch_stats"])
    want_s = dict(jax.tree_util.tree_leaves_with_path(jstate.batch_stats))
    assert len(got_s) == len(want_s)
    for path, x in got_s:
        np.testing.assert_allclose(np.asarray(x), np.asarray(want_s[path]),
                                   rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def unet_runs():
    """The 4-rank port steps and the JAX mesh steps of U-Net-CA on both
    batches."""
    torch.set_num_threads(1)
    model = init_weights(UNet(num_classes=2, base_features=16, use_se=True),
                         seed=3)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    image = smooth(rng, (8, 32, 32, 1))
    mask = rng.integers(0, 2, (8, 32, 32)).astype(np.int32)
    ignored = mask.copy()
    ignored[6:] = 255  # rank 3's rows: no valid pixel
    ignored[:2, :, :20] = 255  # and fewer on rank 0
    batches = [(image, mask), (image, ignored)]
    port = launch(R.sgd_steps, 4, ["cpu"] * 4,
                  args=("unet-ca", sd, batches, LR))
    step = JE.make_train_step(
        JaxUNet(num_classes=2, base_features=16, use_se=True), 2)
    jv = unet_variables_from_torch(_np_sd(sd), use_se=True)
    jax_runs = [_jax_step(step, jv, b, 4) for b in batches]
    return port, jax_runs


@pytest.mark.parametrize("case", [0, 1], ids=["random-masks",
                                              "a-rank-all-ignored"])
def test_unet_ca_4_ranks_match_jax_mesh_step(unet_runs, case):
    port, jax_runs = unet_runs
    want, jstate = jax_runs[case]
    for r, ranked in enumerate(port):
        out, sd = ranked[case]
        back = unet_variables_from_torch(_np_sd(sd), use_se=True)
        _assert_step((out, sd), want, back, jstate, 1e-4)
    # every rank holds the same weights after the step
    sds = [ranked[case][1] for ranked in port]
    for k in sds[0]:
        for sd in sds[1:]:
            assert torch.equal(sd[k], sds[0][k]), k


def test_per_rank_mean_would_miss_the_ignored_rank(unet_runs):
    """The case is one the mean per rank gets wrong: the mean of the
    ranks' own losses differs from the global loss by far more than the
    bar."""
    from insarseg_torch.train.losses import cross_entropy_terms

    _, jax_runs = unet_runs
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(0, 1, (8, 32, 32, 2))
                              .astype(np.float32))
    mask = torch.from_numpy(rng.integers(0, 2, (8, 32, 32)).astype(np.int64))
    mask[6:] = 255
    mask[:2, :, :20] = 255
    parts = [cross_entropy_terms(lg, m) for lg, m in
             zip(torch.tensor_split(logits, 4), torch.tensor_split(mask, 4))]
    glob = sum(n for n, _ in parts) / sum(v for _, v in parts)
    per_rank = sum(n / v.clamp_min(1) for n, v in parts) / 4
    assert abs(float(per_rank) - float(glob)) > 1e-2 * float(glob)
    assert float(jax_runs[1][0]["valid"]) == 6 * 32 * 32 - 2 * 32 * 20


@pytest.fixture(scope="module")
def fcn_runs():
    torch.set_num_threads(1)
    _, v, tm = make_resnet_pair("fcn", "channel", seed=4)
    rng = np.random.default_rng(5)
    batch = (smooth(rng, (4, 32, 32, 1)),
             rng.integers(0, 2, (4, 32, 32)).astype(np.int32))
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    port = launch(R.sgd_steps, 2, ["cpu"] * 2, args=("fcn-ca", sd, [batch],
                                                     LR))
    want = _jax_step(JE.make_train_step(
        JaxFCN(2, "channel", dropout_rate=0.0), 2), v, batch, 2)
    return port, want


def test_fcn_ca_2_ranks_match_jax_mesh_step(fcn_runs):
    from insarseg.compat.torch_io import segmentation_variables_from_torch

    port, (want, jstate) = fcn_runs
    for ranked in port:
        out, sd = ranked[0]
        back = segmentation_variables_from_torch(_np_sd(sd), "fcn",
                                                 "channel")
        _assert_step((out, sd), want, back, jstate, 1e-3)


def test_a_rank_copies_its_rows_alone(monkeypatch):
    """Under a group ``fit`` leaves the host batch where it is and the step
    copies this rank's rows (rank 1 of 2 of a b5 batch: rows 3 and 4)
    alone to its device."""
    from insarseg_torch.parallel import mesh as P
    from insarseg_torch.train import engine as TE

    monkeypatch.setattr(P, "grouped", lambda: True)
    monkeypatch.setattr(P, "rank", lambda: 1)
    monkeypatch.setattr(P, "world", lambda: 2)
    batch = {"image": np.arange(5 * 4, dtype=np.float32).reshape(5, 2, 2, 1),
             "mask": np.arange(5 * 4, dtype=np.int32).reshape(5, 2, 2)}
    assert TE._placer(torch.device("cpu"))(batch) is batch
    copied = []
    put = TE._put
    monkeypatch.setattr(TE, "_put",
                        lambda a, dev: copied.append(len(a)) or put(a, dev))
    image, mask = TE._local(batch["image"], batch["mask"],
                            torch.device("cpu"), True)
    assert copied == [2, 2]
    np.testing.assert_array_equal(image.numpy(), batch["image"][3:])
    np.testing.assert_array_equal(mask.numpy(), batch["mask"][3:])
