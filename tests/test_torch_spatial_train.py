"""The port's train step, ``halo`` and ``fit`` with the H axis sharded
over gloo ranks (``insarseg_torch.parallel.launch`` on the CPU, one torch
thread a rank; ``parallel/spatial.py``, ``train/engine.py``), against the
JAX package's train step on ``make_mesh(data, spatial)`` (the 8 virtual
CPU devices of ``tests/conftest.py``) and the port's one-process ``fit``.

- ``halo``: on 4 ranks (2 x 2 and 1 x 4) and 2 ranks (1 x 2), k = 1 and
  3, NCHW and channels-last: each slab's conv output and input gradient
  equal the full-H conv's rows of that slab (within 1e-6 x the full
  tensor's largest value: the sums of the edge rows' gradients split
  over two slabs), the weight
  gradients summed over the ranks equal the full conv's (rtol 1e-5), and
  the halo'd input and the gradient keep the slab's memory format;
- one SGD 0.1 step from the same weights on the same global batch at the
  JAX package's mesh bars (``tests/test_parallel.py:66-78``: loss rtol
  1e-5, counts equal, parameters atol 1e-4, BN statistics atol 1e-5):
  U-Net-CA (base 16, 64^2, global b4: 32-row slabs) on 4 ranks, data 2 x
  spatial 2, with the augment on and ignored (255) blocks that each lie
  in one slab, without and with ``remat``; U-Net-SA (base 8) on 2 ranks,
  1 x 2. The JAX step gets the batch the port's D4 flags turn it into
  (jax.random's stream cannot be matched; the flips and the transpose
  move rows between slabs, so the port must augment before it slabs);
- ``fit`` of U-Net-CA with ``mesh_spatial=2`` on 2 ranks (32^2, b4, 2
  epochs of 2 steps, a ``Checkpointer``, then a resume to epoch 3): every
  history entry within rtol 1e-5 of the one-process ``fit``'s, the ranks'
  weights equal and within Adam's largest move of the one process's;
  ``mesh_data`` other than world / spatial raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from insarseg.compat.torch_io import unet_variables_from_torch
from insarseg.models.unet import UNet as JaxUNet
from insarseg.parallel import make_mesh, replicate, shard_batch
from insarseg.train import engine as JE
from insarseg_torch.config import get_preset
from insarseg_torch.data.augment import random_dihedral
from insarseg_torch.data.synthetic import synthetic_batch
from insarseg_torch.models.unet import UNet
from insarseg_torch.parallel import launch
from insarseg_torch.train import engine as TE
from insarseg_torch.train.engine import init_weights
from tests import torch_spatial_ranks as R
from tests.test_torch_common import smooth
from tests.test_torch_mesh_train import _assert_step, _np_sd

LR = 0.1
# (spatial, k, channels-last) of the halo cases a launch runs
HALO_4 = ((2, 1, False), (2, 3, True), (4, 1, True), (4, 3, False))
HALO_2 = ((2, 1, True), (2, 3, False))
FIT_CFG = get_preset("unet-channelattention", image_size=32, batch_size=4,
                     num_epochs=2, log_every_steps=2)


def _halo_cases(rng, specs):
    """Each spec's (x, w, gy) and the full-H conv's output and gradients."""
    cases, wants = [], []
    for spatial, k, cl in specs:
        x = torch.from_numpy(rng.normal(size=(4, 3, 16, 12))
                             .astype(np.float32))
        w = torch.from_numpy(rng.normal(size=(5, 3, 2 * k + 1, 2 * k + 1))
                             .astype(np.float32))
        gy = torch.from_numpy(rng.normal(size=(4, 5, 16, 12))
                              .astype(np.float32))
        cases.append(("halo", (x, w, gy, spatial, cl)))
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = F.conv2d(xr, wr, padding=k)
        (y * gy).sum().backward()
        wants.append((y.detach(), xr.grad, wr.grad, cl))
    return cases, wants


def _unet_batch():
    """64^2 global b4 with random masks and ignored blocks: rows 40-55 x
    columns 8-23 of tile 1 (slab 1; under any D4 transform the block keeps
    to one slab) and the lower half of tile 3 (a slab with no valid pixel
    before the augment)."""
    rng = np.random.default_rng(0)
    image = smooth(rng, (4, 64, 64, 1))
    mask = rng.integers(0, 2, (4, 64, 64)).astype(np.int32)
    mask[1, 40:56, 8:24] = 255
    mask[3, 32:] = 255
    return image, mask


def _port_augmented(image, mask):
    """The global batch as the port's step 0 (seed 0) augments it."""
    flags = TE.augment_flags(TE.step_seeds(0, 0)[0], len(image),
                             torch.device("cpu"))
    im, m = random_dihedral(torch.from_numpy(image), torch.from_numpy(mask),
                            flags=flags)
    assert 0 < int(flags.sum()) < flags.numel()
    return im.numpy(), m.numpy()


def _jax_step(jmodel, variables, batch, data, spatial):
    """One SGD step of the JAX package's train step on ``make_mesh(data,
    spatial)`` with ``shard_batch``: its outputs and its state."""
    tx = optax.sgd(LR)
    params = variables["params"]
    state = JE.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(params), tx=tx)
    mesh = make_mesh(data=data, spatial=spatial)
    state = state.replace(params=replicate(state.params, mesh),
                          batch_stats=replicate(state.batch_stats, mesh),
                          opt_state=replicate(state.opt_state, mesh))
    sb = shard_batch({"image": batch[0], "mask": batch[1]}, mesh)
    state, out = JE.make_train_step(jmodel, 2)(
        state, sb["image"], sb["mask"], jax.random.key(7))
    return {k: np.asarray(v) for k, v in out.items()}, state


@pytest.fixture(scope="module")
def four_ranks():
    """The 4-rank launch (halo cases, the U-Net-CA steps without and with
    remat) and the JAX U-Net-CA step on make_mesh(2, 2)."""
    torch.set_num_threads(1)
    halo, halo_want = _halo_cases(np.random.default_rng(1), HALO_4)
    sd = {k: v.clone() for k, v in init_weights(
        UNet(num_classes=2, base_features=16, use_se=True),
        seed=3).state_dict().items()}
    batch = _unet_batch()
    steps = [("steps", ("unet-ca", sd, [batch], 2, True, remat))
             for remat in (False, True)]
    ranks = launch(R.run_cases, 4, ["cpu"] * 4, args=(halo + steps,))
    jv = unet_variables_from_torch(_np_sd(sd), use_se=True)
    want = _jax_step(JaxUNet(num_classes=2, base_features=16, use_se=True),
                     jv, _port_augmented(*batch), 2, 2)
    return ranks, halo_want, want


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank launch (halo cases, the U-Net-SA step, ``fit`` with a
    resume), the JAX U-Net-SA step on make_mesh(1, 2) and the
    one-process ``fit``."""
    torch.set_num_threads(1)
    halo, halo_want = _halo_cases(np.random.default_rng(2), HALO_2)
    sa = {k: v.clone() for k, v in init_weights(
        UNet(num_classes=2, base_features=8, use_sa=True),
        seed=6).state_dict().items()}
    batch = _unet_batch()
    fit_sd = init_weights(UNet(num_classes=2, base_features=16,
                               use_se=True), seed=5).state_dict()
    train = [synthetic_batch(4, 32, seed=s) for s in range(2)]
    val = [synthetic_batch(4, 32, seed=10)]
    cfg = dataclasses.replace(FIT_CFG, mesh_spatial=2)
    cases = halo + [
        ("steps", ("unet-sa", sa, [batch], 2, True)),
        ("fit", (cfg, fit_sd, train, val,
                 str(tmp_path_factory.mktemp("spatial_fit"))))]
    ranks = launch(R.run_cases, 2, ["cpu"] * 2, args=(cases,))
    jv = unet_variables_from_torch(_np_sd(sa), use_sa=True)
    want = _jax_step(JaxUNet(num_classes=2, base_features=8, use_sa=True),
                     jv, _port_augmented(*batch), 1, 2)
    one = R.fit_and_resume(FIT_CFG, fit_sd, train, val,
                           str(tmp_path_factory.mktemp("one_fit")))
    return ranks, halo_want, want, one


def _check_halo(ranks, wants):
    for i, (y, gx, gw, cl) in enumerate(wants):
        got = [r[i] for r in ranks]
        torch.testing.assert_close(sum(g["gw"] for g in got), gw,
                                   rtol=1e-5, atol=1e-4)
        for g in got:
            rows, slab = g["rows"], g["slab"]
            for name, full in (("y", y), ("gx", gx)):
                torch.testing.assert_close(
                    g[name], full[rows][:, :, slab], rtol=0,
                    atol=1e-6 * float(full.abs().max()), msg=name)
            assert g["padded_cl"] == g["gx_cl"] == cl


def test_halo_on_4_ranks(four_ranks):
    ranks, halo_want, _ = four_ranks
    _check_halo(ranks, halo_want)


def test_halo_on_2_ranks(two_ranks):
    ranks, halo_want, _, _ = two_ranks
    _check_halo(ranks, halo_want)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_unet_ca_2x2_step_matches_jax_mesh_step(four_ranks, remat):
    ranks, halo_want, (want, jstate) = four_ranks
    case = len(halo_want) + remat
    sds = []
    for ranked in ranks:
        (out, sd), = ranked[case]
        back = unet_variables_from_torch(_np_sd(sd), use_se=True)
        _assert_step((out, sd), want, back, jstate, 1e-4)
        sds.append(sd)
    for k in sds[0]:
        for sd in sds[1:]:
            assert torch.equal(sd[k], sds[0][k]), k


def test_unet_sa_1x2_step_matches_jax_mesh_step(two_ranks):
    ranks, halo_want, (want, jstate), _ = two_ranks
    for ranked in ranks:
        (out, sd), = ranked[len(halo_want)]
        back = unet_variables_from_torch(_np_sd(sd), use_sa=True)
        _assert_step((out, sd), want, back, jstate, 1e-4)


@pytest.mark.parametrize("run", ["first", "resumed"])
def test_fit_mesh_spatial_2_as_one_process(two_ranks, run):
    ranks, halo_want, _, one = two_ranks
    fits = [r[len(halo_want) + 1] for r in ranks]
    want_hist, want_sd, want_step = one[run]
    assert [f["rank"] for f in fits] == [0, 1]
    assert [h["epoch"] for h in want_hist] == \
        ([1, 2] if run == "first" else [3])
    for f in fits:
        hist, sd, step = f[run]
        assert step == want_step == 2 * (2 if run == "first" else 3)
        assert [sorted(h) for h in hist] == [sorted(h) for h in want_hist]
        for h, w in zip(hist, want_hist):
            for k, v in w.items():
                assert h[k] == pytest.approx(v, rel=1e-5), (run, k)
        adam = 2 * FIT_CFG.learning_rate * step
        for k, t in want_sd.items():
            torch.testing.assert_close(sd[k], t, rtol=0, atol=adam, msg=k)
            assert torch.equal(sd[k], fits[0][run][1][k]), k
        assert "mesh_data=3 in a process group of 2 ranks at " \
            "mesh_spatial=2" in f["refused"]
