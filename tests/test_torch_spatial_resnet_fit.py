"""FCN-CA's and the PSPNet-CA's train steps and FCN-CA's ``fit`` with the
H axis sharded over 2 gloo ranks, data 1 x spatial 2
(``insarseg_torch.parallel.launch`` on the CPU, one torch thread a rank),
against the port's one process:

- one SGD 0.1 step of FCN-ResNet50-CA and of the PSPNet-ResNet50-CA from
  the same weights on the same global batch (32^2, b2: 16-row slabs)
  against the same step in one process (``tests/test_torch_train_resnet.
  py`` holds that step to the JAX package's), in float64 as
  ``tests/test_torch_spatial_resnet_train.py`` runs DeepLabV3's, dropout
  off, every BatchNorm the moment rule on both sides, at the JAX
  package's mesh bars there; the ranks' weights equal;
- ``fit`` of FCN-ResNet50-CA (f32, dropout off, its BatchNorms the moment
  rule in both) with ``mesh_spatial=2`` (32^2, b2: 16-row slabs; 2 epochs
  of one step with validation and a ``Checkpointer``, then a resume to
  epoch 3), its state given an SGD optimizer at the preset's rate: the
  first epoch's train entries (a forward from equal weights) within rtol
  1e-5 of the one-process ``fit``'s and every later entry within rtol
  1e-2, the same epochs and steps, the ranks' weights equal and the
  parameters within atol 1e-4 of the one process's. In f32 a
  ResNet-50's gradient at 32^2 is reproducible to about 1e-3 of itself
  only (``tests/test_torch_spatial_resnet_train.py``), and the runs
  drift apart step by step: between runs whose BatchNorms or slabs sum
  in another order the train loss moved by 3.8e-5 to 3.2e-4 relative
  after one step, and the BN statistics by up to 1.1e-3 x their largest
  value after two and past 5e-3 after three, on a data mesh as on this
  one (with ``fit``'s Adam, whose first steps move each weight by about
  lr in the sign of its gradient, the loss by 3e-4 after one). The
  steps themselves are held in float64 above;
- a ``fit`` at 24^2 tiles (12-row slabs, which the port refused before
  slabs of any height) runs on every rank: the ranks' histories equal
  and the first epoch's train entries (a forward from equal weights)
  within rtol 1e-5 of one process's.
"""

import dataclasses

import pytest
import torch

from insarseg_torch.config import get_preset
from insarseg_torch.data.synthetic import synthetic_batch
from insarseg_torch.models.registry import build
from insarseg_torch.parallel import launch
from insarseg_torch.train.engine import init_weights
from tests import test_torch_spatial_resnet_train as T
from tests import torch_spatial_ranks as R

FIT_CFG = get_preset("pspnet-channelattention", image_size=32, batch_size=2,
                     num_epochs=2, log_every_steps=1)
FIT_LR = 1e-4  # fit's SGD: the preset's rate
LR = 0.1  # the steps' SGD
KINDS = ("fcn-channel", "pspnet-channel")
HISTORY_RTOL = 1e-2  # the entries after the first step
PARAM_ATOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank launch (the f64 steps, ``fit`` with a resume, the
    refused ``fit``) and the one process's steps and ``fit``."""
    torch.set_num_threads(1)
    small = T.batch(2)
    sds = {kind: T.f64(init_weights(build(*kind.split("-")), seed=i)
                       .state_dict()) for i, kind in enumerate(KINDS)}
    fit_sd = init_weights(R.fcn_ca(), seed=5).state_dict()
    train = [synthetic_batch(2, 32, seed=1)]
    val = [synthetic_batch(2, 32, seed=10)]
    odd = [synthetic_batch(2, 24, seed=20)]
    cfg = dataclasses.replace(FIT_CFG, mesh_spatial=2)
    ranks = launch(R.run_cases, 2, ["cpu"] * 2, args=([
        ("steps", (kind, sds[kind], [small], 2, False, False, LR, True))
        for kind in KINDS] + [
        ("resnet_fit", (cfg, fit_sd, train, val,
                        str(tmp_path_factory.mktemp("fit")), odd,
                        FIT_LR))],))
    one = [R.spatial_steps(kind, sds[kind], [small], 1, False, lr=LR,
                           double=True)[0] for kind in KINDS]
    one_fit = R.fit_and_resume(FIT_CFG, fit_sd, train, val,
                               str(tmp_path_factory.mktemp("one_fit")),
                               R.fcn_ca, FIT_LR)
    one_fit["slab"] = R.odd_fit(FIT_CFG, fit_sd, odd)
    return ranks, one, one_fit


@pytest.mark.parametrize("case", range(len(KINDS)), ids=KINDS)
def test_resnet_1x2_step_matches_one_process(runs, case):
    ranks, one, _ = runs
    want_out, want_sd = one[case]
    want_sd = {k: v for k, v in want_sd.items()
               if not k.endswith("batches_tracked")}
    for r, ranked in enumerate(ranks):
        (out, sd), = ranked[case]
        T.assert_step(out, sd, want_out, want_sd, f"rank {r}")
        for k in sd:
            assert torch.equal(sd[k], ranks[0][case][0][1][k]), (r, k)


@pytest.mark.parametrize("run", ["first", "resumed"])
def test_fcn_ca_fit_mesh_spatial_2_as_one_process(runs, run):
    ranks, _, one = runs
    fits = [r[len(KINDS)] for r in ranks]
    want_hist, want_sd, want_step = one[run]
    assert [f["rank"] for f in fits] == [0, 1]
    assert [h["epoch"] for h in want_hist] == \
        ([1, 2] if run == "first" else [3])
    for f in fits:
        hist, sd, step = f[run]
        assert step == want_step == (2 if run == "first" else 3)
        assert [sorted(h) for h in hist] == [sorted(h) for h in want_hist]
        for h, w in zip(hist, want_hist):
            for k, v in w.items():
                assert h[k] == pytest.approx(v, rel=HISTORY_RTOL), (run, k)
        if run == "first":
            for k, v in want_hist[0].items():
                if k.startswith("train_"):
                    assert hist[0][k] == pytest.approx(v, rel=1e-5), k
        for k, t in want_sd.items():
            if not k.endswith(("running_mean", "running_var",
                               "batches_tracked")):
                torch.testing.assert_close(sd[k], t, rtol=0,
                                           atol=PARAM_ATOL, msg=k)
            assert torch.equal(sd[k], fits[0][run][1][k]), k


def test_fit_refuses_slabs_off_the_slab_rule(runs):
    """The geometry this test once saw refused (12-row slabs) now fits."""
    ranks, _, one = runs
    want = one["slab"]
    for r in ranks:
        hist = r[len(KINDS)]["slab"]
        assert hist == ranks[0][len(KINDS)]["slab"]
        assert [h["epoch"] for h in hist] == [1]
        for k, v in want[0].items():
            if k.startswith("train_"):
                assert hist[0][k] == pytest.approx(v, rel=1e-5), k
