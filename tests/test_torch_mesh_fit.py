"""``fit`` on a data mesh (``insarseg_torch/train/engine.py``, SPMD under
``insarseg_torch.parallel.launch``: 2 gloo ranks on the CPU, one torch
thread each) against ``fit`` in one process, U-Net-CA base 16 at 16^2,
global batch 4, 2 epochs of 2 steps with validation and a ``Checkpointer``
in ``tmp_path``, then a resume to epoch 3:

- every history entry within rtol 1e-5 of the one-process run's, the
  resumed run's too;
- the ranks end with equal weights and statistics and the same step
  count; the one process's differ from them by at most Adam's largest
  move, 2 x lr a step (a gradient at rounding level, which two summation
  orders give opposite signs, moves its weight by about lr: measured
  5.8e-5 after 4 steps and 9.8e-5 after 6 at lr 1e-4);
- the files are rank 0's: one ``latest.pt`` / ``best.pt`` holding the
  state the ranks trained, no temporary file left, and a Checkpointer
  on another rank writes nothing;
- ``mesh_data`` other than -1 or the group's size raises in a group, and
  above 1 without one (the ``ValueError`` naming ``launch``), as
  ``mesh_spatial`` above 1 does, for a ResNet family too; a ResNet
  family's slab that is not a multiple of 8 rows raises naming ROADMAP
  item 21c.
"""

import dataclasses

import pytest
import torch

from insarseg_torch.config import get_preset
from insarseg_torch.data.synthetic import synthetic_batch
from insarseg_torch.models.unet import UNet
from insarseg_torch.parallel import launch
from insarseg_torch.train import checkpoint as CK
from insarseg_torch.train.engine import init_weights
from tests import torch_mesh_ranks as R

CFG = get_preset("unet-channelattention", image_size=16, batch_size=4,
                 num_epochs=2, log_every_steps=2)


def _data():
    train = [synthetic_batch(4, 16, seed=s) for s in range(2)]
    val = [synthetic_batch(4, 16, seed=10)]
    return train, val


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    sd = init_weights(UNet(num_classes=2, base_features=16, use_se=True),
                      seed=5).state_dict()
    train, val = _data()
    mesh_dir = tmp_path_factory.mktemp("mesh_fit")
    one_dir = tmp_path_factory.mktemp("one_fit")
    ranks = launch(R.fit_and_resume, 2, ["cpu", "cpu"],
                   args=(CFG, sd, train, val, str(mesh_dir)))
    one = R.fit_and_resume(CFG, sd, train, val, str(one_dir))
    return ranks, one, mesh_dir


@pytest.mark.parametrize("run", ["first", "resumed"])
def test_two_ranks_fit_as_one_process(runs, run):
    ranks, one, _ = runs
    want_hist, want_sd, want_step = one[run]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert {r["world"] for r in ranks} == {2} and one["world"] == 1
    assert [h["epoch"] for h in want_hist] == \
        ([1, 2] if run == "first" else [3])
    for r in ranks:
        hist, sd, step = r[run]
        assert step == want_step == 2 * (2 if run == "first" else 3)
        assert [sorted(h) for h in hist] == [sorted(h) for h in want_hist]
        for h, w in zip(hist, want_hist):
            for k, v in w.items():
                assert h[k] == pytest.approx(v, rel=1e-5), (run, k)
        adam = 2 * CFG.learning_rate * step
        for k, t in want_sd.items():
            torch.testing.assert_close(sd[k], t, rtol=0, atol=adam, msg=k)
            assert torch.equal(sd[k], ranks[0][run][1][k]), k


def test_only_rank_0_writes(runs, monkeypatch, tmp_path):
    ranks, _, mesh_dir = runs
    names = sorted(p.name for p in mesh_dir.iterdir())
    assert names == ["best.pt", "best_miou.json", "latest.pt"]
    latest = torch.load(mesh_dir / "latest.pt", weights_only=True)
    assert latest["step"] == 6
    for k, t in ranks[0]["resumed"][1].items():
        assert torch.equal(latest["model"][k], t), k
    # a rank other than 0 writes nothing
    monkeypatch.setattr(CK, "rank", lambda: 1)
    ck = CK.Checkpointer(str(tmp_path / "r1"))
    model = UNet(num_classes=2, base_features=16)
    state = R.TE.create_state(model, device="cpu")
    ck.save_latest(state)
    ck.save_best(state, 0.5)
    assert list((tmp_path / "r1").iterdir()) == []


def test_fit_checks_mesh_data(runs):
    ranks, one, _ = runs
    for r in ranks:
        assert "mesh_data=3 in a process group of 2 ranks" in r["refused"]
    assert "launch" in one["refused"]
    train, _ = _data()
    model = UNet(num_classes=2, base_features=16)
    with pytest.raises(ValueError, match="launch"):
        R.TE.fit(model, dataclasses.replace(CFG, mesh_data=2), train,
                 device="cpu")
    # mesh_spatial > 1 also needs a group (tests/test_torch_spatial_train.py
    # runs it in one), for a ResNet family too
    # (tests/test_torch_spatial_resnet_fit.py), whose slabs must be a
    # multiple of 8 rows, else a ValueError naming item 21c
    with pytest.raises(ValueError, match="launch"):
        R.TE.fit(model, dataclasses.replace(CFG, mesh_spatial=2), train,
                 device="cpu")
    with pytest.raises(ValueError, match="launch"):
        R.TE.fit(model, dataclasses.replace(CFG, model="fcn",
                                            mesh_spatial=2), train,
                 device="cpu")
    from insarseg_torch.models.registry import build
    from insarseg_torch.parallel import spatial

    with spatial.active(spatial.ThreadComm(spatial.ThreadExchange(1), 0,
                                           torch.device("cpu"))):
        with pytest.raises(ValueError, match="multiple of 8.*item 21c"):
            build("fcn", "channel")(torch.zeros(1, 1, 12, 16))
