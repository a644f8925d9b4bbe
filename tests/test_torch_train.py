"""The port's training path (``insarseg_torch/train``, ``data/augment.py``,
``utils/history.py``) against the JAX package's, on inputs made with numpy
from a seed:

- ``cross_entropy_loss`` within rtol 1e-6 of JAX's, an all-ignored batch
  0 in both, out-of-range labels counted as the last class;
  ``confusion_counts`` equal; ``metrics_v1`` / ``metrics_v2`` within rtol
  1e-6, v2's OA quirk correct / (correct + 2 wrong);
- ``normalize_u8`` equal; ``random_dihedral`` with JAX's flags passed in
  equal to JAX's transform;
- 5 steps of ``make_train_step`` for U-Net-CA and U-Net-SA (base 16, 32^2
  b4) from weights crossed with ``unet_variables_to_torch``, augment off,
  against the JAX package's jitted step: per-step loss within atol 5e-4,
  rtol 1e-4; every DoubleConv conv bias unchanged bit for bit (in train
  mode BN makes its gradient exactly 0); BN running statistics within
  0.05, read back with ``unet_variables_from_torch`` (the bars of
  ``tests/test_train_parity.py``: two f32 frameworks with other summation
  orders drift apart through Adam's sign-like early steps);
- ``_Averager`` in both modes within rtol 1e-6 of JAX's on the same step
  outputs; ``evaluate`` of the same weights within rtol 1e-5 (loss) and
  1e-6 (metrics) of JAX's, and over the serve engine
  (``make_engine_eval_step``) the loss within rtol 1e-4;
- ``fit``: 2 epochs at base 16, 16^2 write the JAX package's history keys;
  2 straight epochs equal 1 epoch and a resume (losses within 1e-6); the
  checkpoint round trip is bit-equal, the optimizer state included.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.compat.torch_io import unet_variables_from_torch
from insarseg.data.augment import normalize_u8 as jax_normalize_u8
from insarseg.data.augment import random_dihedral as jax_dihedral
from insarseg.models.unet import UNet as JaxUNet
from insarseg.train import engine as JE
from insarseg.train import losses as JL
from insarseg.train import metrics as JM
from insarseg_torch.compat import state_dict_to_torch, unet_variables_to_torch
from insarseg_torch.config import get_preset
from insarseg_torch.data.augment import normalize_u8, random_dihedral
from insarseg_torch.data.synthetic import synthetic_batch
from insarseg_torch.engines import make_engine
from insarseg_torch.models.unet import UNet
from insarseg_torch.train import engine as TE
from insarseg_torch.train import metrics as TM
from insarseg_torch.train.checkpoint import Checkpointer
from insarseg_torch.train.losses import cross_entropy_loss
from insarseg_torch.utils.history import load_history, save_history
from tests.test_torch_common import CPU


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# loss and metrics
# ---------------------------------------------------------------------------

def _labels(rng, shape, nc):
    labels = rng.integers(0, nc, shape)
    labels[rng.random(shape) < 0.1] = 255  # ignored
    labels[rng.random(shape) < 0.05] = nc + 4  # out of range
    return labels.astype(np.int32)


@pytest.mark.parametrize("nc", [2, 3])
def test_cross_entropy_matches_jax(nc):
    rng = np.random.default_rng(nc)
    logits = rng.normal(0, 3, (2, 9, 7, nc)).astype(np.float32)
    labels = _labels(rng, (2, 9, 7), nc)
    want = float(JL.cross_entropy_loss(jnp.asarray(logits),
                                       jnp.asarray(labels)))
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)
    # the out-of-range pixels count as the last class
    clamped = np.where(labels == 255, 255, np.minimum(labels, nc - 1))
    assert float(cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(clamped))) \
        == pytest.approx(float(got), rel=1e-6)
    # bf16 logits promote to f32
    b16 = cross_entropy_loss(torch.from_numpy(logits).bfloat16(),
                             torch.from_numpy(labels))
    assert b16.dtype == torch.float32
    ignored = np.full_like(labels, 255)
    assert float(cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(ignored))) == 0.0
    assert float(JL.cross_entropy_loss(jnp.asarray(logits),
                                       jnp.asarray(ignored))) == 0.0


def _counts_pair(rng, nc, shape=(3, 8, 8)):
    logits = rng.normal(0, 1, shape + (nc,)).astype(np.float32)
    labels = _labels(rng, shape, nc)
    want = JM.confusion_counts(jnp.asarray(logits), jnp.asarray(labels), nc)
    got = TM.confusion_counts(torch.from_numpy(logits),
                              torch.from_numpy(labels), nc)
    return got, want


@pytest.mark.parametrize("nc", [2, 4])
def test_counts_and_metrics_match_jax(nc):
    got, want = _counts_pair(np.random.default_rng(10 + nc), nc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    for version in (1, 2):
        jm, tm = JM.compute(want, version), TM.compute(got, version)
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]),
                                       rtol=1e-6, err_msg=k)
    merged = TM.merge_counts(got, got)
    assert torch.equal(merged["tp"], 2 * got["tp"])


def test_v2_oa_counts_each_wrong_pixel_twice():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 1, (2, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 8, 8)).astype(np.int32)
    labels[0, :2] = 255
    c = TM.confusion_counts(torch.from_numpy(logits),
                            torch.from_numpy(labels), 3)
    correct, wrong = float(c["correct"]), float(c["valid"] - c["correct"])
    assert 0 < wrong < float(c["valid"])
    assert float(TM.metrics_v2(c)["acc"]) == pytest.approx(
        correct / (correct + 2 * wrong), rel=1e-6)
    assert float(TM.metrics_v1(c)["acc"]) == pytest.approx(
        correct / float(c["valid"]), rel=1e-6)


def test_metrics_of_an_all_ignored_batch():
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 1, (2, 4, 4, 2)).astype(np.float32)
    labels = np.full((2, 4, 4), 255, np.int32)
    got = TM.confusion_counts(torch.from_numpy(logits),
                              torch.from_numpy(labels), 2)
    want = JM.confusion_counts(jnp.asarray(logits), jnp.asarray(labels), 2)
    for version in (1, 2):
        for k, v in JM.compute(want, version).items():
            assert float(TM.compute(got, version)[k]) == float(v) == 0.0


# ---------------------------------------------------------------------------
# augment
# ---------------------------------------------------------------------------

def test_normalize_u8_matches_jax():
    x = np.random.default_rng(0).integers(0, 256, (2, 5, 5, 1)) \
        .astype(np.uint8)
    for mean, std in ((0.5, 0.5), (0.3, 0.2)):
        want = np.asarray(jax_normalize_u8(jnp.asarray(x), mean, std))
        got = normalize_u8(torch.from_numpy(x), mean, std)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), want)


def test_random_dihedral_matches_jax_with_its_flags():
    rng = np.random.default_rng(1)
    image = rng.normal(0, 1, (8, 6, 6, 2)).astype(np.float32)
    mask = rng.integers(0, 2, (8, 6, 6)).astype(np.int32)
    key = jax.random.key(7)
    # the JAX package's flags for this key (insarseg/data/augment.py:40-43)
    r1, r2, r3 = jax.random.split(key, 3)
    flags = np.stack([np.asarray(jax.random.bernoulli(r, 0.5, (8,)))
                      for r in (r1, r2, r3)])
    assert 0 < flags.sum() < flags.size
    want_i, want_m = jax_dihedral(key, jnp.asarray(image), jnp.asarray(mask))
    got_i, got_m = random_dihedral(torch.from_numpy(image),
                                   torch.from_numpy(mask),
                                   flags=torch.from_numpy(flags))
    np.testing.assert_array_equal(_np(got_i), np.asarray(want_i))
    np.testing.assert_array_equal(_np(got_m), np.asarray(want_m))
    g = torch.Generator().manual_seed(0)
    a = random_dihedral(torch.from_numpy(image), torch.from_numpy(mask),
                        generator=g)
    assert a[0].shape == image.shape and a[1].shape == mask.shape
    with pytest.raises(ValueError, match="square"):
        random_dihedral(torch.zeros(1, 4, 6, 1), torch.zeros(1, 4, 6),
                        generator=g)


# ---------------------------------------------------------------------------
# the train step against the JAX package's
# ---------------------------------------------------------------------------

STEPS, LR = 5, 1e-4


def _batches(size, batch, n=3):
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((batch, size, size, 1)).astype(np.float32),
             rng.integers(0, 2, (batch, size, size)).astype(np.int32))
            for _ in range(n)]


def _port_unet(v, use_se, use_sa, base=16):
    tm = UNet(num_classes=2, base_features=base, use_se=use_se,
              use_sa=use_sa)
    np_v = jax.tree.map(np.asarray, v)
    tm.load_state_dict(state_dict_to_torch(
        unet_variables_to_torch(np_v, use_se=use_se, use_sa=use_sa)),
        strict=True)
    return tm


def _jax_state(jm, v):
    x0 = jnp.zeros((1, 32, 32, 1))
    state = JE.create_state(jm, jax.random.key(0), x0, LR)
    return state.replace(params=v["params"], batch_stats=v["batch_stats"],
                         opt_state=state.tx.init(v["params"]))


def _dc_biases(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()
            if ".double_conv." in k and k.endswith(("0.bias", "3.bias"))}


def _assert_stats_close(jax_stats, port_stats, atol, path=""):
    assert set(jax_stats) == set(port_stats), path
    for k in jax_stats:
        if isinstance(jax_stats[k], dict):
            _assert_stats_close(jax_stats[k], port_stats[k], atol,
                                f"{path}/{k}")
        else:
            np.testing.assert_allclose(np.asarray(port_stats[k]),
                                       np.asarray(jax_stats[k]), atol=atol,
                                       rtol=0, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("use_se,use_sa", [(True, False), (False, True)],
                         ids=["unet-ca", "unet-sa"])
def test_train_steps_match_jax(use_se, use_sa):
    jm = JaxUNet(num_classes=2, base_features=16, use_se=use_se,
                 use_sa=use_sa)
    v = jm.init(jax.random.key(3), jnp.zeros((1, 32, 32, 1)))
    jstate, jstep = _jax_state(jm, v), JE.make_train_step(jm, 2)
    tm = _port_unet(v, use_se, use_sa)
    tstate = TE.create_state(tm, LR, device=CPU)
    tstep = TE.make_train_step(tm, 2)
    biases = _dc_biases(tm)
    assert len(biases) == 18 + (8 if use_sa else 0)
    batches = _batches(32, 4)
    jl, tl = [], []
    for s in range(STEPS):
        x, m = batches[s % len(batches)]
        jstate, jout = jstep(jstate, jnp.asarray(x), jnp.asarray(m),
                             jax.random.key(100 + s))
        tout = tstep(tstate, torch.from_numpy(x), torch.from_numpy(m))
        jl.append(float(jout["loss"]))
        tl.append(float(tout["loss"]))
        assert sorted(tout) == sorted(jout)
    print(f"losses jax {jl} port {tl}")
    np.testing.assert_allclose(tl, jl, atol=5e-4, rtol=1e-4)
    assert tl[-1] != tl[0] and tstate.step == STEPS
    for k, b in _dc_biases(tm).items():
        assert torch.equal(b, biases[k]), k
    back = unet_variables_from_torch(
        {k: _np(t) for k, t in tm.state_dict().items()}, use_se=use_se,
        use_sa=use_sa)
    _assert_stats_close(jstate.batch_stats, back["batch_stats"], 0.05)


# ---------------------------------------------------------------------------
# averaging, evaluate
# ---------------------------------------------------------------------------

def _step_outs(rng, n):
    outs = []
    for _ in range(n):
        got, want = _counts_pair(rng, 3)
        loss = float(rng.uniform(0.2, 1.0))
        outs.append(({**got, "loss": torch.tensor(loss)},
                     {**want, "loss": jnp.asarray(loss, jnp.float32)}))
    return outs


@pytest.mark.parametrize("mode", ["batch_mean", "global"])
@pytest.mark.parametrize("version", [1, 2])
def test_averager_matches_jax(mode, version):
    outs = _step_outs(np.random.default_rng(5), 4)
    weights = [3, 3, 2, 1]
    ta, ja = TE._Averager(version, mode), JE._Averager(version, mode)
    for (t, j), w in zip(outs, weights):
        ta.update(t, w)
        ja.update(j, w)
    got, want = ta.result("val"), ja.result("val")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert TE._Averager(version, mode).result("x") == {"x_loss": 0.0}


def test_evaluate_matches_jax():
    jm = JaxUNet(num_classes=2, base_features=16, use_se=True)
    v = jm.init(jax.random.key(3), jnp.zeros((1, 16, 16, 1)))
    tm = _port_unet(v, True, False)
    loader = [synthetic_batch(2, 16, seed=s) for s in range(3)]
    loader[2] = {**loader[2], "n_valid": 1}
    want = JE.evaluate(JE.make_eval_step(jm, 2), v["params"],
                       v["batch_stats"], loader, verbose=False)
    got = TE.evaluate(TE.make_eval_step(tm, 2), loader, verbose=False)
    assert sorted(got) == sorted(want)
    for k in want:
        rel = 1e-5 if k.endswith("loss") else 1e-6
        assert got[k] == pytest.approx(want[k], rel=rel), k
    predict = lambda img: tm.eval()(img.permute(0, 3, 1, 2)) \
        .permute(0, 2, 3, 1)
    on_module = TE.evaluate(TE.make_engine_eval_step(predict, 2, device=CPU),
                            loader, verbose=False)
    for k in got:
        assert on_module[k] == pytest.approx(got[k], rel=1e-6), k
    serve = make_engine("unet", "channel", tm, None, "serve", device=CPU)
    on_serve = TE.evaluate(TE.make_engine_eval_step(serve, 2, device=CPU),
                           loader, verbose=False)
    assert sorted(on_serve) == sorted(got)
    assert on_serve["val_loss"] == pytest.approx(got["val_loss"], rel=1e-4)


# ---------------------------------------------------------------------------
# fit, resume, checkpoints, history
# ---------------------------------------------------------------------------

def _cfg(**kw):
    return get_preset("unet-channelattention", **{
        "image_size": 16, "batch_size": 2, "num_epochs": 2,
        "log_every_steps": 2, **kw})


def _loaders():
    return ([synthetic_batch(2, 16, seed=s) for s in range(3)],
            [synthetic_batch(2, 16, seed=10 + s) for s in range(2)])


def _jax_history_keys(version=2):
    avg = JE._Averager(version, "batch_mean")
    out = JM.confusion_counts(jnp.zeros((1, 2, 2, 2)),
                              jnp.zeros((1, 2, 2), jnp.int32), 2)
    avg.update({**out, "loss": jnp.float32(0)}, 1)
    keys = ["epoch"] + sorted(avg.result("train")) + sorted(
        avg.result("val"))
    return sorted(keys)


def test_fit_writes_the_jax_history_keys(tmp_path):
    train, val = _loaders()
    ck = Checkpointer(str(tmp_path / "ck"))
    hist = TE.fit(UNet(base_features=16, use_se=True), _cfg(), train, val,
                  checkpointer=ck, verbose=False, device=CPU)
    assert [h["epoch"] for h in hist] == [1, 2]
    assert all(sorted(h) == _jax_history_keys() for h in hist)
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    path = str(tmp_path / "hist" / "h.json")
    save_history(hist, path)
    assert load_history(path) == json.loads(json.dumps(hist))
    assert ck.has_latest() and ck.best_metric() >= 0.0
    fresh = UNet(base_features=16, use_se=True)
    sd = ck.restore_best(fresh)
    assert set(sd) == set(fresh.state_dict())


def _seeded_state(seed=0):
    return TE.create_state(UNet(base_features=16, use_se=True), LR,
                           seed=seed, device=CPU)


def test_resume_equals_a_straight_run(tmp_path):
    train, val = _loaders()
    s0 = _seeded_state()
    straight = TE.fit(s0.model, _cfg(), train, val, state=s0, verbose=False,
                      device=CPU)
    ck = Checkpointer(str(tmp_path / "ck"))
    s1 = _seeded_state()
    first = TE.fit(s1.model, _cfg(num_epochs=1), train, val, state=s1,
                   checkpointer=ck, verbose=False, device=CPU)
    rest = TE.fit(UNet(base_features=16, use_se=True), _cfg(), train, val,
                  checkpointer=ck, resume=True, verbose=False, device=CPU)
    assert [h["epoch"] for h in first + rest] == [1, 2]
    for a, b in zip(straight, first + rest):
        assert sorted(a) == sorted(b)
        for k in a:
            assert b[k] == pytest.approx(a[k], abs=1e-6), k


def test_fit_keeps_the_weights_the_model_holds():
    """Without ``state`` fit trains the weights it is given (loaded from a
    checkpoint or crossed from the JAX package), never a fresh init."""
    train, val = _loaders()
    loaded = _seeded_state(3).model.state_dict()
    model = UNet(base_features=16, use_se=True)
    model.load_state_dict(loaded)
    assert TE.fit(model, _cfg(num_epochs=0), train, val, verbose=False,
                  device=CPU) == []
    for k, v in model.state_dict().items():
        assert torch.equal(v, loaded[k]), k
    # one epoch from those weights equals one from an explicit state over
    # the same weights
    TE.fit(model, _cfg(num_epochs=1), train, verbose=False, device=CPU)
    twin = UNet(base_features=16, use_se=True)
    twin.load_state_dict(loaded)
    TE.fit(twin, _cfg(num_epochs=1), train, verbose=False, device=CPU,
           state=TE.create_state(twin, LR, device=CPU))
    for (k, a), b in zip(model.state_dict().items(),
                         twin.state_dict().values()):
        assert torch.equal(a, b), k


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    torch.manual_seed(0)
    model = UNet(base_features=16, use_se=True)
    state = TE.create_state(model, LR, seed=1, device=CPU)
    step = TE.make_train_step(model, 2)
    for s in range(2):
        b = synthetic_batch(2, 16, seed=s)
        step(state, b["image"], b["mask"])
    ck = Checkpointer(str(tmp_path))
    ck.save_latest(state)
    ck.save_best(state, 0.25)
    other = TE.create_state(UNet(base_features=16, use_se=True), LR,
                            seed=2, device=CPU)
    assert not torch.equal(other.model.inc.double_conv[0].weight,
                           model.inc.double_conv[0].weight)
    ck.restore_latest(other)
    assert other.step == state.step == 2
    for (k, a), (k2, b) in zip(model.state_dict().items(),
                               other.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    sa, sb = state.optimizer.state_dict(), other.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sorted(sa["state"]) == sorted(sb["state"])
    for i, st in sa["state"].items():
        for k, t in st.items():
            assert torch.equal(t, sb["state"][i][k]), (i, k)
    assert ck.best_metric() == 0.25
    best = ck.restore_best()
    assert all(torch.equal(best[k], v) for k, v in model.state_dict().items())


def test_init_is_seeded_and_keeps_the_callers_rng():
    a, b = UNet(base_features=16), UNet(base_features=16)
    torch.manual_seed(123)
    before = torch.rand(3)
    torch.manual_seed(123)
    TE.create_state(a, seed=7, device=CPU)
    assert torch.equal(torch.rand(3), before)
    TE.create_state(b, seed=7, device=CPU)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


def test_fit_refuses_what_it_does_not_port():
    train, _ = _loaders()
    model = UNet(base_features=16, use_se=True)
    with pytest.raises(NotImplementedError, match="item 16"):
        TE.fit(model, _cfg(mesh_data=2), train, device=CPU)
    with pytest.raises(ValueError, match="re-iterable"):
        TE.fit(model, _cfg(), iter(train), device=CPU)


def test_config_matches_the_jax_package():
    from insarseg.config import PRESETS as JAX_PRESETS
    from insarseg.config import Config as JaxConfig
    from insarseg_torch.config import PRESETS, Config

    # the port has the JAX package's fields, in its order, with its
    # defaults and its value in every preset
    names = [f.name for f in dataclasses.fields(Config)]
    assert names == [f.name for f in dataclasses.fields(JaxConfig)]
    assert list(PRESETS) == list(JAX_PRESETS)
    for k, cfg in [("default", JaxConfig()), *JAX_PRESETS.items()]:
        ours = Config() if k == "default" else PRESETS[k]
        for n in names:
            assert getattr(ours, n) == getattr(cfg, n), (k, n)
