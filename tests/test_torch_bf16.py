"""bf16 compute in the port (``compute_dtype='bfloat16'``: the input enters
in bf16 and every layer follows it, ``insarseg_torch/ops/layers.py``)
against the JAX package's ``dtype=bfloat16`` modules, on weights made with
numpy from a seed and read into both packages:

- the eval-mode forward of U-Net-CA, U-Net-SA and the fast cell (base /
  level 1 16) and of FCN-CA, DeepLabV3 and PSPNet-CA (full ResNet-50
  widths), 32^2 b2, against the JAX package's jitted bf16 ``apply``:
  within ``FWD_BAR`` x max|logit| and argmax agreement >= ``FWD_AGREE``.
  Two bf16 graphs that round at other places; the readings: 4.2e-3
  (U-Net-CA), 9.5e-3 (U-Net-SA), 6.4e-3 (fast cell), 9.9e-3 (FCN-CA),
  1.1e-2 (DeepLabV3), 1.9e-2 (PSPNet-CA) x max|logit|, argmax agreement
  0.9966 (U-Net-SA) to 1;
- U-Net-CA's bf16 train step (base 16, 32^2 b4), 3 steps from crossed
  weights against the JAX package's jitted bf16 step: each loss within
  ``STEP_LOSS_BAR`` (relative; reading 1.6e-4). The parameters: Adam's
  first step is lr x sign(grad), so a parameter whose gradient lies
  within bf16's rounding of 0 steps either way; after step 1 at least
  ``STEP1_SHARE`` of them within 1e-5 of the JAX package's (reading
  0.855), after step 3 a mean |difference| of at most ``PARAM_MEAN_BAR``
  (reading 7.8e-5; the JAX package's own bf16 step ends 7.5e-5 from its
  f32 step on these weights, and the two f32 steps 2.6e-9 apart).
  Parameters, their gradients, Adam's state and BN's running statistics
  stay f32;
- FCN-CA in train mode (dropout off on both sides; batch statistics)
  against the JAX package's ``apply(train=True)``: in f32 the logits and
  running statistics within 1e-4 of their largest value (readings 3.3e-5,
  2.7e-6); in bf16 within ``TRAIN_RATIO`` times the JAX package's own
  bf16-to-f32 distance (readings 0.242 against 0.210 x max|logit|, 0.021
  against 0.018 for the statistics: train-mode BN over the 4x4 maps of a
  32^2 batch of 2 amplifies bf16 rounding in both packages);
- the bf16 step against the port's own f32 step from the same weights:
  losses within ``F32_LOSS_BAR`` (relative; reading 1.1e-4) over 3 steps;
- BN (``nn.BatchNorm2d`` and ``MomentBatchNorm2d``) returns bf16 on a
  bf16 input and keeps f32 statistics; every family's bf16 train step
  runs with f32 parameters and Adam state and a finite loss; ``fit`` in
  bf16 keeps them f32, and a resumed bf16 run equals a straight one bit
  for bit (the checkpoints are f32); the module engine
  with ``input_dtype=bfloat16`` equals the module on a bf16 input and
  leaves the model's parameters f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from insarseg.compat.torch_io import (
    segmentation_variables_from_torch as jax_segmentation_from_torch,
)
from insarseg.compat.torch_io import unet_variables_from_torch
from insarseg.models.fcn import FCN as JaxFCN
from insarseg.models.pspnet import PSPNet as JaxPSPNet
from insarseg.models.registry import build as jax_build
from insarseg.models.unet import UNet as JaxUNet
from insarseg.models.unet_stem import UNetFastS2D as JaxFast
from insarseg.train import engine as JE
from insarseg_torch.compat import (
    pspnet_variables_to_torch,
    state_dict_to_torch,
)
from insarseg_torch.config import get_preset
from insarseg_torch.data.synthetic import synthetic_batch
from insarseg_torch.engines import make_engine
from insarseg_torch.models.registry import build
from insarseg_torch.models.unet import UNet
from insarseg_torch.models.unet_stem import UNetFastS2D
from insarseg_torch.ops.layers import MomentBatchNorm2d
from insarseg_torch.train import engine as TE
from tests.test_torch_common import CPU, resnet_numpy_state_dict, smooth
from tests.test_torch_pspnet import numpy_pspnet_variables

BF16 = torch.bfloat16
FWD_BAR, FWD_AGREE = 3e-2, 0.99
STEP_LOSS_BAR, STEP1_SHARE, PARAM_MEAN_BAR = 1e-3, 0.8, 1e-4
F32_LOSS_BAR = 2e-3
TRAIN_RATIO = 1.5
LR, STEPS = 1e-4, 3
BASE = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: the test run shares the host's cores between
    its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_sd(model, seed):
    """``model``'s state_dict drawn with numpy from ``seed``."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    return resnet_numpy_state_dict(shapes, seed)


def _unet_pair(attention, seed=0):
    """(JAX bf16 module, JAX variables, port module) of a U-Net cell at base
    ``BASE`` on one set of numpy weights."""
    use_se, use_sa = attention == "channel", attention == "spatial"
    tm = UNet(num_classes=2, base_features=BASE, use_se=use_se, use_sa=use_sa)
    sd = _numpy_sd(tm, seed)
    tm.load_state_dict(state_dict_to_torch(sd), strict=True)
    v = unet_variables_from_torch(sd, use_se=use_se, use_sa=use_sa)
    jm = JaxUNet(num_classes=2, base_features=BASE, use_se=use_se,
                 use_sa=use_sa, dtype=jnp.bfloat16)
    return jm, v, tm


def _pair(cell, seed=0):
    if cell in ("unet-ca", "unet-sa"):
        return _unet_pair("channel" if cell == "unet-ca" else "spatial", seed)
    if cell == "fast-ca":
        tm = UNetFastS2D(num_classes=2, level1_features=BASE, use_se=True)
        sd = _numpy_sd(tm, seed)
        tm.load_state_dict(state_dict_to_torch(sd), strict=True)
        inner = unet_variables_from_torch(
            {k[len("unet."):]: a for k, a in sd.items()}, use_se=True)
        v = {"params": {"unet": inner["params"]},
             "batch_stats": {"unet": inner["batch_stats"]}}
        jm = JaxFast(num_classes=2, level1_features=BASE, use_se=True,
                     dtype=jnp.bfloat16)
        return jm, v, tm
    if cell == "pspnet-ca":
        v = numpy_pspnet_variables("channel", seed)
        tm = build("pspnet", "channel")
        tm.load_state_dict(state_dict_to_torch(
            pspnet_variables_to_torch(v, "channel")), strict=True)
        return JaxPSPNet(attention="channel", dtype=jnp.bfloat16), v, tm
    model, attention = {"fcn-ca": ("fcn", "channel"),
                        "deeplabv3": ("deeplabv3", "none")}[cell]
    tm = build(model, attention)
    sd = _numpy_sd(tm, seed)
    tm.load_state_dict(state_dict_to_torch(sd), strict=True)
    v = jax_segmentation_from_torch(sd, model, attention)
    return jax_build(model, attention, dtype=jnp.bfloat16), v, tm


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().detach().numpy()


CELLS = ["unet-ca", "unet-sa", "fast-ca", "fcn-ca", "deeplabv3",
         "pspnet-ca"]


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_forward_matches_jax(cell):
    jm, v, tm = _pair(cell)
    x = smooth(np.random.default_rng(1), (2, 32, 32, 1))
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x)).astype(jnp.float32))
    tm.eval()
    with torch.no_grad():
        y = tm(_nchw(x).to(BF16))
    assert y.dtype == BF16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    got = _nhwc(y)
    rel = _rel(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"{cell}: bf16 forward vs JAX {rel:.3g} x max|logit|, argmax "
          f"agreement {agree:.5f}")
    assert rel <= FWD_BAR, rel
    assert agree >= FWD_AGREE, agree


def _batches(batch=4, size=32, n=STEPS):
    rng = np.random.default_rng(7)
    return [(smooth(rng, (batch, size, size, 1)),
             rng.integers(0, 2, (batch, size, size)).astype(np.int32))
            for _ in range(n)]


def _flat(tree, prefix=""):
    for k, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(val)


def _port_params(tm):
    return dict(_flat(unet_variables_from_torch(
        {k: t.detach().numpy() for k, t in tm.state_dict().items()},
        use_se=True)["params"]))


def test_bf16_train_steps_match_jax():
    jm, v, tm = _unet_pair("channel")
    tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    params = jax.tree.map(jnp.asarray, v["params"])
    jstate = JE.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray,
                                                    v["batch_stats"]),
                           opt_state=tx.init(params), tx=tx)
    jstep = JE.make_train_step(jm, 2)
    tstate = TE.create_state(tm, LR, device=CPU)
    tstep = TE.make_train_step(tm, 2, compute_dtype=BF16)
    jl, tl, dist = [], [], []
    for s, (x, m) in enumerate(_batches()):
        jstate, jout = jstep(jstate, jnp.asarray(x), jnp.asarray(m),
                             jax.random.key(s))
        tout = tstep(tstate, torch.from_numpy(x), torch.from_numpy(m))
        assert tout["loss"].dtype == torch.float32
        jl.append(float(jout["loss"]))
        tl.append(float(tout["loss"]))
        want = dict(_flat(jax.tree.map(np.asarray, jstate.params)))
        got = _port_params(tm)
        assert sorted(got) == sorted(want)
        d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        dist.append((float((d <= 1e-5).mean()), float(d.mean())))
    rel = np.abs(np.subtract(tl, jl)) / np.abs(jl)
    print(f"bf16 losses jax {jl} port {tl} (rel {rel.max():.3g}); "
          f"parameters (share within 1e-5, mean |diff|) by step {dist}")
    assert rel.max() <= STEP_LOSS_BAR, rel
    assert dist[0][0] >= STEP1_SHARE, dist
    assert dist[-1][1] <= PARAM_MEAN_BAR, dist
    assert tstate.step == STEPS and tl[-1] != tl[0]
    for p in tm.parameters():
        # (the DoubleConv conv biases get no gradient in train mode)
        assert p.dtype == torch.float32
        assert p.grad is None or p.grad.dtype == torch.float32
    for st in tstate.optimizer.state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype \
            == torch.float32
    for name, buf in tm.named_buffers():
        if "running" in name:
            assert buf.dtype == torch.float32, name


def test_bf16_train_mode_forward_matches_jax_fcn():
    """FCN-CA in train mode (batch statistics, running statistics
    updated), dropout off on both sides, in f32 and in bf16. Train-mode BN
    over the 4x4 maps of a 32^2 batch of 2 amplifies bf16 rounding: the JAX
    package's own bf16 logits lie 0.21 x max|logit| from its f32 ones, so
    the bar is relative to that distance."""
    tm = build("fcn", "channel")
    sd = _numpy_sd(tm, 2)
    v = jax_segmentation_from_torch(sd, "fcn", "channel")
    for m in tm.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    x = smooth(np.random.default_rng(3), (2, 32, 32, 1))
    out = {}
    for name, jdt, tdt in (("f32", None, torch.float32),
                           ("bf16", jnp.bfloat16, BF16)):
        jm = JaxFCN(2, "channel", dropout_rate=0.0, dtype=jdt)
        y, mutated = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
        tm.load_state_dict(state_dict_to_torch(sd), strict=True)
        tm.train()
        with torch.no_grad():
            got = _nhwc(tm(_nchw(x).to(tdt)))
        stats = jax_segmentation_from_torch(
            {k: t.numpy().copy() for k, t in tm.state_dict().items()},
            "fcn", "channel")["batch_stats"]
        out[name] = (np.asarray(y.astype(jnp.float32)), got,
                     dict(_flat(jax.tree.map(np.asarray,
                                             mutated["batch_stats"]))),
                     dict(_flat(stats)))

    def stat_dist(a, b):  # relative to each statistic's largest value
        return max(_rel(a[k], b[k]) for k in a)

    (jf, tf, jsf, tsf), (jb, tb, jsb, tsb) = out["f32"], out["bf16"]
    f32_rel, bf16_rel, ref_rel = _rel(tf, jf), _rel(tb, jb), _rel(jb, jf)
    bf16_stats, ref_stats = stat_dist(tsb, jsb), stat_dist(jsb, jsf)
    print(f"fcn-ca train mode: port vs JAX f32 {f32_rel:.3g}, bf16 "
          f"{bf16_rel:.3g} x max|logit| (JAX bf16 vs f32 {ref_rel:.3g}); "
          f"running statistics bf16 {bf16_stats:.3g} (JAX bf16 vs f32 "
          f"{ref_stats:.3g}), f32 {stat_dist(tsf, jsf):.3g}")
    assert f32_rel <= 1e-4, f32_rel
    assert stat_dist(tsf, jsf) <= 1e-4
    assert bf16_rel <= TRAIN_RATIO * ref_rel, (bf16_rel, ref_rel)
    assert bf16_stats <= TRAIN_RATIO * ref_stats, (bf16_stats, ref_stats)


def test_bf16_step_near_the_f32_step():
    losses = {}
    for dtype in (torch.float32, BF16):
        _, _, tm = _unet_pair("channel", seed=4)
        state = TE.create_state(tm, LR, device=CPU)
        step = TE.make_train_step(tm, 2, compute_dtype=dtype)
        losses[dtype] = [float(step(state, torch.from_numpy(x),
                                    torch.from_numpy(m))["loss"])
                         for x, m in _batches()]
    f32, b16 = np.array(losses[torch.float32]), np.array(losses[BF16])
    rel = np.abs(b16 - f32) / np.abs(f32)
    print(f"losses f32 {f32} bf16 {b16} (rel {rel.max():.3g})")
    assert rel.max() <= F32_LOSS_BAR, rel


@pytest.mark.parametrize("model,attention", [
    ("unet-fast", "spatial"), ("deeplabv3", "channel"), ("fcn", "spatial"),
    ("pspnet", "channel")])
def test_every_family_trains_in_bf16(model, attention):
    if model == "unet-fast":
        tm = UNetFastS2D(num_classes=2, level1_features=BASE, use_sa=True)
    else:
        tm = build(model, attention)
    state = TE.create_state(tm, LR, seed=0, device=CPU)
    step = TE.make_train_step(tm, 2, compute_dtype=BF16)
    b = synthetic_batch(2, 32, seed=1)
    out = step(state, torch.from_numpy(b["image"]),
               torch.from_numpy(b["mask"]))
    assert np.isfinite(float(out["loss"]))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(s["exp_avg"].dtype == torch.float32
               for s in state.optimizer.state.values())


def test_fit_in_bf16_keeps_f32_state():
    cfg = get_preset("unet-channelattention", image_size=16, batch_size=2,
                     num_epochs=2, log_every_steps=1000,
                     compute_dtype="bfloat16")
    train = [synthetic_batch(2, 16, seed=s) for s in range(2)]
    val = [synthetic_batch(2, 16, seed=10)]
    state = TE.create_state(UNet(base_features=BASE, use_se=True), LR,
                            seed=0, device=CPU)
    hist = TE.fit(state.model, cfg, train, val, state=state, verbose=False,
                  device=CPU)
    assert [h["epoch"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
               for h in hist)
    assert state.step == 4
    assert all(t.dtype in (torch.float32, torch.int64)
               for t in state.model.state_dict().values())
    assert all(s["exp_avg_sq"].dtype == torch.float32
               for s in state.optimizer.state.values())
    with pytest.raises(ValueError, match="compute_dtype"):
        TE.fit(state.model, cfg.__class__(compute_dtype="float16"), train,
               device=CPU)


@pytest.mark.parametrize("bn_cls", [nn.BatchNorm2d, MomentBatchNorm2d])
def test_batchnorm_takes_bf16_and_keeps_f32_statistics(bn_cls):
    """BN on a bf16 input with f32 parameters returns bf16, in train and
    eval mode, and keeps its running statistics f32; its train-mode
    output within bf16's rounding of the f32 input's."""
    bn = bn_cls(6)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 6, 5, 7)).astype(np.float32) * 3 + 1)
    with torch.no_grad():
        ref = bn_cls(6).train()(x)
        y = bn.train()(x.to(BF16))
        assert y.dtype == BF16 and bn.running_mean.dtype == torch.float32
        # |y| <= ~3: bf16's 2^-8 relative rounding of input and output
        assert float((y.float() - ref).abs().max()) <= 4e-2
        assert bn.eval()(x.to(BF16)).dtype == BF16
    assert bn.running_var.dtype == torch.float32


def test_bf16_resume_equals_a_straight_run(tmp_path):
    """Checkpoints keep f32 weights and Adam state: 2 bf16 epochs straight
    equal 1 epoch, a checkpoint and a resumed second epoch."""
    from insarseg_torch.train.checkpoint import Checkpointer

    cfg = get_preset("unet-channelattention", image_size=16, batch_size=2,
                     num_epochs=2, log_every_steps=1000,
                     compute_dtype="bfloat16")
    train = [synthetic_batch(2, 16, seed=s) for s in range(2)]

    def state():
        return TE.create_state(UNet(base_features=BASE, use_se=True), LR,
                               seed=1, device=CPU)

    s0 = state()
    straight = TE.fit(s0.model, cfg, train, state=s0, verbose=False,
                      device=CPU)
    ck = Checkpointer(str(tmp_path / "ck"))
    s1 = state()
    first = TE.fit(s1.model, dataclasses.replace(cfg, num_epochs=1), train,
                   state=s1, checkpointer=ck, verbose=False, device=CPU)
    s2 = state()
    rest = TE.fit(s2.model, cfg, train, state=s2, checkpointer=ck,
                  resume=True, verbose=False, device=CPU)
    assert [h["epoch"] for h in first + rest] == [1, 2]
    assert straight == first + rest
    for (k, a), b in zip(s0.model.state_dict().items(),
                         s2.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_module_engine_bf16_is_the_bf16_module():
    _, _, tm = _unet_pair("spatial", seed=5)
    x = smooth(np.random.default_rng(6), (2, 32, 32, 1))
    predict = make_engine("unet", "spatial", tm, None, "module",
                          input_dtype=BF16, device=CPU)
    got = predict(x)
    assert got.dtype == BF16
    with torch.no_grad():
        want = tm.eval()(_nchw(x).to(BF16)).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
