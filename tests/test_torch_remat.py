"""``remat`` in the port: each U-Net DoubleConv (``inc``, ``down{i}[1]``,
``conv{i}``; the fast cell's inner ones) recomputed in the backward pass
under ``torch.utils.checkpoint``, the JAX package's ``nn.remat`` — the
port's ``tests/test_unet.py::test_remat_identical_training_step``:

- from one set of weights, a train-mode forward and backward and two train
  steps with and without remat are bit-equal on the CPU: the logits, the
  loss, every gradient, the parameters, Adam's state, the step's counts
  and the BN running statistics with ``num_batches_tracked`` (1 per step:
  the recompute leaves them as the first run did); U-Net-CA in f32 and
  bf16, U-Net-SA and the fast cell in f32;
- remat really recomputes: each rematerialized block's first conv runs twice
  a step (9 blocks of the U-Net; SA's ``compress_and_map`` once, as in
  the JAX package); eval mode and a forward without autograd do not
  checkpoint;
- the DoubleConv conv biases get no gradient in the recompute either;
- the other families raise the JAX package's ``ValueError``, and
  ``build_model`` reads ``Config.remat``.
"""

import numpy as np
import pytest
import torch

from insarseg.models.registry import build as jax_build
from insarseg_torch.config import get_preset
from insarseg_torch.models.registry import build, build_model
from insarseg_torch.models.unet import UNet
from insarseg_torch.models.unet_stem import UNetFastS2D
from insarseg_torch.ops import blocks
from insarseg_torch.train import engine as TE
from insarseg_torch.train.losses import cross_entropy_loss
from tests.test_torch_common import CPU, smooth

BASE = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(cell, remat):
    if cell == "fast-ca":
        return UNetFastS2D(num_classes=2, level1_features=BASE, use_se=True,
                           remat=remat)
    return UNet(num_classes=2, base_features=BASE,
                use_se=cell == "unet-ca", use_sa=cell == "unet-sa",
                remat=remat)


def _data(seed=3, batch=2, size=32):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(smooth(rng, (batch, size, size, 1))),
             torch.from_numpy(rng.integers(0, 2, (batch, size, size))))
            for _ in range(2)]


def _run(cell, remat, dtype, sd):
    """The logits, loss, gradients and state of one forward and backward,
    then the outputs and state of two train steps."""
    model = _model(cell, remat)
    model.load_state_dict(sd, strict=True)
    model.train()
    (x, m), batches = _data()[0], _data()
    logits = model(x.permute(0, 3, 1, 2).to(dtype))
    loss = cross_entropy_loss(logits.permute(0, 2, 3, 1), m)
    loss.backward()
    first = {"logits": logits.detach(), "loss": loss.detach(),
             **{f"grad/{k}": p.grad for k, p in model.named_parameters()
                if p.grad is not None},
             **{f"state/{k}": v.clone()
                for k, v in model.state_dict().items()}}
    model.load_state_dict(sd, strict=True)
    state = TE.create_state(model, 1e-4, device=CPU)
    step = TE.make_train_step(model, 2, compute_dtype=dtype)
    outs = [step(state, bx, bm) for bx, bm in batches]
    after = {**{f"step{i}/{k}": v for i, o in enumerate(outs)
                for k, v in o.items()},
             **{f"state/{k}": v.clone()
                for k, v in model.state_dict().items()}}
    for i, st in state.optimizer.state.items():
        after.update({f"adam/{i}/{k}": v for k, v in st.items()})
    return first, after, model


@pytest.mark.parametrize("cell,dtype", [
    ("unet-ca", torch.float32), ("unet-ca", torch.bfloat16),
    ("unet-sa", torch.float32), ("fast-ca", torch.float32)])
def test_remat_identical_training_step(cell, dtype):
    torch.manual_seed(0)
    sd = {k: v.clone() for k, v in _model(cell, False).state_dict().items()}
    first0, after0, _ = _run(cell, False, dtype, sd)
    first1, after1, model = _run(cell, True, dtype, sd)
    for ref, got in ((first0, first1), (after0, after1)):
        assert sorted(ref) == sorted(got)
        for k in ref:
            assert ref[k].dtype == got[k].dtype, k
            assert torch.equal(ref[k], got[k]), k
    tracked = [v for k, v in after1.items()
               if k.endswith("num_batches_tracked")]
    assert tracked and all(int(v) == 2 for v in tracked)
    assert first1["logits"].dtype == dtype


def _layer_calls(model, x):
    """How often each DoubleConv's first conv runs in one train-mode
    forward and backward (the recompute may stop before the block's last
    layer, once the tensors the backward needs are back)."""
    calls = {}

    def hook(mod, inp, out):
        calls[mod] = calls.get(mod, 0) + 1

    hooks = [dc.double_conv[0].register_forward_hook(hook)
             for dc in model.modules() if isinstance(dc, blocks.DoubleConv)]
    try:
        model.train()
        cross_entropy_loss(model(x).permute(0, 2, 3, 1),
                           torch.zeros(x.shape[0], *x.shape[2:],
                                       dtype=torch.long)).backward()
    finally:
        for h in hooks:
            h.remove()
    return sorted(calls.values())


@pytest.mark.parametrize("use_sa", [False, True])
def test_remat_recomputes_the_unet_blocks(use_sa, monkeypatch):
    x = torch.from_numpy(smooth(np.random.default_rng(0),
                                (2, 32, 32, 1))).permute(0, 3, 1, 2)
    sa_blocks = [1] * 4 if use_sa else []
    plain = UNet(base_features=BASE, use_sa=use_sa)
    assert _layer_calls(plain, x) == [1] * (9 + len(sa_blocks))
    remat = UNet(base_features=BASE, use_sa=use_sa, remat=True)
    assert _layer_calls(remat, x) == sa_blocks + [2] * 9
    # no checkpoint in eval mode, nor without autograd
    seen = []
    real = blocks.checkpoint
    monkeypatch.setattr(blocks, "checkpoint",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    remat.eval()
    remat(x)
    remat.train()
    with torch.no_grad():
        remat(x)
    assert not seen
    remat(x)
    assert len(seen) == 9


def test_remat_keeps_the_dc_biases_out_of_the_gradient():
    model = UNet(base_features=BASE, use_se=True, remat=True)
    biases = {k: p.detach().clone() for k, p in model.named_parameters()
              if ".double_conv." in k and k.endswith(("0.bias", "3.bias"))}
    assert len(biases) == 18
    state = TE.create_state(model, 1e-4, device=CPU)
    step = TE.make_train_step(model, 2)
    for x, m in _data():
        step(state, x, m)
    params = dict(model.named_parameters())
    for k, b in biases.items():
        assert params[k].grad is None, k
        assert torch.equal(params[k].detach(), b), k


@pytest.mark.parametrize("model", ["deeplabv3", "fcn", "pspnet"])
def test_remat_other_families_raise_the_jax_error(model):
    with pytest.raises(ValueError) as want:
        jax_build(model, "channel", remat=True)
    with pytest.raises(ValueError) as got:
        build(model, "channel", remat=True)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="UNet families only"):
        build_model(get_preset("pspnet", remat=True))


@pytest.mark.parametrize("preset", ["unet-channelattention",
                                    "unet-fast-ca"])
def test_build_model_reads_remat(preset):
    for remat in (False, True):
        model = build_model(get_preset(preset, remat=remat))
        dcs = [m for m in model.modules() if isinstance(m, blocks.DoubleConv)]
        assert len(dcs) == 9 and all(m.remat == remat for m in dcs)
