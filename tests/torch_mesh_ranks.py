"""The rank functions of the port's data-mesh tests
(``tests/test_torch_mesh*.py``): each runs in one process of
``insarseg_torch.parallel.launch`` and returns CPU tensors and numbers.
They import torch and the port only, so a rank starts without JAX."""

import torch
from torch import nn

from insarseg_torch.kernels.bn_act import bn_relu_train
from insarseg_torch.ops.layers import MomentBatchNorm2d
from insarseg_torch.parallel import mesh as P
from insarseg_torch.train import engine as TE


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# the synced BatchNorm
# ---------------------------------------------------------------------------

def bn_case(x: torch.Tensor, gy: torch.Tensor, dtype: torch.dtype,
            moment: bool = False):
    """One train-mode forward and backward of a BatchNorm over ``x``
    (this rank's rows of it under a group, the whole of it without),
    synced by ``sync_batchnorm``; a ``MomentBatchNorm2d`` with
    ``moment``. Returns the output and input gradient rows, the
    parameters' gradients (summed over the ranks) and the running
    statistics."""
    c = x.shape[1]
    bn = (MomentBatchNorm2d(c) if moment else nn.BatchNorm2d(c)).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, c))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, c))
    holder = P.sync_batchnorm(nn.Sequential(bn))
    rows = P.rows_of(len(x))
    xl = x[rows].to(dtype).requires_grad_(True)
    y = holder(xl)
    (y * gy[rows].to(dtype)).sum().backward()
    P.all_reduce_grads(holder.parameters())
    sync = holder[0]
    return _cpu({"y": y, "gx": xl.grad, "gw": sync.weight.grad,
                 "gb": sync.bias.grad, "rm": sync.running_mean,
                 "rv": sync.running_var})


def fused_case(x: torch.Tensor, gy: torch.Tensor, dtype: torch.dtype):
    """``relu(BN(x + bias))`` of a synced ``MomentBatchNorm2d`` two ways
    on this rank's rows: the fused epilogue (``bn_relu_train`` with the
    hook DoubleConv gives it, ``MomentBatchNorm2d.ranks_sum``) and the
    module itself under autograd. Returns ``{"fused": ..., "moment": ...}``, each as
    :func:`bn_case` returns it."""
    c = x.shape[1]
    bias = torch.linspace(-0.3, 0.3, c, dtype=dtype)
    rows = P.rows_of(len(x))
    out = {}
    for kind in ("fused", "moment"):
        bn = MomentBatchNorm2d(c).to(dtype)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, c))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, c))
        holder = P.sync_batchnorm(nn.Sequential(bn))
        sync = holder[0]
        xl = x[rows].to(dtype).requires_grad_(True)
        if kind == "fused":
            y = bn_relu_train(xl, bias, sync.weight, sync.bias,
                              sync.running_mean, sync.running_var, sync.eps,
                              sync.momentum, sync.ranks_sum())
        else:
            y = torch.relu(holder(xl + bias[:, None, None]))
        (y * gy[rows].to(dtype)).sum().backward()
        P.all_reduce_grads(holder.parameters())
        out[kind] = _cpu({"y": y, "gx": xl.grad, "gw": sync.weight.grad,
                          "gb": sync.bias.grad, "rm": sync.running_mean,
                          "rv": sync.running_var})
    return out


def bn_cases(cases):
    """Each case's :func:`bn_case`, or :func:`fused_case` where its
    ``moment`` is ``"fused"``."""
    return [fused_case(*c[:3]) if c[3] == "fused" else bn_case(*c)
            for c in cases]


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _build(kind: str, state_dict, lr: float):
    if kind == "unet-ca":
        from insarseg_torch.models.unet import UNet

        model = UNet(num_classes=2, base_features=16, use_se=True)
    else:
        from insarseg_torch.models.registry import build

        model = build("fcn", "channel")
        for m in model.modules():  # dropout off: a mesh step equals one
            if isinstance(m, nn.Dropout):   # device's only without it
                m.p = 0.0
    model.load_state_dict(state_dict, strict=True)
    state = TE.create_state(model, lr, device="cpu")
    state.optimizer = torch.optim.SGD(model.parameters(), lr=lr)
    return state


def sgd_steps(kind: str, state_dict, batches, lr: float = 0.1):
    """One SGD step of ``kind`` from ``state_dict`` on each global batch
    (image, mask) of ``batches``, each from the same weights: the step's
    outputs and the state_dict after it."""
    out = []
    for image, mask in batches:
        state = _build(kind, state_dict, lr)
        step = TE.make_train_step(state.model, 2)
        res = step(state, torch.from_numpy(image), torch.from_numpy(mask))
        out.append((_cpu(res), _cpu(state.model.state_dict())))
    return out


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

def unet_ca16():
    from insarseg_torch.models.unet import UNet

    return UNet(num_classes=2, base_features=16, use_se=True)


def fit_and_resume(cfg, state_dict, train, val, directory,
                   build=unet_ca16, sgd=None):
    """``fit`` of ``build()`` (U-Net-CA base 16) for ``cfg.num_epochs``
    epochs with a ``Checkpointer`` in ``directory``, then a resume to one
    epoch more: both histories and the state after each run. ``sgd``: an
    SGD learning rate in place of ``fit``'s Adam."""
    import dataclasses

    from insarseg_torch.models.unet import UNet
    from insarseg_torch.train.checkpoint import Checkpointer

    def run(epochs, resume):
        model = build()
        model.load_state_dict(state_dict, strict=True)
        state = TE.create_state(model, cfg.learning_rate, device="cpu")
        if sgd is not None:
            state.optimizer = torch.optim.SGD(model.parameters(), lr=sgd)
        hist = TE.fit(model, dataclasses.replace(cfg, num_epochs=epochs),
                      train, val, state=state,
                      checkpointer=Checkpointer(directory), resume=resume,
                      device="cpu")
        return hist, _cpu(model.state_dict()), state.step

    first = run(cfg.num_epochs, False)
    resumed = run(cfg.num_epochs + 1, True)
    refused = None
    try:
        TE.fit(UNet(num_classes=2, base_features=16),
               dataclasses.replace(cfg, mesh_data=P.world() + 1), train,
               device="cpu")
    except ValueError as e:
        refused = str(e)
    return {"first": first, "resumed": resumed, "rank": P.rank(),
            "world": P.world(), "refused": refused}

