"""The rank functions of the port's spatial-mesh tests
(``tests/test_torch_spatial_train.py``): each runs in one process of
``insarseg_torch.parallel.launch`` and returns CPU tensors and numbers.
They import torch and the port only, so a rank starts without JAX."""

import torch
import torch.nn.functional as F

from insarseg_torch.parallel import mesh as P
from insarseg_torch.parallel.spatial import halo
from insarseg_torch.train import engine as TE
from tests.torch_mesh_ranks import _cpu, fit_and_resume


def halo_case(x, w, gy, spatial: int, channels_last: bool):
    """A "same" conv of ``w`` (k = its H radius) over this rank's slab of
    ``x`` (rows by its data coordinate, then its slab) through
    :func:`halo` under its spatial group, forward and backward with the
    output gradient ``gy``'s slab. Returns the slab's output and input
    gradient, the weight gradient and where the slab lies."""
    comm = P.spatial_comm(spatial)
    d, s = P.coords(spatial)
    rows = P.rows_of(len(x), d, P.world() // spatial)
    slab = P.slab_of(x.shape[2], s, spatial)
    k, pw = w.shape[2] // 2, w.shape[3] // 2
    xs = x[rows][:, :, slab].clone()
    if channels_last:
        xs = xs.contiguous(memory_format=torch.channels_last)
    xs.requires_grad_(True)
    w = w.clone().requires_grad_(True)
    padded = halo(xs, k, comm)
    y = F.conv2d(padded, w, padding=(0, pw))
    (y * gy[rows][:, :, slab]).sum().backward()
    return _cpu({"y": y, "gx": xs.grad, "gw": w.grad, "rows": rows,
                 "slab": slab, "padded_cl": padded.is_contiguous(
                     memory_format=torch.channels_last),
                 "gx_cl": xs.grad.is_contiguous(
                     memory_format=torch.channels_last)})


def no_dropout(model):
    """``model`` with its dropout off: a mesh step equals one device's
    only without it (each rank draws its own mask)."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def fcn_ca():
    """FCN-ResNet50-CA, dropout off, every BatchNorm a
    ``MomentBatchNorm2d`` in one process too (``fit``'s ResNet family)."""
    from insarseg_torch.models.registry import build

    return P.sync_batchnorm(no_dropout(build("fcn", "channel")))


def _build(kind: str, state_dict, lr: float, remat: bool = False,
           double: bool = False):
    """``kind``: ``unet-ca`` (base 16), ``unet-sa`` (base 8) or a ResNet
    family's ``model-attention`` (``fcn-channel``: dropout off, every
    BatchNorm a ``MomentBatchNorm2d`` in one process too); ``double``:
    in float64."""
    from insarseg_torch.models.registry import build
    from insarseg_torch.models.unet import UNet

    if kind == "unet-ca":
        model = UNet(num_classes=2, base_features=16, use_se=True,
                     remat=remat)
    elif kind == "unet-sa":
        model = UNet(num_classes=2, base_features=8, use_sa=True,
                     remat=remat)
    else:
        # every BN the JAX package's moment rule, as under a group
        model = P.sync_batchnorm(no_dropout(build(*kind.split("-"))))
    if double:
        model.double()
    model.load_state_dict(state_dict, strict=True)
    state = TE.create_state(model, lr, device="cpu")
    state.optimizer = torch.optim.SGD(model.parameters(), lr=lr)
    return state


def spatial_steps(kind: str, state_dict, batches, spatial: int,
                  augment: bool, remat: bool = False, lr: float = 0.1,
                  double: bool = False):
    """One SGD step of ``kind`` (:func:`_build`) from ``state_dict`` on
    each global batch (image, mask) of ``batches``, each from the same
    weights, on a mesh of ``spatial`` slabs a row (1 without a group:
    one process): the step's outputs and the state_dict after it."""
    out = []
    for image, mask in batches:
        state = _build(kind, state_dict, lr, remat, double)
        step = TE.make_train_step(state.model, 2, augment=augment,
                                  spatial=spatial)
        res = step(state, torch.from_numpy(image), torch.from_numpy(mask))
        out.append((_cpu(res), _cpu(state.model.state_dict())))
    return out


def replicated_bn_case(x, gy, spatial: int):
    """A synced ``MomentBatchNorm2d`` over a map that every slab of a data
    row holds whole (``x``'s rows by this rank's data coordinate, as a
    pool leaves them), in train mode under the row's spatial group,
    marked ``replicated`` and not: each slab's loss takes its share of
    ``gy`` (shares summing to 1 over the slabs, as each slab's part of a
    loss gives it). Returns, for each, the output, the input gradient
    (this slab's share), the parameters' gradients (summed over the
    ranks) and the running statistics."""
    from torch import nn

    from insarseg_torch.ops.layers import MomentBatchNorm2d
    from insarseg_torch.parallel.spatial import active

    comm = P.spatial_comm(spatial)
    d, s = P.coords(spatial)
    rows = P.rows_of(len(x), d, P.world() // spatial)
    share = (s + 1) / (spatial * (spatial + 1) / 2)
    out = {"rows": rows}
    for replicated in (True, False):
        c = x.shape[1]
        bn = MomentBatchNorm2d(c)
        bn.replicated = replicated
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, c))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, c))
        holder = P.sync_batchnorm(nn.Sequential(bn))
        xl = x[rows].clone().requires_grad_(True)
        with active(comm):
            y = holder(xl)
            (y * gy[rows] * share).sum().backward()
        P.all_reduce_grads(holder.parameters())
        out[replicated] = _cpu({"y": y, "gx": xl.grad, "gw": bn.weight.grad,
                                "gb": bn.bias.grad, "rm": bn.running_mean,
                                "rv": bn.running_var})
    return out


def resnet_fit(cfg, state_dict, train, val, directory, odd, sgd):
    """:func:`fit_and_resume` of FCN-ResNet50-CA (dropout off; SGD at
    ``sgd``), then a ``fit`` on the global batches ``odd``, whose slabs
    break the ResNet families' slab rule: what it raises."""
    import dataclasses

    out = fit_and_resume(cfg, state_dict, train, val, directory, fcn_ca,
                         sgd)
    try:
        TE.fit(fcn_ca(), dataclasses.replace(cfg, num_epochs=1), odd,
               device="cpu")
    except ValueError as e:
        out["slab"] = str(e)
    return out


def run_cases(cases):
    """Each ``(function name, args)`` of ``cases`` in turn, on every rank
    in the same order (the spatial groups are made collectively): one
    launch for many cases."""
    funcs = {"halo": halo_case, "steps": spatial_steps,
             "fit": fit_and_resume, "bn": replicated_bn_case,
             "resnet_fit": resnet_fit}
    return [funcs[name](*args) for name, args in cases]
