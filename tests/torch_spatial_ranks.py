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


def _build(kind: str, state_dict, lr: float, remat: bool = False):
    from insarseg_torch.models.unet import UNet

    if kind == "unet-ca":
        model = UNet(num_classes=2, base_features=16, use_se=True,
                     remat=remat)
    else:
        model = UNet(num_classes=2, base_features=8, use_sa=True,
                     remat=remat)
    model.load_state_dict(state_dict, strict=True)
    state = TE.create_state(model, lr, device="cpu")
    state.optimizer = torch.optim.SGD(model.parameters(), lr=lr)
    return state


def spatial_steps(kind: str, state_dict, batches, spatial: int,
                  augment: bool, remat: bool = False, lr: float = 0.1):
    """One SGD step of ``kind`` from ``state_dict`` on each global batch
    (image, mask) of ``batches``, each from the same weights, on a mesh
    of ``spatial`` slabs a row: the step's outputs and the state_dict
    after it."""
    out = []
    for image, mask in batches:
        state = _build(kind, state_dict, lr, remat)
        step = TE.make_train_step(state.model, 2, augment=augment,
                                  spatial=spatial)
        res = step(state, torch.from_numpy(image), torch.from_numpy(mask))
        out.append((_cpu(res), _cpu(state.model.state_dict())))
    return out


def run_cases(cases):
    """Each ``(function name, args)`` of ``cases`` in turn, on every rank
    in the same order (the spatial groups are made collectively): one
    launch for many cases."""
    funcs = {"halo": halo_case, "steps": spatial_steps,
             "fit": fit_and_resume}
    return [funcs[name](*args) for name, args in cases]
