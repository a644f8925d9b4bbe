"""Where DeepLabV3-SA's float64 train step leaves the JAX step's at Adam's
third step (``tests/test_torch_sa_train_steps.py``): a probe, not a test.

    JAX_ENABLE_X64=1 JAX_PLATFORMS=cpu PYTHONPATH=. \\
        python tests/sa_adam_probe.py [FAMILY] [NEAR]

FAMILY is a cell of ``tests/test_torch_sa_train_steps.py`` (default
``deeplabv3-sa``), run for 3 Adam steps at eps 1e-8 from
``tests/test_torch_train_resnet.py::family_cell`` (CPU, one thread; about
4 minutes). NEAR (default 1e3 x eps = 1e-5) marks a parameter element as
near zero where its first-step JAX gradient is smaller in magnitude.

After the first step each package's gradient is read from its Adam
state (the first moment over 1 - b1), and for every parameter the
probe prints its near-zero elements, the two gradients' largest distance
relative to the tensor's largest, and the largest distance of the two
packages' first updates among the near-zero elements and among the
others: Adam's first step moves an element by lr g / (|g| + eps), so
near zero an update moves by about lr / eps times a gradient's
difference. Then it runs the third step four ways, each from a fresh
cell, and prints the step-3 loss distance and the running statistics'
distance of each:

- ``as is``: both packages as they are;
- ``near``: after the first step the port's near-zero elements (values
  and both Adam moments) set to the JAX step's;
- ``rest``: the same for every other element;
- ``sa head``: the same for the whole spatial-attention head
  (``attention_module.*``, the parameters that K12a-K13b's plain
  versions give their gradients).

The distance comes from the near-zero elements if ``near`` removes it
and ``rest`` and ``sa head`` do not.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def first_step(cell):
    """The first step's per-parameter readings: {name: (g_jax, g_port,
    update_jax, update_port)} as numpy, the gradients from the Adam first
    moments (Adam's mu / (1 - b1), exact to a rounding)."""
    mu = cell.jstate.opt_state[0].mu
    stats = cell.jstate.batch_stats
    gj = cell.to_torch({"params": mu, "batch_stats": stats})
    pj = cell.to_torch({"params": cell.jstate.params, "batch_stats": stats})
    opt = cell.tstate.optimizer
    out = {}
    for name, p in cell.tmodel.named_parameters():
        st = opt.state.get(p)
        if not st:  # no gradient in the port (a BN-fed conv's bias)
            continue
        out[name] = (gj[name] / 0.1, st["exp_avg"].numpy() / 0.1,
                     pj[name], p.detach().numpy().copy())
    return out


def transplant(cell, which, near):
    """The port's elements ``which`` (a function of (name, the near-zero
    mask) giving a mask) set to the JAX step's: values, first and second
    moments."""
    st = cell.jstate
    stats = st.batch_stats
    jp = cell.to_torch({"params": st.params, "batch_stats": stats})
    mu = cell.to_torch({"params": st.opt_state[0].mu,
                        "batch_stats": stats})
    nu = cell.to_torch({"params": st.opt_state[0].nu,
                        "batch_stats": stats})
    opt = cell.tstate.optimizer
    with torch.no_grad():
        for name, p in cell.tmodel.named_parameters():
            s = opt.state.get(p)
            if not s:
                continue
            mask = torch.from_numpy(which(name, np.abs(mu[name] / 0.1)
                                          < near))
            p[mask] = torch.from_numpy(jp[name])[mask]
            s["exp_avg"][mask] = torch.from_numpy(mu[name])[mask]
            s["exp_avg_sq"][mask] = torch.from_numpy(nu[name])[mask]


def run(TR, fam, near, which=None, report=False):
    cell = TR.family_cell(fam)
    losses = [TR.step_both(cell, 0)]
    if report:
        readings = first_step(cell)
        print(f"first step of {fam}, elements with |g| < {near:g}:")
        for name, (gj, gt, uj, ut) in readings.items():
            mask = np.abs(gj) < near
            big = max(float(np.abs(gj).max()), 1e-300)
            du = np.abs(ut - uj)
            if mask.any():
                print(f"  {name}: {int(mask.sum())} of {gj.size} near zero; "
                      f"gradients {float(np.abs(gt - gj).max()) / big:.2g} "
                      f"of the largest |g| {big:.3g} apart; the updates "
                      f"{float(du[mask].max()):.3g} apart near zero, "
                      f"{float(du[~mask].max()) if (~mask).any() else 0:.3g}"
                      " elsewhere")
        sa = [k for k in readings if k.startswith("attention_module")]
        for k in sa:
            gj, gt = readings[k][:2]
            print(f"  SA head {k}: gradients "
                  f"{float(np.abs(gt - gj).max() / np.abs(gj).max()):.2g} "
                  "of the largest apart")
    if which is not None:
        transplant(cell, which, near)
    for s in range(1, 3):
        losses.append(TR.step_both(cell, s))
    return {"loss": [abs(j - t) for j, t in losses],
            "stat_diff": cell.stat_diff()}


def main(argv):
    sys.path.insert(0, ROOT)
    from tests import test_torch_train_resnet as TR
    from tests.test_torch_sa_train_steps import FAMILIES

    fam = argv[0] if argv else "deeplabv3-sa"
    near = float(argv[1]) if len(argv) > 1 else 1e-5
    TR.FAMILIES.update(FAMILIES)
    TR.FAMILIES[fam] = TR.FAMILIES[fam][:3] + (3,)
    TR._f64_pools()
    torch.set_num_threads(1)
    ways = {
        "as is": None,
        "near": lambda name, m: m,
        "rest": lambda name, m: ~m,
        "sa head": lambda name, m: np.full(
            m.shape, name.startswith("attention_module")),
    }
    res = {}
    for k, which in ways.items():
        res[k] = run(TR, fam, near, which, report=k == "as is")
        print(f"{k}: loss distance by step "
              + ", ".join(f"{d:.3g}" for d in res[k]["loss"])
              + f"; statistics {res[k]['stat_diff']:.3g}", flush=True)
    print("RESULT " + json.dumps({fam: res}))


if __name__ == "__main__":
    main(sys.argv[1:])
