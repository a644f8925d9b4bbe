"""Training the ResNet families and the PSPNet with the port
(``insarseg_torch/train/engine.py``) against the JAX package:

- the init: ``init_weights`` and ``build`` alike draw every backbone
  conv kaiming-normal with fan_out (the JAX package's
  ``insarseg/models/resnet.py:39-43``): each conv's sample std within
  5% of ``sqrt(2 / fan_out)``, its mean within 4 standard errors of 0;
  the heads' and SE blocks' convs keep
  torch's default uniform draw (|w| <= 1 / sqrt(fan_in)), as the JAX
  modules do; BN gamma 1, beta 0;
- ``ops/layers.py::MomentBatchNorm2d`` in train mode against the JAX
  package's ``BatchNorm2d`` at batch 1 (one value per channel) and at
  batch 3: outputs and running statistics within 1e-6 (f32); in eval
  mode equal to ``nn.BatchNorm2d``;
- train steps in float64 (in subprocesses: x64 must be set before JAX
  starts, as the float64 run of ``tests/test_train_parity.py`` does),
  32^2, dropout off on both sides, from the JAX tree filled with numpy
  draws and crossed with ``segmentation_variables_to_torch`` /
  ``pspnet_variables_to_torch``: DeepLabV3, FCN-CA and PSPNet-CA at
  batch 2 and PSPNet-CA at batch 1 (one value per channel in its 1x1 bin),
  3 steps each. Both packages build the pyramid pools' integral image in
  f32 whatever the input's dtype, each summing in its own order; in these
  runs both build it in f64 instead (the JAX package's
  ``adaptive_avg_pool_2d`` and the port's ``integral_image`` patched, the
  sums otherwise as written), so the f32 rounding cannot hide a fault in
  the head. Bars: every step's loss within 1e-8 and every running
  statistic within 1e-7 of the JAX step's (after the first step and after
  the last);
- a PSPNet-CA and a DeepLabV3 train step at batch 1 in f32 are finite
  (``nn.BatchNorm2d`` raised on their 1x1 pooled maps).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
# family -> (model, attention, batch, steps[, the Adam eps of both
# packages, default 1e-8]), all at 32^2
FAMILIES = {
    "deeplabv3": ("deeplabv3", "none", 2, 3),
    "fcn-ca": ("fcn", "channel", 2, 3),
    "pspnet-ca": ("pspnet", "channel", 2, 3),
    "pspnet-ca-b1": ("pspnet", "channel", 1, 3),
}
SIZE = 32
# (loss, running statistic) bars of the f64 steps
F64_BARS = (1e-8, 1e-7)


# ---------------------------------------------------------------------------
# the init (fault: torch's default uniform draw on the backbone convs)
# ---------------------------------------------------------------------------

def _check_init(model):
    """The backbone's 53 convs (the stem, 48 bottleneck convs, 4
    downsamples; not the SE blocks' MLP) kaiming-normal with fan_out,
    every other conv torch's uniform draw, BN gamma 1 and beta 0."""
    from insarseg_torch.models.resnet import KaimingConv2d

    kaiming = [m for m in model.backbone.modules()
               if isinstance(m, KaimingConv2d)]
    assert len(kaiming) == 53  # so no SE block's conv is among them
    for conv in kaiming:
        w = conv.weight.detach().double()
        fan_out = w.shape[0] * w.shape[2] * w.shape[3]
        want = (2.0 / fan_out) ** 0.5
        assert abs(float(w.std()) / want - 1) < 0.05, (conv, float(w.std()))
        assert abs(float(w.mean())) < 4 * want / w.numel() ** 0.5
    for mod_name, m in model.named_modules():
        if isinstance(m, nn.Conv2d) and not isinstance(m, KaimingConv2d):
            # U(-b, b), b = 1 / sqrt(fan_in) rounded to f32
            bound = float(torch.tensor(m.weight[0].numel() ** -0.5))
            assert float(m.weight.detach().abs().max()) <= bound, mod_name
        if isinstance(m, nn.BatchNorm2d):
            assert torch.all(m.weight == 1) and torch.all(m.bias == 0)


@pytest.mark.parametrize("name,attention", [("deeplabv3", "none"),
                                            ("fcn", "channel"),
                                            ("pspnet", "channel")])
def test_init_weights_draws_backbone_convs_kaiming_fan_out(name, attention):
    from insarseg_torch.models.registry import build
    from insarseg_torch.train.engine import init_weights

    model = init_weights(build(name, attention), seed=3)
    _check_init(model)
    # one seed, one draw
    again = init_weights(build(name, attention), seed=3)
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_built_model_draws_backbone_convs_kaiming_fan_out():
    """A model as ``build`` gives it, with no ``init_weights``, has the
    same distributions."""
    from insarseg_torch.models.registry import build

    torch.manual_seed(5)
    _check_init(build("fcn", "channel"))


# ---------------------------------------------------------------------------
# batch statistics at one value per channel (fault: nn.BatchNorm2d raised)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 5, 1, 1), (3, 5, 2, 3)])
def test_moment_batchnorm_matches_jax(shape):
    import jax
    import jax.numpy as jnp

    from insarseg.ops.layers import BatchNorm2d as JaxBN
    from insarseg_torch.ops.layers import MomentBatchNorm2d

    rng = np.random.default_rng(len(shape) + shape[0])
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, shape[1]).astype(np.float32)
    beta = rng.normal(0, 1, shape[1]).astype(np.float32)
    rmean = rng.normal(0, 1, shape[1]).astype(np.float32)
    rvar = rng.uniform(0.5, 2, shape[1]).astype(np.float32)

    bn = MomentBatchNorm2d(shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.running_mean.copy_(torch.from_numpy(rmean))
        bn.running_var.copy_(torch.from_numpy(rvar))
    got = bn.train()(torch.from_numpy(x)).detach().numpy()

    variables = {"params": {"scale": jnp.asarray(gamma),
                            "bias": jnp.asarray(beta)},
                 "batch_stats": {"mean": jnp.asarray(rmean),
                                 "var": jnp.asarray(rvar)}}
    want, upd = JaxBN(use_running_average=False).apply(
        variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
        mutable=["batch_stats"])
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    ref = nn.BatchNorm2d(shape[1])
    ref.load_state_dict(bn.state_dict())
    xt = torch.from_numpy(x)
    assert torch.equal(bn.eval()(xt), ref.eval()(xt))
    del jax


@pytest.mark.parametrize("name", ["pspnet", "deeplabv3"])
def test_train_step_at_batch_1_is_finite(name):
    from insarseg_torch.models.registry import build
    from insarseg_torch.train import engine as TE

    model = build(name, "channel")
    state = TE.create_state(model, seed=0, device=CPU)
    step = TE.make_train_step(model, 2)
    rng = np.random.default_rng(1)
    for _ in range(2):
        out = step(state, rng.uniform(-1, 1, (1, SIZE, SIZE, 1)).astype(
            np.float32), rng.integers(0, 2, (1, SIZE, SIZE)).astype(np.int32))
        assert torch.isfinite(out["loss"])
    assert all(torch.isfinite(p).all() for p in model.parameters())


# ---------------------------------------------------------------------------
# float64 train steps against the JAX package's (one subprocess)
# ---------------------------------------------------------------------------

def _f64_pools():
    """Both packages' pyramid pools from an f64 integral image, and the
    JAX PSPNet's dropout off (in a process of its own: patches modules)."""
    import types

    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_matmul_precision", "highest")
    import insarseg.models.pspnet as JP
    from insarseg_torch.ops import layers as TL

    # the JAX PSPNet's Dropout(0.1) has no rate field: dropout off through
    # the names its module reads
    names = {k: getattr(fnn, k) for k in dir(fnn) if not k.startswith("__")}
    names["Dropout"] = lambda rate, deterministic=True: (lambda y: y)
    JP.nn = types.SimpleNamespace(**names)
    jax_pool = JP.adaptive_avg_pool_2d

    def jax_pool_f64(x, output_size):
        real_jnp = jax_pool.__globals__["jnp"]
        names = {k: getattr(real_jnp, k) for k in dir(real_jnp)
                 if not k.startswith("__")}
        names["float32"] = jnp.float64
        jax_pool.__globals__["jnp"] = types.SimpleNamespace(**names)
        try:
            return jax_pool(x, output_size)
        finally:
            jax_pool.__globals__["jnp"] = real_jnp

    def integral_image_f64(x):
        ii = x.to(torch.float64).permute(0, 2, 3, 1).contiguous()
        return torch.nn.functional.pad(ii.cumsum(1).cumsum(2),
                                       (0, 0, 1, 0, 1, 0))

    JP.adaptive_avg_pool_2d = jax_pool_f64
    TL.integral_image = integral_image_f64


def family_cell(fam):
    """One family's float64 cell (after :func:`_f64_pools`, under
    JAX_ENABLE_X64): the JAX state and step, the port's model, state and
    step from the same weights, the two batches, ``to_torch`` (a JAX
    variables tree as the port's state_dict of numpy arrays) and
    ``stat_diff`` (the largest running-statistic distance now). A
    family's fifth field, where it has one, is the Adam eps of both
    packages (the JAX ``TrainState``'s ``tx``, the port's optimizer's
    ``param_groups``; else both packages' default, 1e-8)."""
    import types

    import jax
    import jax.numpy as jnp
    import optax

    import insarseg.models.pspnet as JP
    from insarseg.models.deeplab import DeepLabV3
    from insarseg.models.fcn import FCN
    from insarseg.train import engine as JE
    from insarseg_torch.compat import (
        pspnet_variables_to_torch,
        segmentation_variables_to_torch,
        state_dict_to_torch,
    )
    from insarseg_torch.models.registry import build
    from insarseg_torch.train import engine as TE

    name, attention, batch, steps = FAMILIES[fam][:4]
    eps = FAMILIES[fam][4] if len(FAMILIES[fam]) > 4 else 1e-8
    if name == "deeplabv3":
        jmodel = DeepLabV3(2, attention, dropout_rate=0.0)
    elif name == "fcn":
        jmodel = FCN(2, attention, dropout_rate=0.0)
    else:
        jmodel = JP.PSPNet(2, attention)
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((batch, SIZE, SIZE, 1)),
                rng.integers(0, 2, (batch, SIZE, SIZE)).astype(np.int32))
               for _ in range(2)]
    # the JAX tree's shapes, filled with numpy draws (an eager JAX init
    # of a ResNet-50 takes ~26 s here): LeCun-normal kernels, conv
    # biases and BN betas N(0, 0.1), BN gamma 1, statistics 0 and 1.
    # Not beta 0: at batch 1 an SE block's squeeze of its train-mode
    # BN's output is that BN's batch mean, beta, so at beta 0 its MLP's
    # ReLU sits at its kink with inputs of ~1e-17, whose signs each
    # package's summation order decides (the SE weights' gradients are
    # ~1e-17 in both; the bn3 betas' gradients then differ by up to
    # 60%, which Adam's first step turns into +-lr)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, SIZE, SIZE, 1)))

    def fill(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v)
                continue
            if k == "kernel":
                a = rng.normal(0, np.sqrt(1.0 / np.prod(v.shape[:-1])),
                               v.shape)
            elif k in ("scale", "var"):
                a = np.ones(v.shape)
            elif k == "bias":  # a conv bias, a BN beta
                a = rng.normal(0, 0.1, v.shape)
            else:  # a running mean
                a = np.zeros(v.shape)
            out[k] = jnp.asarray(a, jnp.float64)
        return out

    params, stats = fill(shapes["params"]), fill(shapes["batch_stats"])
    tx = optax.adam(LR, b1=0.9, b2=0.999, eps=eps)
    jstate = JE.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=tx.init(params),
                           tx=tx)
    jstep = JE.make_train_step(jmodel, 2)

    def to_torch(variables):
        if name == "pspnet":
            return pspnet_variables_to_torch(variables, attention)
        return segmentation_variables_to_torch(variables, name, attention)

    tmodel = build(name, attention).double()
    tmodel.load_state_dict(state_dict_to_torch(to_torch(
        {"params": params, "batch_stats": stats})), strict=True)
    for m in tmodel.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    tstate = TE.create_state(tmodel, LR, device=CPU)
    for group in tstate.optimizer.param_groups:
        group["eps"] = eps
    tstep = TE.make_train_step(tmodel, 2)
    cell = types.SimpleNamespace(jstate=jstate, jstep=jstep, tmodel=tmodel,
                                 tstate=tstate, tstep=tstep,
                                 batches=batches, steps=steps,
                                 to_torch=to_torch)

    def stat_diff():
        want = to_torch({"params": cell.jstate.params,
                         "batch_stats": cell.jstate.batch_stats})
        got = tmodel.state_dict()
        return max(float(np.abs(want[k] - got[k].numpy()).max())
                   for k in want if k.endswith(("running_mean",
                                                "running_var")))

    cell.stat_diff = stat_diff
    return cell


def step_both(cell, s):
    """Step ``s`` (from 0) of both packages on the cell's batches: (the
    JAX loss, the port's)."""
    import jax
    import jax.numpy as jnp

    x, m = cell.batches[s % 2]
    cell.jstate, jo = cell.jstep(cell.jstate, jnp.asarray(x),
                                 jnp.asarray(m), jax.random.key(100 + s))
    return float(jo["loss"]), float(cell.tstep(
        cell.tstate, torch.from_numpy(x), torch.from_numpy(m))["loss"])


def _run_families(families):
    """Runs in its own process with JAX_ENABLE_X64=1: per family, the JAX
    step and the port's step from the same weights on the same batches;
    prints one JSON line."""
    _f64_pools()
    torch.set_num_threads(1)
    out = {}
    for fam in families:
        cell = family_cell(fam)
        jl, tl, first = [], [], None
        for s in range(cell.steps):
            j, t = step_both(cell, s)
            jl.append(j)
            tl.append(t)
            if s == 0:
                first = cell.stat_diff()
        out[fam] = {"jax": jl, "torch": tl, "stat_diff_1": first,
                    "stat_diff": cell.stat_diff()}
    print("RESULT " + json.dumps(out))


@pytest.fixture(scope="module")
def x64_runs():
    """This file's ``__main__`` once per family, the four processes at
    once (the JAX step's compile, 20-50 s, is most of each), each on one
    thread."""
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    procs = {fam: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), fam], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for fam in FAMILIES}
    out = {}
    for fam, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        assert p.returncode == 0 and lines, stderr[-4000:]
        out.update(json.loads(lines[-1][len("RESULT "):]))
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_steps_match_jax_in_float64(x64_runs, family):
    res = x64_runs[family]
    jl, tl = np.asarray(res["jax"]), np.asarray(res["torch"])
    assert np.isfinite(tl).all()
    assert abs(jl[0] - tl[0]) < F64_BARS[0], (family, jl, tl)
    assert res["stat_diff_1"] < F64_BARS[1], (family, res["stat_diff_1"])
    assert np.abs(jl - tl).max() < F64_BARS[0], (family, jl, tl)
    assert res["stat_diff"] < F64_BARS[1], (family, res["stat_diff"])
    if len(jl) > 1:
        assert jl[-1] != jl[0], "did not train"


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _run_families(sys.argv[1:])
