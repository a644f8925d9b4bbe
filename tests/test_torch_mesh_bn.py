"""The port's synced BatchNorm (``ops/layers.py::MomentBatchNorm2d`` with
``synced``, made by ``parallel/mesh.py::sync_batchnorm``) on 2 gloo ranks
(``insarseg_torch.parallel.launch``, one torch thread each) against one
process on the global batch: the output rows, the input gradient rows,
the weight and bias gradients (summed over the ranks) and the running
statistics, within 1e-12 in float64 and 1e-5 in float32 (two summation
orders), on an even split (b4), an uneven one (b5: 3 + 2 rows) and a 1x1
map at one sample a rank (the PSPNet bin case: a rank's own moments
would have variance 0 and give the bias); plus the converter in one
process. The one exception to the f32 bar: the input gradient of the 1x1
case, two values a channel, whose ``E[x^2] - E[x]^2`` variance leaves
f32 a few significant digits whatever the summation order (it measured
1.5e-5 of a largest 0.044 here), is held within 1e-3 of its largest
value; in f64 the same case holds at 1e-12.

The DoubleConv's fused train epilogue (``kernels/bn_act.py::
bn_relu_train`` with ``MomentBatchNorm2d.ranks_sum``, the bias added
inside, the ReLU after) runs on the same 2 ranks in the same launch and
is held to the synced ``MomentBatchNorm2d`` then ReLU on ``x + bias``,
rank by rank, and its rows to one process's fused epilogue over the
global batch, at the same bars (the 1x1 f32 input gradient's exception
too: there the module's autograd is the imprecise side)."""

import pytest
import torch
from torch import nn

from insarseg_torch.ops.layers import MomentBatchNorm2d
from insarseg_torch.parallel import launch, sync_batchnorm
from tests import torch_mesh_ranks as R

SHAPES = {"b4-even": (4, 3, 5, 5), "b5-uneven": (5, 3, 4, 4),
          "b2-1x1": (2, 6, 1, 1)}
DTYPES = {"f64": (torch.float64, 1e-12), "f32": (torch.float32, 1e-5)}
KEYS = ("y", "gx", "gw", "gb", "rm", "rv")


def _case(shape, dtype, moment):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 2 + 1
    gy = torch.randn(shape, generator=g, dtype=torch.float64)
    return x, gy, dtype, moment


CASES = [(s, d, m) for s in SHAPES for d in DTYPES
         for m in (False, True, "fused")]


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    cases = [_case(SHAPES[s], DTYPES[d][0], m) for s, d, m in CASES]
    ranks = launch(R.bn_cases, 2, ["cpu", "cpu"], args=(cases,))
    return {c: ([r[i] for r in ranks], R.bn_cases([cases[i]])[0])
            for i, c in enumerate(CASES)}


def _bar(shape, dtype, key, want):
    if (shape, dtype, key) == ("b2-1x1", "f32", "gx"):
        return 1e-3 * float(want.abs().max())
    return DTYPES[dtype][1]


@pytest.mark.parametrize("moment", [False, True],
                         ids=["BatchNorm2d", "MomentBatchNorm2d"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_two_ranks_equal_the_global_batch(runs, shape, dtype, moment):
    ranks, want = runs[(shape, dtype, moment)]
    tol = DTYPES[dtype][1]
    got = {k: torch.cat([r[k] for r in ranks]) for k in ("y", "gx")}
    for k in KEYS:
        bar = _bar(shape, dtype, k, want[k])
        for i, r in enumerate(ranks):
            g = got[k] if k in got else r[k]
            assert g.dtype == want[k].dtype, k
            torch.testing.assert_close(g, want[k], rtol=0, atol=bar,
                                       msg=f"{k} (rank {i})")
    if shape == "b2-1x1":
        # a rank alone holds one value a channel, whose moments would give
        # the bias; the global batch holds two
        bias = torch.linspace(-0.2, 0.2, 6, dtype=want["y"].dtype)
        assert (got["y"][:, :, 0, 0] - bias).abs().min() > 0.1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_epilogue_on_two_ranks_equals_the_synced_batchnorm(
        runs, shape, dtype):
    ranks, alone = runs[(shape, dtype, "fused")]
    got = {k: torch.cat([r["fused"][k] for r in ranks]) for k in ("y", "gx")}
    for k in KEYS:
        for i, r in enumerate(ranks):
            want = r["moment"][k]
            assert r["fused"][k].dtype == want.dtype, k
            torch.testing.assert_close(
                r["fused"][k], want, rtol=0,
                atol=_bar(shape, dtype, k, want), msg=f"{k} (rank {i})")
            g = got[k] if k in got else r["fused"][k]
            torch.testing.assert_close(
                g, alone["fused"][k], rtol=0,
                atol=_bar(shape, dtype, k, alone["fused"][k]),
                msg=f"{k} (rank {i}) against one process")


def test_sync_batchnorm_keeps_parameters_and_names():
    """The swap keeps every parameter and buffer object (an optimizer made
    before keeps working) and the state_dict names; it reaches nested
    modules and ``MomentBatchNorm2d``; without a group the synced layer is
    ``MomentBatchNorm2d``, and in eval mode ``nn.BatchNorm2d``."""
    torch.manual_seed(0)
    model = nn.Sequential(nn.Conv2d(1, 4, 3), nn.BatchNorm2d(4),
                          nn.Sequential(nn.ReLU(), MomentBatchNorm2d(4)))
    model[1].running_var.fill_(2.0)
    params = {k: p for k, p in model.named_parameters()}
    bufs = {k: b for k, b in model.named_buffers()}
    names = list(model.state_dict())
    ref = MomentBatchNorm2d(4)
    ref.load_state_dict(model[1].state_dict())
    assert sync_batchnorm(model) is model
    for bn in (model[1], model[2][1]):
        assert isinstance(bn, MomentBatchNorm2d) and bn.synced
    assert not MomentBatchNorm2d(4).synced
    assert list(model.state_dict()) == names
    for k, p in model.named_parameters():
        assert p is params[k], k
    for k, b in model.named_buffers():
        assert b is bufs[k], k
    x = torch.randn(3, 4, 5, 5)
    assert torch.equal(model[1](x), ref(x))
    assert torch.equal(model[1].running_var, ref.running_var)
    model.eval()
    ref.eval()
    assert torch.equal(model[1](x), nn.BatchNorm2d.forward(ref, x))
    with pytest.raises(ValueError, match="momentum"):
        sync_batchnorm(nn.Sequential(nn.BatchNorm2d(4, momentum=None)))
