"""The port's serving mesh (``insarseg_torch/parallel/mesh.py``, the
``mesh=`` of ``engines.py`` and ``parallel/inference.py``) against the JAX
package's, in one process: four CPU replicas of the port against the JAX
package's engines on ``make_mesh(data=4)`` (the 8 virtual CPU devices of
``tests/conftest.py``), on the same weights and batch.

- ``make_mesh`` / ``shard_batch`` / ``replicate`` / ``replicate_arrays``
  with the JAX helpers' semantics: the ``data=-1`` arithmetic, the checks,
  Python scalars kept; a ``spatial`` axis gives the JAX helper's shape
  (``tests/test_torch_spatial.py`` runs it), and a ResNet family under it
  raises naming ROADMAP item 21c where a slab is not a multiple of 8
  rows;
  the CLI's ``_eval_mesh`` picks the JAX CLI's data axis (the cases of
  ``tests/test_engines_mesh.py:198-210``);
- U-Net-CA (base 16, 32^2, global b8) on the module, serve and int8
  engines and FCN-ResNet50-CA on int8, at the bars of
  ``tests/test_torch_engines.py`` / ``tests/test_torch_resnet_engines.py``:
  module and serve within 1e-4, U-Net int8 within the jitted-engine bar
  (1.5e-2 x max|logit|, argmax >= 99.5%), the port's packed codes equal
  to the JAX package's; the port's 4-replica int8 engine bit-equal to
  its one-device engine (batches of 7 and 3 too), its module and serve
  engines within 1e-5 x max|logit|; FCN-CA's int8 meshes differ as the
  one-device engines do, and the one-device difference is traced to the
  two packages' calibration scales (the port serving the JAX package's
  tree equals its op-by-op backbone code for code; a counted bar on its
  own tree);
- ``evaluate`` over a 4-replica engine equals it over one device.
The weights are drawn in the port (``init_weights``, numpy BN statistics)
and read into the JAX package with its importers (no eager JAX init)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.compat.torch_io import unet_variables_from_torch
from insarseg.engines import engine_from_artifact as jax_from_artifact
from insarseg.engines import make_engine as jax_make_engine
from insarseg.engines import pack_engine as jax_pack_engine
from insarseg.models.unet import UNet as JaxUNet
from insarseg.parallel import make_mesh as jax_make_mesh
from insarseg.parallel import shard_batch as jax_shard_batch
from insarseg_torch.engines import (
    engine_from_artifact,
    make_engine,
    pack_engine,
)
from insarseg_torch.models.unet import UNet
from insarseg_torch.parallel import (
    Mesh,
    make_mesh,
    replicate,
    replicate_arrays,
    shard_batch,
)
from insarseg_torch.train import engine as TE
from insarseg_torch.train.engine import init_weights
from tests.test_torch_common import (
    CPU,
    assert_packed_equal,
    make_resnet_pair,
    smooth,
)

CPUS = ["cpu"] * 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_make_mesh_follows_the_jax_helper():
    assert make_mesh(devices=CPUS).shape == {"data": 4, "spatial": 1}
    assert make_mesh(2, devices=CPUS).shape == \
        dict(jax_make_mesh(data=2).shape)
    assert make_mesh(-1, devices=["cpu"] * 8).shape == \
        dict(jax_make_mesh(data=-1).shape)
    assert make_mesh(3, devices=["cpu", "cpu", "cpu", "cpu"]).devices == \
        (CPU,) * 3
    with pytest.raises(AssertionError):
        jax_make_mesh(data=9)
    with pytest.raises(ValueError, match="needs 9 devices"):
        make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh(0, devices=CPUS)
    # the spatial axis: the JAX helper's shapes; a ResNet family runs on
    # it (item 21b), its slabs a multiple of 8 rows, else a ValueError
    # naming item 21c
    assert make_mesh(2, spatial=2, devices=CPUS).shape == \
        dict(jax_make_mesh(data=2, spatial=2).shape)
    assert make_mesh(-1, spatial=4, devices=["cpu"] * 8).shape == \
        dict(jax_make_mesh(data=-1, spatial=4).shape)
    from insarseg_torch.models.registry import check_spatial

    check_spatial("deeplabv3")
    from insarseg_torch.models.registry import build
    from insarseg_torch.parallel import make_predict_fn

    with pytest.raises(ValueError, match="multiple of 8.*item 21c"):
        make_predict_fn(build("deeplabv3"), mesh=make_mesh(
            1, spatial=2, devices=["cpu", "cpu"]))(torch.zeros(1, 20, 16, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()  # the default devices are the cards: none here
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda", "cuda"])


def test_shard_batch_and_replicate_follow_the_jax_helpers():
    mesh = make_mesh(devices=CPUS)
    image = np.arange(8 * 2 * 2 * 1, dtype=np.float32).reshape(8, 2, 2, 1)
    mask = np.arange(8 * 2 * 2, dtype=np.int32).reshape(8, 2, 2)
    batch = {"image": image, "mask": mask, "n_valid": 8}
    ours = shard_batch(batch, mesh)
    theirs = jax_shard_batch(batch, jax_make_mesh(data=4))
    assert ours["n_valid"] == theirs["n_valid"] == 8
    for k in ("image", "mask"):
        shards = sorted(theirs[k].addressable_shards,
                        key=lambda s: s.index[0].start)
        assert len(ours[k]) == len(shards) == 4
        for a, s in zip(ours[k], shards):
            np.testing.assert_array_equal(a.numpy(), np.asarray(s.data))
    odd = shard_batch({"image": image[:7]}, mesh)["image"]
    assert [len(p) for p in odd] == [2, 2, 2, 1]
    tree = {"k": np.ones((2, 2), np.float32), "s": 0.5, "s2d": True,
            "none": None, "n": 3, "t": torch.zeros(2)}
    for copy in replicate_arrays(tree, mesh):
        assert isinstance(copy["k"], torch.Tensor)
        assert (copy["s"], copy["s2d"], copy["none"], copy["n"]) == \
            (0.5, True, None, 3)
    copies = replicate(tree, mesh)
    assert len(copies) == 4
    assert isinstance(copies[0]["s"], torch.Tensor) and copies[0]["none"] \
        is None
    model = torch.nn.Linear(2, 2)
    mods = replicate(model, mesh)
    assert all(m is not model for m in mods)
    assert torch.equal(mods[1].weight, model.weight)


@pytest.mark.parametrize("batch,data", [(4, 4), (16, 8), (3, 3), (1, None)])
def test_cli_eval_mesh_divides_the_batch(batch, data):
    from insarseg.cli import _eval_mesh as jax_eval_mesh
    from insarseg.config import get_preset as jax_preset
    from insarseg_torch.cli import _eval_mesh
    from insarseg_torch.config import get_preset

    mesh = _eval_mesh(get_preset("unet", batch_size=batch), ["cpu"] * 8)
    want = jax_eval_mesh(jax_preset("unet", batch_size=batch))
    if data is None:
        assert mesh is None and want is None
    else:
        assert mesh.shape == dict(want.shape) == {"data": data, "spatial": 1}


# ---------------------------------------------------------------------------
# the engines over the mesh
# ---------------------------------------------------------------------------

def _random_bn(model, seed):
    """Non-trivial BN statistics and affines (var > 0), drawn with numpy,
    so the serve and int8 engines' BN folding is no identity."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                for t, a in ((m.weight, rng.uniform(0.5, 1.5, c)),
                             (m.bias, rng.normal(0, 0.1, c)),
                             (m.running_mean, rng.normal(0, 0.1, c)),
                             (m.running_var, rng.uniform(0.5, 1.5, c))):
                    t.copy_(torch.from_numpy(a.astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def unet():
    tm = _random_bn(init_weights(UNet(num_classes=2, base_features=16,
                                      use_se=True), seed=11), 12).eval()
    v = unet_variables_from_torch(
        {k: t.numpy() for k, t in tm.state_dict().items()}, use_se=True)
    rng = np.random.default_rng(13)
    return tm, v, smooth(rng, (8, 32, 32, 1)), smooth(rng, (8, 32, 32, 1))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _agree(got, want):
    return np.mean(np.asarray(got, np.float32).argmax(-1)
                   == np.asarray(want, np.float32).argmax(-1))


@pytest.mark.parametrize("engine", ["module", "serve", "int8"])
def test_unet_ca_4_replicas_match_the_jax_mesh(unet, engine):
    tm, v, calib, x = unet
    kw = {"calib_batches": [calib]} if engine == "int8" else {}
    mesh = make_mesh(devices=CPUS)
    jm = JaxUNet(num_classes=2, base_features=16, use_se=True)
    if engine == "module":
        ours = make_engine("unet", "channel", tm, None, engine, mesh=mesh)
        one = make_engine("unet", "channel", tm, None, engine, device=CPU)
        theirs = jax_make_engine("unet", "channel", jm, v, engine,
                                 mesh=jax_make_mesh(data=4))
    else:  # packed (and calibrated) once a package, served both ways
        art = pack_engine("unet", "channel", tm, None, engine, device=CPU,
                          **kw)
        ours = engine_from_artifact(art, mesh=mesh)
        one = engine_from_artifact(art, device=CPU)
        jart = jax_pack_engine("unet", "channel", jm, v, engine, **kw)
        assert_packed_equal(art["tree"], jart["tree"])
        theirs = jax_from_artifact(jart, mesh=jax_make_mesh(data=4))
    got = ours(x).float().numpy()
    want = np.asarray(theirs(jnp.asarray(x)), np.float32)
    alone = one(x).float().numpy()
    if engine == "int8":
        rel, agree = _rel(got, want), _agree(got, want)
        print(f"U-Net-CA int8, 4 port replicas vs the JAX mesh: max rel "
              f"err {rel:.4g}, argmax {agree:.5f}")
        assert rel <= 1.5e-2 and agree >= 0.995
        np.testing.assert_array_equal(got, alone)
        for n in (7, 3):  # uneven shards; at 3 tiles a replica holds none
            np.testing.assert_array_equal(ours(x[:n]).float().numpy(),
                                          alone[:n])
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert _rel(got, alone) <= 1e-5
    argmaxed = (make_engine("unet", "channel", tm, None, engine, mesh=mesh,
                            argmax=True) if engine == "module" else
                engine_from_artifact(art, mesh=mesh, argmax=True))(x)
    assert argmaxed.dtype == torch.int32 and argmaxed.shape == (8, 32, 32)
    np.testing.assert_array_equal(argmaxed.numpy(), got.argmax(-1))


def test_packed_trees_are_copied_to_every_device(unet):
    tm, _, calib, _ = unet
    tree = pack_engine("unet", "channel", tm, None, "int8",
                       calib_batches=[calib], device=CPU)["tree"]
    copies = replicate_arrays(tree, make_mesh(devices=CPUS))
    assert len(copies) == 4
    for c in copies:
        assert c["s2d"] is tree["s2d"] and c["in_s"] == tree["in_s"]
        q = c["inc"]["c1"]["q"]
        assert isinstance(q, torch.Tensor)
        np.testing.assert_array_equal(q.numpy(),
                                      np.asarray(tree["inc"]["c1"]["q"]))


@pytest.fixture(scope="module")
def fcn_ca():
    """FCN-CA (full ResNet-50 widths) packed int8 by both packages on the
    same weights and calibration batch, and the served batch."""
    jm, v, tm = make_resnet_pair("fcn", "channel")
    rng = np.random.default_rng(14)
    calib, x = smooth(rng, (4, 32, 32, 1)), smooth(rng, (8, 32, 32, 1))
    art = pack_engine("fcn", "channel", tm, None, "int8", device=CPU,
                      calib_batches=[calib])
    jart = jax_pack_engine("fcn", "channel", jm, v, "int8",
                           calib_batches=[calib])
    return art, jart, x


def test_fcn_ca_int8_4_replicas_match_the_jax_mesh(fcn_ca):
    """FCN-CA int8 over 4 replicas against the JAX package's mesh engine:
    the packed codes equal, the port's mesh equal to its one device bit
    for bit (the JAX package's mesh is its jitted one-device engine,
    ``tests/test_engines_mesh.py``), so the two meshes differ exactly as
    the one-device engines do, and the argmax agrees >= 99.5%. That
    one-device difference, 0.0407 x max|logit| on these inputs (1.7% of
    the logits beyond 2e-2), above the 3e-2 that
    ``tests/test_torch_resnet_engines.py`` pins on its own inputs, comes
    from the calibration scales (the next test)."""
    art, jart, x = fcn_ca
    got = engine_from_artifact(art, mesh=make_mesh(devices=CPUS))(x) \
        .float().numpy()
    alone = engine_from_artifact(art, device=CPU)(x).float().numpy()
    np.testing.assert_array_equal(got, alone)
    assert_packed_equal(art["tree"], jart["tree"])
    want = np.asarray(jax_from_artifact(jart, mesh=jax_make_mesh(data=4))(
        jnp.asarray(x)), np.float32)
    rel, agree = _rel(got, want), _agree(got, want)
    print(f"FCN-CA int8, 4 port replicas vs the JAX mesh: max rel err "
          f"{rel:.4g}, argmax {agree:.5f}")
    assert rel == _rel(alone, want) and agree >= 0.995


# FCN-CA int8 on these inputs, the port against the JAX package's op-by-op
# ``resnet_int8_apply``: the two packages' activation scales (largest
# relative difference; reading 5.74e-7 with torch on one thread as here,
# 7.53e-7 on four), the port's logits on the JAX
# package's own tree (x max|logit|; reading 7.75e-3, argmax 1.0), and on
# its own tree the codes that differ (count, largest |delta|) at the first
# bottleneck's exit that differs, layer2_0 (reading 1 code of 65,536,
# |delta| 1), and at the backbone's (readings 25,679 of 262,144 with torch
# on one thread as here, 17,006 on four; |delta| <= 5)
FCN_SCALE_BAR = 1e-6
FCN_SAME_TREE_BAR = 1e-2
FCN_FIRST_CODES = (4, 1)
FCN_EXIT_CODES = (40_000, 8)


def _jax_exits(tree, x):
    """The JAX package's op-by-op int8 backbone: each bottleneck's exit
    codes (numpy)."""
    from insarseg.models import resnet_int8 as J
    from insarseg.models.resnet_serve import _ca
    from insarseg.ops.layers import max_pool_2d
    from insarseg.ops.quant import requant

    y = _ca(jnp.asarray(x).astype(jnp.bfloat16), tree["stem"], stride=2)
    yq = requant(max_pool_2d(y, 3, stride=2, padding=1).astype(jnp.float32),
                 tree["stem_out_s"])
    exits = {}
    for name in J._block_chain(tree):
        yq = J._block_i8(tree[name], yq)
        exits[name] = np.asarray(yq)
    return exits


def _port_exits(tree, x):
    """The port's int8 backbone over a ``prepare_resnet_int8`` tree."""
    from insarseg_torch.models import resnet_int8 as P
    from insarseg_torch.ops.layers import nhwc_to_nchw

    y = P._ca(nhwc_to_nchw(torch.from_numpy(x).to(torch.bfloat16)),
              tree["stem"], 2)
    yq = P.stem_pool_i8(y, tree["stem_out_s"])
    exits = {}
    for name in P.block_chain(tree):
        yq = P._block_i8(tree[name], yq)
        exits[name] = yq.numpy()
    return exits


def test_fcn_ca_int8_parts_from_jax_at_the_calibration_scales(fcn_ca):
    """Where the FCN-CA int8 engine parts from the JAX package's op-by-op
    apply on these inputs (ROADMAP Queue 3, "Not a fault"): the packed
    codes are equal, but the activation scales come from two f32
    calibration replays of the folded graph (torch's and XLA's conv sums),
    within ``FCN_SCALE_BAR``. Served the JAX package's tree, the port
    equals JAX op by op at every bottleneck's exit, code for code (its f64
    SE gate included), and its logits lie within ``FCN_SAME_TREE_BAR``
    (the bf16 head and classifier) with the same argmax. On its own tree
    the first code that differs is the requant of layer2_0's conv3 to the
    SE pre-scale (a quotient a float ulp from .5 under the other scale),
    within the counted bar ``FCN_FIRST_CODES``; the later blocks spread it
    (``FCN_EXIT_CODES`` at the backbone's exit), and the upsampled logits
    carry it to 0.0407 x max|logit|."""
    from insarseg.models.resnet_int8 import resnet_int8_apply as jax_apply
    from insarseg_torch.models.resnet_int8 import (
        prepare_resnet_int8,
        resnet_int8_apply,
    )
    from tests.test_torch_common import flat

    art, jart, x = fcn_ca
    ours, ref = dict(flat(art["tree"])), dict(flat(jart["tree"]))
    scales = [abs(ours[k] - r) / abs(r) for k, r in ref.items()
              if isinstance(r, float) and r]
    assert 0 < max(scales) <= FCN_SCALE_BAR
    jtree = jart["tree"]
    same = prepare_resnet_int8(_to_numpy(jart["tree"]), CPU)
    own = prepare_resnet_int8(art["tree"], CPU)
    want = _jax_exits(jtree, x)
    on_jax_tree = _port_exits(same, x)
    for name, codes in want.items():
        np.testing.assert_array_equal(on_jax_tree[name], codes,
                                      err_msg=name)
    logits = resnet_int8_apply(same, torch.from_numpy(x)).float().numpy()
    ref_logits = np.asarray(jax_apply(jtree, jnp.asarray(x)), np.float32)
    assert _rel(logits, ref_logits) <= FCN_SAME_TREE_BAR
    assert _agree(logits, ref_logits) == 1.0
    on_own_tree = _port_exits(own, x)
    differ = [n for n in want if (on_own_tree[n] != want[n]).any()]
    assert differ[0] == "layer2_0", differ
    for name, (most, dmax) in (("layer2_0", FCN_FIRST_CODES),
                               (list(want)[-1], FCN_EXIT_CODES)):
        delta = np.abs(on_own_tree[name].astype(int)
                       - want[name].astype(int))
        print(f"FCN-CA int8 on its own tree, {name}: "
              f"{int((delta > 0).sum())} of {delta.size} codes differ from "
              f"JAX, |delta| <= {int(delta.max())}; scales "
              f"{max(scales):.3g} apart")
        assert int((delta > 0).sum()) <= most and int(delta.max()) <= dmax


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree) if hasattr(tree, "shape") else tree


@pytest.mark.parametrize("engine", ["serve", "int8"])
def test_evaluate_over_4_replicas_equals_one_device(unet, engine):
    tm, _, calib, x = unet
    kw = {"calib_batches": [calib]} if engine == "int8" else {}
    mask = np.random.default_rng(15).integers(0, 2, (8, 32, 32)) \
        .astype(np.int32)
    loader = [{"image": x, "mask": mask, "n_valid": 8}]
    res = {}
    for name, where in (("one", {"device": CPU}),
                        ("mesh", {"mesh": make_mesh(devices=CPUS)})):
        predict = make_engine("unet", "channel", tm, None, engine, **kw,
                              **where)
        res[name] = TE.evaluate(TE.make_engine_eval_step(predict, 2,
                                                         device=CPU),
                                loader, verbose=False)
    for k, want in res["one"].items():
        if engine == "int8":
            assert res["mesh"][k] == want, k
        else:
            assert res["mesh"][k] == pytest.approx(want, rel=1e-5), k


def test_a_mesh_must_be_a_mesh(unet):
    tm = unet[0]
    with pytest.raises(TypeError, match="Mesh"):
        make_engine("unet", "channel", tm, None, "serve",
                    mesh=jax_make_mesh(data=2))
    assert isinstance(make_mesh(devices=CPUS), Mesh)
