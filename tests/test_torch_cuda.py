"""The int8 kernels K1-K7 on the card against their plain
versions, at small and ragged shapes (partial channel chunks, tiles cut by
the image border, output channels that are not a multiple of the kernel's
tile, dilations larger than the map, odd widths, pixel counts that are not
a multiple of a block). K1 and K5a are tensor-core implicit GEMMs; their
cases also cover the GEMM's own edges: pixel rows that do not fill the
last 128-row tile and tiles that straddle two images, Cout under or
between the 64 / 128 N tiles, Cin whose 16-padded width leaves a partial
64-byte K chunk, the Cin 1 / 2 input conv, and the largest accumulator
(Cin 2048, 3x3, every code +-127). K2's squeeze runs at C 16 / 2048 / 4096,
B 1 / 8 / 9 and 512^2 codes all +127 or -128; K5b on quotients at the
ties; K6 in both forms at Cin 1024 / 128 / 40 / 72 / 200, b1 and b8,
up1 at full width, odd pixel counts, tiles across taps (Cout 48 / 64 /
80), codes at +-127 and quotients at the ties; K7 on NCHW and
channels-last input, odd H and W, W not a multiple of 8 or 16, three
column spans, b1, partial channel groups. Outputs must be exactly equal,
except K6's, which sums on the tensor cores in its own order and is held
by a counted bar (``kernels.assert_up_codes_close``). A warm int8 forward
of each engine family must not synchronise the stream. The DoubleConv
train epilogue K8a-K9b (``kernels/bn_act.py``) at NCHW and channels-last,
C 1 / 3 / 64, a 1x1 map and an odd H*W, bf16 and f32: K8a's and K9a's
f64 sums within 1e-10 of their largest value (another order), K8b and K9b
on the same buffers equal to their plain versions, every kernel equal
to itself on a second run; K8a and K9a at the U-Net's five levels
(batch 2, bf16 channels-last and f32 NCHW) bit-equal over ten calls
queued back to back, on a second stream and with dout in the other
layout; a train-mode ``DoubleConv`` on the card
launches all four and never a plain version. The SE tail's K10a-K11b
(``kernels/se_train.py``) in both modes, bf16 / f32 / f64, NCHW and
channels-last, 1x1 and empty maps, channel counts that take no vectors
and reductions of several slices: the f64 sums within 1e-12 of their
largest value, K10b and K11b equal to their plain versions, K11a equal
to itself on a second run; the train-mode ``DoubleConv(use_se=True)``
launches each once and never a plain version; in the cbam mode, on
the same shapes with ties planted in the max over H and W
(``chip_smoke.py::se_inputs``), K10a's max and count equal to the plain
version's and the sums within 1e-12, the other three at
``chip_smoke.py``'s bars, and the train-mode ``ChannelAttentionModule``
launches each once and never a plain version. The spatial-attention
gate's K12a-K13b (``kernels/sa_train.py``) in bf16 / f32 / f64, NCHW and
channels-last, C 1 / 7 / 64 / 2048, 1x1 and empty maps, ties in the
channel max, at ``chip_smoke.py``'s bars (the mean and K13a's sums from
f64 sums, the max and its count equal, K12b and K13b equal to their plain
versions, every kernel equal to itself on a second run, an empty map
launching nothing); the train-mode ``SpatialAttentionConv`` and
``SpatialAttentionDC`` launch each once and never a plain version.

Needs an NVIDIA GPU and nvcc; skips without a card. Imports nothing of
JAX, so it runs where only the port is installed:
``python -m pytest tests/test_torch_cuda.py -q --noconftest``."""

import numpy as np
import pytest
import torch

from insarseg_torch import kernels as K
from insarseg_torch.ops.quant import quant_weight

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    K.load_library()
    return torch.device("cuda")


def _conv_args(gen, b, h, w, cin, cout, bf16_exit, dev):
    q = torch.from_numpy(quant_weight(np.random.default_rng(cin + cout)
                                      .normal(0, 1, (3, 3, cin, cout)))["q"])
    x = torch.randint(-127, 128, (b, h, w, cin), generator=gen,
                      dtype=torch.int8)
    acc_sd = 127.0 * 127.0 * np.sqrt(9 * cin) / 3
    mult = (torch.rand(cout, generator=gen) + 0.5) * (60 / acc_sd)
    off = torch.randn(cout, generator=gen) * 10
    return (x.to(dev), K.repack_conv_weight(q).to(dev), mult.to(dev),
            off.to(dev), None if bf16_exit else 0.75)


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 32, 32, 1, 64), (1, 20, 36, 40, 64), (2, 16, 48, 64, 40),
    (1, 17, 9, 96, 128), (1, 8, 8, 256, 16),
])
@pytest.mark.parametrize("bf16_exit", [False, True])
def test_k1_equals_plain(dev, b, h, w, cin, cout, bf16_exit):
    gen = torch.Generator().manual_seed(h * w + cin)
    args = _conv_args(gen, b, h, w, cin, cout, bf16_exit, dev)
    before = K.LAUNCHES["int8_conv3x3_epilogue"]
    got = K.conv3x3_i8(*args)
    assert K.LAUNCHES["int8_conv3x3_epilogue"] == before + 1
    want = K.conv3x3_i8_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("b,h,w,c", [(2, 16, 16, 64), (3, 7, 5, 48),
                                     (1, 4, 4, 1024)])
@pytest.mark.parametrize("gain_dtype", [torch.float32, torch.bfloat16])
def test_k2_equals_plain(dev, b, h, w, c, gain_dtype):
    gen = torch.Generator().manual_seed(b * c)
    q = torch.randint(-127, 128, (b, h, w, c), generator=gen,
                      dtype=torch.int8).to(dev)
    assert torch.equal(K.se_squeeze_i8(q), K.se_squeeze_i8_plain(q))
    gain = (torch.rand((b, c), generator=gen) * 2).to(gain_dtype).to(dev)
    got = K.se_excite_i8(q, gain)
    torch.cuda.synchronize()
    assert torch.equal(got, K.se_excite_i8_plain(q, gain))


@pytest.mark.parametrize("b,h,w,c", [(2, 16, 16, 64), (1, 7, 9, 32)])
def test_k3_equals_plain(dev, b, h, w, c):
    gen = torch.Generator().manual_seed(h + c)
    q = torch.randint(-128, 128, (b, h, w, c), generator=gen,
                      dtype=torch.int8).to(dev)
    got = K.maxpool2x2_i8(q)
    torch.cuda.synchronize()
    assert torch.equal(got, K.maxpool2x2_i8_plain(q))


@pytest.mark.parametrize("b,r,w,c", [(2, 8, 16, 64), (1, 3, 9, 16),
                                     (2, 5, 7, 32)])
def test_k3s_equals_plain(dev, b, r, w, c):
    gen = torch.Generator().manual_seed(r * w + c)
    q = torch.randint(-128, 128, (b, r, w, 2 * c), generator=gen,
                      dtype=torch.int8).to(dev)
    before = K.LAUNCHES["maxpool_exit_s2d_i8"]
    got = K.maxpool_exit_s2d_i8(q)
    assert K.LAUNCHES["maxpool_exit_s2d_i8"] == before + 1
    torch.cuda.synchronize()
    assert got.shape == (b, r, w // 2, c)
    assert torch.equal(got, K.maxpool_exit_s2d_i8_plain(q))


@pytest.mark.parametrize("b,h,w,c", [(2, 16, 16, 128), (3, 7, 5, 48),
                                     (1, 4, 4, 1024), (1, 3, 11, 16)])
def test_k4_equals_plain(dev, b, h, w, c):
    gen = torch.Generator().manual_seed(b * h * c)
    q = torch.randint(-128, 128, (b, h, w, c), generator=gen,
                      dtype=torch.int8).to(dev)
    before = dict(K.LAUNCHES)
    stats = K.sa_stats_i8(q, 0.0173)
    g = torch.rand((b, h, w), generator=gen).to(dev)
    got = K.sa_gate_i8(q, g)
    assert K.LAUNCHES["sa_stats_i8"] == before["sa_stats_i8"] + 1
    assert K.LAUNCHES["sa_gate_i8"] == before["sa_gate_i8"] + 1
    torch.cuda.synchronize()
    assert torch.equal(stats, K.sa_stats_i8_plain(q, 0.0173))
    assert torch.equal(got, K.sa_gate_i8_plain(q, g))


def test_wrappers_reject_bad_input(dev):
    q = torch.zeros((1, 4, 4, 24), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        K.maxpool2x2_i8(q)  # C % 16 != 0
    with pytest.raises(TypeError):
        K.se_squeeze_i8(torch.zeros((1, 4, 4, 32), dtype=torch.int32,
                                    device=dev))
    with pytest.raises(ValueError):
        K.maxpool_exit_s2d_i8(torch.zeros((1, 4, 4, 48), dtype=torch.int8,
                                          device=dev))  # C = 24
    with pytest.raises(ValueError):
        K.sa_gate_i8(torch.zeros((1, 4, 4, 32), dtype=torch.int8,
                                 device=dev),
                     torch.zeros((1, 4, 5), device=dev))  # gate shape
    y = torch.zeros((1, 2, 2, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # Cout 8
        K.up_concat_i8(y, torch.zeros((32, 32), dtype=torch.bfloat16,
                                      device=dev), None,
                       torch.zeros((1, 4, 4, 16), dtype=torch.int8,
                                   device=dev), 0.5)
    with pytest.raises(ValueError):  # the skip's pixels
        K.up_concat_i8(y, torch.zeros((32, 64), dtype=torch.bfloat16,
                                      device=dev), None,
                       torch.zeros((1, 4, 2, 16), dtype=torch.int8,
                                   device=dev), 0.5)
    with pytest.raises(ValueError):  # C % 16
        K.stem_pool_i8(torch.zeros((1, 24, 4, 4), dtype=torch.bfloat16,
                                   device=dev), 0.5)


def test_int8_engine_card_vs_cpu(dev):
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.models.unet_int8 import (
        make_int8_predict_fn,
        pack_unet_int8,
        prepare_int8,
    )

    torch.manual_seed(0)
    model = UNet(num_classes=2, base_features=16, use_se=True).eval()
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 1)) \
        .astype(np.float32)
    tree = pack_unet_int8(model.state_dict(), [x], s2d=False, device=dev)
    before = dict(K.LAUNCHES)
    gpu = make_int8_predict_fn(prepare_int8(tree, dev))(x).float().cpu()
    launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
                if K.LAUNCHES[k] != before[k]}
    assert launched == {"int8_conv3x3_epilogue": 18, "se_squeeze_i8": 9,
                        "se_excite_i8": 9, "maxpool2x2_i8": 4,
                        "up_concat_i8": 4}
    cpu = make_int8_predict_fn(prepare_int8(tree, "cpu"))(x).float()
    rel = float((gpu - cpu).abs().max() / cpu.abs().max())
    agree = float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())
    assert rel <= 2e-2 and agree >= 0.995, (rel, agree)


@pytest.mark.parametrize("variant", ["s2d", "sa"])
def test_unet_int8_variants_card_vs_cpu(dev, variant):
    """U-Net-CA in the H-s2d layout (K3s at the level-1 exit) and U-Net-SA
    in the standard layout (K4a / K4b at every decoder concat)."""
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.models.unet_int8 import (
        make_int8_predict_fn,
        pack_unet_int8,
        prepare_int8,
    )

    torch.manual_seed(0)
    sa = variant == "sa"
    model = UNet(num_classes=2, base_features=16, use_se=not sa,
                 use_sa=sa).eval()
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 1)) \
        .astype(np.float32)
    tree = pack_unet_int8(model.state_dict(), [x], s2d=not sa, device=dev)
    before = dict(K.LAUNCHES)
    gpu = make_int8_predict_fn(prepare_int8(tree, dev))(x).float().cpu()
    launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
                if K.LAUNCHES[k] != before[k]}
    assert launched == ({"int8_conv3x3_epilogue": 18, "maxpool2x2_i8": 4,
                         "sa_stats_i8": 4, "sa_gate_i8": 4,
                         "up_concat_i8": 4} if sa else
                        {"int8_conv3x3_epilogue": 18, "se_squeeze_i8": 9,
                         "se_excite_i8": 9, "maxpool2x2_i8": 3,
                         "maxpool_exit_s2d_i8": 1, "up_concat_i8": 4})
    cpu = make_int8_predict_fn(prepare_int8(tree, "cpu"))(x).float()
    rel = float((gpu - cpu).abs().max() / cpu.abs().max())
    agree = float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())
    assert rel <= 2e-2 and agree >= 0.995, (rel, agree)


K5A_CASES = [  # (b, h, w, cin, cout, k, stride, dilation)
    (2, 20, 36, 64, 80, 3, 1, 1), (1, 17, 9, 96, 64, 3, 2, 1),
    (1, 16, 16, 64, 128, 3, 1, 2), (2, 8, 8, 256, 64, 3, 1, 12),
    (1, 4, 4, 128, 64, 3, 1, 36), (2, 9, 13, 256, 64, 1, 1, 1),
    (1, 15, 15, 64, 256, 1, 2, 1), (1, 8, 8, 40, 48, 3, 1, 4),
]


def _k5a_args(gen, b, h, w, cin, cout, k, stride, exit_, idn_kind, dev):
    q = torch.from_numpy(quant_weight(np.random.default_rng(cin + cout + k)
                                      .normal(0, 1, (k, k, cin, cout)))["q"])
    x = torch.randint(-127, 128, (b, h, w, cin), generator=gen,
                      dtype=torch.int8)
    acc_sd = 127.0 * 127.0 * np.sqrt(k * k * cin) / 3
    mult = (torch.rand(cout, generator=gen) + 0.5) * (60 / acc_sd)
    off = torch.randn(cout, generator=gen) * 10
    shape = (b, (h - 1) // stride + 1, (w - 1) // stride + 1, cout)
    kw = {"out_s": 0.5 if exit_ == "s8" else None, "bf16": exit_ == "bf16"}
    if idn_kind == "s8":
        kw["idn"] = torch.randint(-127, 128, shape, generator=gen,
                                  dtype=torch.int8).to(dev)
        kw["in_s"] = 0.3
    elif idn_kind == "f32":
        kw["idn"] = (torch.randn(shape, generator=gen) * 20).to(dev)
    return (x.to(dev), K.repack_conv_weight(q).to(dev), mult.to(dev),
            off.to(dev)), kw


@pytest.mark.parametrize("b,h,w,cin,cout,k,stride,dilation", K5A_CASES)
@pytest.mark.parametrize("exit_", ["s8", "f32", "bf16"])
@pytest.mark.parametrize("idn_kind", ["none", "s8", "f32"])
def test_k5a_equals_plain(dev, b, h, w, cin, cout, k, stride, dilation,
                          exit_, idn_kind):
    gen = torch.Generator().manual_seed(h * w + cin + k)
    args, kw = _k5a_args(gen, b, h, w, cin, cout, k, stride, exit_,
                         idn_kind, dev)
    for relu in (True, False):
        kw.update(stride=stride, dilation=dilation, relu=relu)
        before = K.LAUNCHES["int8_conv_epilogue"]
        got = K.conv_i8(*args, **kw)
        assert K.LAUNCHES["int8_conv_epilogue"] == before + 1
        want = K.conv_i8_plain(*args, **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("b,h,w,c", [(2, 16, 16, 256), (3, 7, 5, 48),
                                     (1, 4, 4, 2048)])
@pytest.mark.parametrize("idn_kind", ["s8", "f32"])
def test_k5b_equals_plain(dev, b, h, w, c, idn_kind):
    gen = torch.Generator().manual_seed(b * c)
    y3q = torch.randint(-127, 128, (b, h, w, c), generator=gen,
                        dtype=torch.int8).to(dev)
    gate = (torch.rand((b, c), generator=gen) * 0.05).to(dev)
    if idn_kind == "s8":
        idn, in_s = torch.randint(-127, 128, (b, h, w, c), generator=gen,
                                  dtype=torch.int8).to(dev), 0.02
    else:
        idn, in_s = (torch.randn((b, h, w, c), generator=gen) * 3).to(dev), \
            None
    before = K.LAUNCHES["se_residual_i8"]
    got = K.se_residual_i8(y3q, gate, idn, in_s, 0.03)
    assert K.LAUNCHES["se_residual_i8"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, K.se_residual_i8_plain(y3q, gate, idn, in_s,
                                                   0.03))


SQUEEZE_CASES = [  # (b, h, w, c, fill)
    (1, 1, 1, 16, "random"), (8, 1, 1, 2048, "random"),
    (9, 1, 1, 4096, "random"), (1, 7, 9, 16, "random"),
    (8, 7, 9, 2048, "random"), (9, 13, 11, 4096, "random"),
    (1, 512, 512, 16, "random"), (8, 512, 512, 16, "+127"),
    (9, 512, 512, 16, "-128"), (1, 512, 512, 2048, "+127"),
    (1, 512, 512, 4096, "-128"), (8, 64, 64, 2048, "random"),
]


@pytest.mark.parametrize("b,h,w,c,fill", SQUEEZE_CASES)
def test_k2_squeeze_equals_plain(dev, b, h, w, c, fill):
    """One launch a call, C 16 / 2048 / 4096, HW 1 / odd / 512^2, B 1 / 8 /
    9; all codes +127 or -128 at 512^2 (every 16-bit lane fills and
    flushes)."""
    if fill == "random":
        gen = torch.Generator().manual_seed(b * h * c)
        q = torch.randint(-128, 128, (b, h, w, c), generator=gen,
                          dtype=torch.int8).to(dev)
    else:
        q = torch.full((b, h, w, c), 127 if fill == "+127" else -128,
                       dtype=torch.int8, device=dev)
    before = K.LAUNCHES["se_squeeze_i8"]
    got = K.se_squeeze_i8(q)
    assert K.LAUNCHES["se_squeeze_i8"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, K.se_squeeze_i8_plain(q))
    # the last-block counters were left at 0: a second call agrees
    assert torch.equal(K.se_squeeze_i8(q), got)


@pytest.mark.parametrize("c", [16, 2048])
@pytest.mark.parametrize("idn_kind", ["s8", "f32"])
def test_k5b_ragged_and_ties(dev, c, idn_kind):
    """An element count that is no multiple of a block (16,384 elements
    with an int8 identity, 8,192 with an f32 one), and quotients on the
    half-integer ties: out_s 0.5, gate 0.125 and in_s 0.5 make every
    y / out_s = q / 4 + qi exact, a tie where q = 2 mod 4 (int8 identity);
    the f32 identity holds (k + 1/2) / 2 and its neighbours."""
    b, h, w = 3, 5, 7
    gen = torch.Generator().manual_seed(c)
    y3q = torch.randint(-127, 128, (b, h, w, c), generator=gen,
                        dtype=torch.int8)
    gate = torch.full((b, c), 0.125)
    if idn_kind == "s8":
        idn = torch.randint(-127, 128, (b, h, w, c), generator=gen,
                            dtype=torch.int8)
        in_s = 0.5
    else:
        k = torch.randint(-20, 280, (b, h, w, c), generator=gen)
        idn = (k.float() + 0.5) / 2
        idn = torch.where(k % 3 == 0, torch.nextafter(idn, idn + 1),
                          torch.where(k % 3 == 1, idn,
                                      torch.nextafter(idn, idn - 1)))
        in_s = None
    args = (y3q.to(dev), gate.to(dev), idn.to(dev), in_s, 0.5)
    got = K.se_residual_i8(*args)
    torch.cuda.synchronize()
    want = K.se_residual_i8_plain(*args)
    assert torch.equal(got, want)
    assert (want == 127).any() and (want == 0).any()


def _no_sync_forward(predict, x):
    predict(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = predict(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("engine", ["unet-s2d", "unet-standard",
                                    "fcn-channel", "deeplabv3-none",
                                    "unet-fast", "pspnet-channel"])
def test_int8_forward_never_synchronises(dev, engine):
    """A warm int8 forward on a CUDA input under
    ``torch.cuda.set_sync_debug_mode("error")``: a call that synchronises
    the stream (a host-to-device copy of a scalar, an item()) raises."""
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 1)) \
        .astype(np.float32)
    torch.manual_seed(0)
    if engine == "unet-fast":
        from insarseg_torch.engines import make_engine
        from insarseg_torch.models.unet_stem import UNetFastS2D

        model = UNetFastS2D(num_classes=2, level1_features=16,
                            use_se=True).eval()
        predict = make_engine("unet-fast", "channel", model, None, "int8",
                              calib_batches=[x], device=dev)
    elif engine.startswith("unet"):
        from insarseg_torch.models.unet import UNet
        from insarseg_torch.models.unet_int8 import (
            make_int8_predict_fn,
            pack_unet_int8,
            prepare_int8,
        )
        model = UNet(num_classes=2, base_features=16, use_se=True).eval()
        tree = pack_unet_int8(model.state_dict(), [x],
                              s2d=engine == "unet-s2d", device=dev)
        predict = make_int8_predict_fn(prepare_int8(tree, dev))
    else:
        from insarseg_torch.models.registry import build
        from insarseg_torch.models.resnet_int8 import (
            make_resnet_int8_predict_fn,
            pack_resnet_int8,
            prepare_resnet_int8,
        )
        name, attention = engine.split("-")
        model = build(name, attention).eval()
        tree = pack_resnet_int8(model.state_dict(), [x], device=dev)
        predict = make_resnet_int8_predict_fn(prepare_resnet_int8(tree, dev))
    out = _no_sync_forward(predict, torch.from_numpy(x).to(dev))
    assert out.shape == (2, 64, 64, 2) and bool(torch.isfinite(out).all())


RESNET_CA_LAUNCHES = {  # per int8 forward
    "fcn": {"int8_conv_epilogue": 53, "se_residual_i8": 16,
            "se_squeeze_i8": 16, "stem_pool_i8": 1},
    # the backbone's 52 convs; the head is bf16
    "pspnet": {"int8_conv_epilogue": 52, "se_residual_i8": 16,
               "se_squeeze_i8": 16, "stem_pool_i8": 1},
}


@pytest.mark.parametrize("name", ["fcn", "pspnet"])
def test_resnet_int8_engine_card_vs_cpu(dev, name):
    from insarseg_torch.models.registry import build
    from insarseg_torch.models.resnet_int8 import (
        make_resnet_int8_predict_fn,
        pack_resnet_int8,
        prepare_resnet_int8,
    )

    torch.manual_seed(0)
    model = build(name, "channel").eval()
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 1)) \
        .astype(np.float32)
    tree = pack_resnet_int8(model.state_dict(), [x], device=dev)
    before = dict(K.LAUNCHES)
    gpu = make_resnet_int8_predict_fn(prepare_resnet_int8(tree, dev))(x)
    launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
                if K.LAUNCHES[k] != before[k]}
    assert launched == RESNET_CA_LAUNCHES[name]
    cpu = make_resnet_int8_predict_fn(prepare_resnet_int8(tree, "cpu"))(x)
    gpu, cpu = gpu.float().cpu(), cpu.float()
    corr = float(np.corrcoef(gpu.numpy().ravel(), cpu.numpy().ravel())[0, 1])
    agree = float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())
    assert corr >= 0.999 and agree >= 0.995, (corr, agree)


IGEMM_CASES = [  # (b, h, w, cin, cout, k, stride, dilation)
    (3, 7, 9, 64, 64, 3, 1, 1),      # M = 189: tiles straddle 3 images
    (2, 9, 11, 32, 16, 3, 1, 1),     # Cout 16
    (2, 9, 11, 32, 40, 1, 1, 1),     # Cout 40
    (2, 9, 11, 32, 2, 3, 1, 1),      # Cout 2
    (1, 20, 20, 128, 192, 3, 1, 1),  # Cout 192: three 64-wide N tiles
    (2, 13, 11, 40, 64, 3, 1, 1),    # Cin 40 -> 48: a partial K chunk
    (1, 13, 11, 96, 128, 3, 1, 1),   # Cin 96: chunks of 64 and 32 bytes
    (2, 16, 16, 1, 64, 3, 1, 1),     # Cin 1 (U-Net inc.c1)
    (2, 16, 16, 2, 128, 3, 1, 1),    # Cin 2 (U-Net inc.c1, H-s2d)
    (2, 15, 13, 64, 128, 1, 2, 1),   # 1x1 stride 2 at odd sizes
    (1, 17, 9, 256, 64, 3, 2, 1),    # 3x3 stride 2 at odd sizes
    (1, 64, 64, 64, 64, 3, 1, 36),   # dilation 36 on a 64^2 map
]


@pytest.mark.parametrize("b,h,w,cin,cout,k,stride,dilation", IGEMM_CASES)
def test_igemm_edges_equal_plain(dev, b, h, w, cin, cout, k, stride,
                                 dilation):
    """K5a with every identity kind x exit x ReLU, and K1 with both exits
    where the case is a 3x3 stride-1 conv, at the GEMM tiling's edges."""
    gen = torch.Generator().manual_seed(b * h * w + cin * cout + k)
    n = 0
    for exit_ in ("s8", "f32", "bf16"):
        for idn_kind in ("none", "s8", "f32"):
            args, kw = _k5a_args(gen, b, h, w, cin, cout, k, stride, exit_,
                                 idn_kind, dev)
            for relu in (True, False):
                kw.update(stride=stride, dilation=dilation, relu=relu)
                got = K.conv_i8(*args, **kw)
                want = K.conv_i8_plain(*args, **kw)
                torch.cuda.synchronize()
                assert got.dtype == want.dtype and torch.equal(got, want), \
                    (exit_, idn_kind, relu)
                n += 1
    if (k, stride, dilation) == (3, 1, 1):
        for bf16_exit in (False, True):
            args = _conv_args(gen, b, h, w, cin, cout, bf16_exit, dev)
            got = K.conv3x3_i8(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, K.conv3x3_i8_plain(*args)), bf16_exit
            n += 1
    assert n >= 18


@pytest.mark.parametrize("sign", [1, -1])
def test_igemm_largest_accumulator(dev, sign):
    """Cin 2048, 3x3, x = 127 everywhere and w = +-127: the interior sums
    reach +-9 * 2048 * 127^2 = +-297,289,728, the largest |acc| the int8
    engines allow. The f32 exit with mult 1, off 0 returns the sums as
    floats, so a wrapped int32 would show; the s8 and bf16 exits (K5a and
    K1) go through the scaled epilogue."""
    b, h, w, cin, cout = 1, 6, 5, 2048, 72
    x = torch.full((b, h, w, cin), 127, dtype=torch.int8, device=dev)
    q = torch.full((3, 3, cin, cout), 127 * sign, dtype=torch.int8)
    wt = K.repack_conv_weight(q).to(dev)
    one = torch.ones(cout, device=dev)
    zero = torch.zeros(cout, device=dev)
    got = K.conv_i8(x, wt, one, zero, relu=False)
    want = K.conv_i8_plain(x, wt, one, zero, relu=False)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(got[0, 2, 2].abs().min()) == 9 * 2048 * 127.0 ** 2
    mult = torch.full((cout,), 100.0 / 3e8, device=dev)
    off = torch.linspace(-20, 20, cout, device=dev)
    for out_s in (2.0, None):
        kw = {"relu": False, "out_s": out_s, "bf16": out_s is None}
        assert torch.equal(K.conv_i8(x, wt, mult, off, **kw),
                           K.conv_i8_plain(x, wt, mult, off, **kw))
        assert torch.equal(K.conv3x3_i8(x, wt, mult, off, out_s),
                           K.conv3x3_i8_plain(x, wt, mult, off, out_s))
    torch.cuda.synchronize()


def test_conv_wrappers_reject_bad_input(dev):
    q = torch.zeros((3, 3, 40, 64), dtype=torch.int8)
    wt = K.repack_conv_weight(q).to(dev)  # Cin 48
    mult = torch.ones(64, device=dev)
    x = torch.zeros((1, 4, 4, 32), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        K.conv_i8(x, wt, mult, mult)  # 32 channels, w takes 33-48
    with pytest.raises(ValueError):
        K.conv3x3_i8(torch.zeros((1, 4, 4, 40), dtype=torch.int8,
                                 device=dev), wt, mult[:32], mult[:32], 0.5)


UP_CASES = [  # (b, h, w, cin, cout, s2d): y (b, h, w, cin) bf16
    (1, 4, 4, 1024, 512, False),   # up1's widths, b1
    (8, 32, 32, 1024, 512, False),  # up1 at full width: b8, 32^2
    (8, 3, 5, 1024, 64, False),    # b8, 15 pixels an image (M = 120);
                                   # Cout 64: a 128-column tile spans taps
    (2, 7, 9, 128, 64, False),     # Cin 128, 63 pixels an image
    (1, 5, 7, 128, 128, True),     # the H-s2d up4, b1, 35 pixels
    (8, 4, 6, 128, 128, True),     # the H-s2d up4, b8
    (3, 9, 11, 40, 48, False),     # Cin 40 (a partial K stage), N = 192
    (1, 33, 17, 256, 16, False),   # M = 561: a partial 128-row tile
    (2, 13, 7, 72, 80, False),     # M 182, N 320, K 72: no dimension
                                   # divides its tile; taps across tiles
    (1, 9, 13, 200, 96, True),     # H-s2d form, K 200, N 192
]

# K6's counted bar (kernels/up_i8.py::assert_up_codes_close): every code
# within 1 of the plain version, at most the measured share of the ConvT's
# codes differing (kernels/up_i8.py::UP_SHARE_*): z about N(0, 1) at
# cat_s 0.015, and the tie-heavy case, z about N(0, 20^2) at cat_s 0.5 (a
# quarter of the bf16 z on a tie of z / cat_s).
K6_SHARE = {0.015: K.UP_SHARE_RANDOM, 0.5: K.UP_SHARE_TIES}


@pytest.mark.parametrize("b,h,w,cin,cout,s2d", UP_CASES)
@pytest.mark.parametrize("cat_s", [0.015, 0.5])
def test_k6_equals_plain(dev, b, h, w, cin, cout, s2d, cat_s):
    """K6 against its plain version by the counted bar: the skip's codes
    equal, the ConvT's within 1 at a bounded share (the tensor cores sum in
    another order than the plain version's ascending-k f32 sum), both
    forms, with and without a bias. cat_s 0.015 drives a share of the codes
    to +-127 (z is about N(0, 1)); cat_s 0.5 with z about N(0, 20^2) puts a
    quarter of the bf16 z on the half-integer ties of z / cat_s."""
    gen = torch.Generator().manual_seed(b * h * w + cin + cout)
    scale = 1.0 if cat_s < 0.1 else 20.0
    y = (torch.randn((b, h, w, cin), generator=gen) * scale) \
        .to(torch.bfloat16)
    k = torch.randn((1 if s2d else 2, 2, cin, cout), generator=gen) \
        / np.sqrt(cin)
    wt = K.pack_up_weight(k, s2d).to(dev)
    ho = h if s2d else 2 * h
    skip = torch.randint(-127, 128, (b, ho, 2 * w, cout), generator=gen,
                         dtype=torch.int8).to(dev)
    bias = (torch.randn(cout, generator=gen) * 0.5).to(torch.bfloat16)
    for bb in (bias.to(dev), None):
        args = (y.to(dev), wt, bb, skip, cat_s, s2d)
        before = K.LAUNCHES["up_concat_i8"]
        got = K.up_concat_i8(*args)
        assert K.LAUNCHES["up_concat_i8"] == before + 1
        want = K.up_concat_i8_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == (b, ho, 2 * w, 2 * cout)
        dmax, share = K.assert_up_codes_close(got, want, cout,
                                              K6_SHARE[cat_s])
        print(f"K6 {(b, h, w, cin, cout, s2d)} cat_s {cat_s} bias "
              f"{bb is not None}: {share:.3e} of {got[..., cout:].numel()} "
              f"codes differ, max |d| {dmax}")
        if cat_s < 0.1:
            zq = want[..., cout:]
            assert (zq == 127).any() and (zq == -127).any()


@pytest.mark.parametrize("b,c,h,w", [(1, 64, 7, 9), (2, 16, 13, 1),
                                     (1, 128, 5, 130), (3, 48, 11, 7),
                                     (8, 64, 64, 64), (2, 64, 9, 24),
                                     (1, 16, 7, 8), (1, 64, 3, 520),
                                     (1, 16, 1, 16), (3, 32, 15, 1),
                                     (8, 64, 256, 256)])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_k7_equals_plain(dev, b, c, h, w, layout):
    """K7 against requant(max_pool2d(3, 2, 1)) on NCHW and on channels-last
    input (the stem conv's output on the card): odd H and W, b1 and b8,
    channel groups of 64 with a partial one (C 48, 128), codes driven to
    +-127. The NCHW kernel's 16-byte row loads need W % 8 == 0: W 24 (not
    a multiple of 16), 8 (one vector a row), 64, 256 (the main path's
    512^2 b8 stem) and 520 (three column spans, so a warp's first lane
    reads its left neighbour itself); W 1, 7, 9 and 130 take its scalar
    loads; H 1 and odd H cut the last band of output rows."""
    gen = torch.Generator().manual_seed(b * c * h + w)
    y = torch.randn((b, c, h, w), generator=gen).to(torch.bfloat16).to(dev)
    if layout == "channels_last":
        y = y.contiguous(memory_format=torch.channels_last)
    before = K.LAUNCHES["stem_pool_i8"]
    got = K.stem_pool_i8(y, 0.01)
    assert K.LAUNCHES["stem_pool_i8"] == before + 1
    want = K.stem_pool_i8_plain(y, 0.01)
    torch.cuda.synchronize()
    assert got.shape == (b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c)
    assert torch.equal(got, want)
    assert (want == 127).any()


def test_train_step_never_synchronises_and_matches_the_cpu(dev):
    """A warm U-Net-CA train step on CUDA tensors synchronises nothing, and
    two steps on the card match the CPU's from the same weights (TF32 off
    inside the step): losses within rtol 1e-4 and 5e-4, equal counts on
    step 1."""
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.train.engine import create_state, make_train_step

    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.standard_normal((2, 32, 32, 1))
                                 .astype(np.float32)),
                torch.from_numpy(rng.integers(0, 2, (2, 32, 32))))
               for _ in range(2)]
    outs = {}
    for where in ("cpu", "cuda"):
        model = UNet(base_features=16, use_se=True)
        state = create_state(model, seed=0, device=where)
        step = make_train_step(model, 2)
        outs[where] = [step(state, x.to(where), m.to(where))
                       for x, m in batches]
    cpu, gpu = outs["cpu"], outs["cuda"]
    assert float(gpu[0]["loss"]) == pytest.approx(float(cpu[0]["loss"]),
                                                  rel=1e-4)
    assert float(gpu[1]["loss"]) == pytest.approx(float(cpu[1]["loss"]),
                                                  rel=5e-4)
    for k in ("tp", "fp", "fn", "correct", "valid"):
        assert torch.equal(gpu[0][k].cpu(), cpu[0][k]), k
    x, m = (t.to(dev) for t in batches[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, x, m)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


BN_CASES = [(2, 64, 32, 32), (3, 48, 17, 19), (4, 5, 1, 1), (2, 1, 64, 64),
            (2, 3, 9, 9)]


def _bn_close(got, want):
    c = want.shape[0] // 2
    for part in (slice(0, c), slice(c, 2 * c), slice(2 * c, None)):
        w = want[part]
        if w.numel():
            torch.testing.assert_close(got[part], w, rtol=0,
                                       atol=1e-10 * float(w.abs().max()))


@pytest.mark.parametrize("n,c,h,w", BN_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_bn_act_equals_plain(dev, n, c, h, w, dtype, layout):
    from insarseg_torch.kernels import bn_act as B

    g = torch.Generator(device=dev).manual_seed(n + c + h + w)
    y = (torch.randn(n, c, h, w, generator=g, device=dev) * 2 + 0.5) \
        .to(dtype)
    dy = torch.randn(n, c, h, w, generator=g, device=dev).to(dtype)
    if layout == "channels_last":
        y = y.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    bias, beta = (torch.randn(c, generator=g, device=dev) for _ in range(2))
    gamma = torch.rand(c, generator=g, device=dev) + 0.5
    rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    stats = B.bn_stats(y, bias)
    _bn_close(stats, B.bn_stats_plain(y, bias))
    rm2, rv2 = rm.clone(), rv.clone()
    out = B.bn_apply_relu(y, bias, stats, gamma, beta, rm, rv, 1e-5, 0.1)
    assert torch.equal(out, B.bn_apply_relu_plain(
        y, bias, stats, gamma, beta, rm2, rv2, 1e-5, 0.1))
    assert torch.equal(rm, rm2) and torch.equal(rv, rv2)
    assert B.layout_of(out) == B.layout_of(y)
    gs = B.bn_relu_grad_stats(dy, y, bias, stats, gamma, beta, 1e-5)
    _bn_close(gs, B.bn_relu_grad_stats_plain(dy, y, bias, stats, gamma, beta,
                                             1e-5))
    dt = B.bn_relu_grad_apply(dy, y, bias, stats, gs, gamma, beta, 1e-5)
    assert torch.equal(dt, B.bn_relu_grad_apply_plain(
        dy, y, bias, stats, gs, gamma, beta, 1e-5))
    assert torch.equal(stats, B.bn_stats(y, bias))
    assert torch.equal(gs, B.bn_relu_grad_stats(dy, y, bias, stats, gamma,
                                                beta, 1e-5))


BN_LEVELS = [(2, 64 * 2 ** k, 512 >> k, 512 >> k) for k in range(5)]


@pytest.mark.parametrize("n,c,h,w", BN_LEVELS)
@pytest.mark.parametrize("form", ["bf16-channels_last", "f32-nchw"])
def test_bn_reductions_at_the_step_levels(dev, n, c, h, w, form):
    """K8a / K9a at the U-Net's five levels (batch 2) against their plain
    versions; bit-equal over two runs, over ten calls queued back to back
    on one stream (the last-block counters reset themselves), on a second
    stream, and with dout in the other layout."""
    from insarseg_torch.kernels import bn_act as B

    dtype = torch.bfloat16 if form.startswith("bf16") else torch.float32
    g = torch.Generator(device=dev).manual_seed(c + h)
    y = (torch.randn(n, c, h, w, generator=g, device=dev) * 2 + 0.5) \
        .to(dtype)
    dy = torch.randn(n, c, h, w, generator=g, device=dev).to(dtype)
    if form.endswith("channels_last"):
        y = y.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    bias, beta = (torch.randn(c, generator=g, device=dev) for _ in range(2))
    gamma = torch.rand(c, generator=g, device=dev) + 0.5
    stats = B.bn_stats(y, bias)
    _bn_close(stats, B.bn_stats_plain(y, bias))
    gs = B.bn_relu_grad_stats(dy, y, bias, stats, gamma, beta, 1e-5)
    _bn_close(gs, B.bn_relu_grad_stats_plain(dy, y, bias, stats, gamma, beta,
                                             1e-5))

    def both():
        return (B.bn_stats(y, bias),
                B.bn_relu_grad_stats(dy, y, bias, stats, gamma, beta, 1e-5))

    runs = [both() for _ in range(10)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs.append(both())
    torch.cuda.current_stream().wait_stream(side)
    other = dy.contiguous() if B.layout_of(y) else \
        dy.contiguous(memory_format=torch.channels_last)
    runs.append((stats, B.bn_relu_grad_stats(other, y, bias, stats, gamma,
                                             beta, 1e-5)))
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(runs):
        assert torch.equal(a, stats) and torch.equal(b, gs), k


def test_train_double_conv_launches_the_kernels(dev, monkeypatch):
    from insarseg_torch.kernels import bn_act as B
    from insarseg_torch.ops.blocks import DoubleConv

    from insarseg_torch.kernels import se_train as S

    for name in ("bn_stats_plain", "bn_apply_relu_plain",
                 "bn_relu_grad_stats_plain", "bn_relu_grad_apply_plain"):
        monkeypatch.setattr(B, name, pytest.fail)
    for name in ("se_squeeze_plain", "se_excite_plain",
                 "se_grad_stats_plain", "se_grad_apply_plain"):
        monkeypatch.setattr(S, name, pytest.fail)
    m = DoubleConv(3, 32, use_se=True).to(dev).train()
    x = torch.randn(2, 3, 16, 16, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    names = ("bn_stats", "bn_apply_relu", "bn_relu_grad_stats",
             "bn_relu_grad_apply")
    se_names = ("se_squeeze", "se_excite", "se_grad_stats", "se_grad_apply")
    before = {k: K.LAUNCHES[k] for k in names + se_names}
    m(x).float().square().sum().backward()
    torch.cuda.synchronize()
    assert {k: K.LAUNCHES[k] - before[k] for k in names + se_names} == \
        {**dict.fromkeys(names, 2), **dict.fromkeys(se_names, 1)}
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad).all()


# K10a-K11b (kernels/se_train.py): (B, C, H, W, channels-last)
SE_CASES = [(2, 64, 16, 16, False), (2, 64, 16, 16, True),
            (3, 48, 7, 5, False), (2, 20, 6, 6, True), (2, 32, 1, 1, False),
            (2, 64, 0, 8, True), (2, 8, 128, 128, False),
            (1, 64, 128, 128, True)]


@pytest.mark.parametrize("b,c,h,w,cl", SE_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("mode", ["scale", "residual"])
def test_se_train_equals_plain(dev, b, c, h, w, cl, dtype, mode):
    from insarseg_torch.kernels import se_train as S

    g = torch.Generator(device=dev).manual_seed(b * c + h + w)
    acc = torch.promote_types(dtype, torch.float32)

    def image():
        t = torch.randn((b, c, h, w), generator=g, device=dev).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    x, idn, dout = image(), image(), image()
    gate = torch.rand((b, c), generator=g, device=dev).to(dtype)
    dtot = (torch.randn((b, c), generator=g, device=dev) * 1e-3).to(acc)
    r = idn if mode == "residual" else None
    sums = S.se_squeeze(x)
    want = S.se_squeeze_plain(x)
    assert torch.allclose(sums, want, rtol=0,
                          atol=1e-12 * float(want.abs().max().clamp_min(1)))
    out = S.se_excite(x, gate, r, mode)
    assert torch.equal(out, S.se_excite_plain(x, gate, r, mode))
    o = out if mode == "residual" else None
    gs = S.se_grad_stats(dout, x, o, mode)
    want = S.se_grad_stats_plain(dout, x, o, mode)
    assert torch.allclose(gs, want, rtol=0,
                          atol=1e-12 * float(want.abs().max().clamp_min(1)))
    assert torch.equal(S.se_grad_stats(dout, x, o, mode), gs)
    got = S.se_grad_apply(dout, gate, dtot, o, mode)
    want = S.se_grad_apply_plain(dout, gate, dtot, o, mode)
    for a, e in zip(got if mode == "residual" else (got,),
                    want if mode == "residual" else (want,)):
        assert torch.equal(a, e)


@pytest.mark.parametrize("b,c,h,w,cl", SE_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_cbam_train_equals_plain(dev, b, c, h, w, cl, dtype):
    import chip_smoke as C
    from insarseg_torch.kernels import se_train as S

    a = C.se_inputs(dev, b, c, h, w, dtype, cl, b * c + h + w, "cbam")
    before = dict(K.LAUNCHES)
    for name, args in C.se_steps(a, "cbam").items():
        got = getattr(S, name)(**args)
        C.se_compare(name)(got, getattr(S, name + "_plain")(**args))
        assert C._same_result(got, getattr(S, name)(**args))
    torch.cuda.synchronize()
    assert {k: K.LAUNCHES[k] - before[k] for k in C.SE_KERNELS} == \
        dict.fromkeys(C.SE_KERNELS, 2)


def test_train_cbam_gate_launches_the_kernels(dev, monkeypatch):
    from insarseg_torch.kernels import se_train as S
    from insarseg_torch.ops.blocks import ChannelAttentionModule

    names = ("se_squeeze", "se_excite", "se_grad_stats", "se_grad_apply")
    for name in names:
        monkeypatch.setattr(S, name + "_plain", pytest.fail)
    m = ChannelAttentionModule(64).to(dev).train()
    x = torch.relu(torch.randn(2, 64, 16, 16, device=dev,
                               dtype=torch.bfloat16)).requires_grad_(True)
    before = {k: K.LAUNCHES[k] for k in names}
    m(x).float().square().sum().backward()
    torch.cuda.synchronize()
    assert {k: K.LAUNCHES[k] - before[k] for k in names} == \
        dict.fromkeys(names, 1)
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad).all()
    assert m.mlp[0].weight.grad is not None


# K12a-K13b (kernels/sa_train.py): (B, C, H, W, channels-last); the
# inputs (ties in the channel max) and bars are chip_smoke.py's
SA_CASES = [(2, 64, 16, 16, False), (2, 64, 16, 16, True),
            (3, 7, 5, 3, False), (3, 7, 5, 3, True), (2, 1, 8, 8, False),
            (2, 32, 1, 1, True), (2, 64, 0, 8, True), (2, 2048, 8, 8, False),
            (1, 128, 64, 64, True)]


@pytest.mark.parametrize("b,c,h,w,cl", SA_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_sa_train_equals_plain(dev, b, c, h, w, cl, dtype):
    import chip_smoke as C
    from insarseg_torch.kernels import sa_train as S

    a = C.sa_inputs(dev, b, c, h, w, dtype, cl, b * c + h + w)
    before = dict(K.LAUNCHES)
    for name, args in C.sa_steps(a).items():
        got = getattr(S, name)(**args)
        C.sa_compare(name)(got, getattr(S, name + "_plain")(**args))
        assert C._same_result(got, getattr(S, name)(**args))
    torch.cuda.synchronize()
    assert {k: K.LAUNCHES[k] - before[k] for k in C.SA_KERNELS} == \
        dict.fromkeys(C.SA_KERNELS, 2 if h else 0)


@pytest.mark.parametrize("gate", ["conv", "double_conv"])
def test_train_spatial_gates_launch_the_kernels(dev, monkeypatch, gate):
    from insarseg_torch.kernels import sa_train as S
    from insarseg_torch.ops.blocks import (
        SpatialAttentionConv,
        SpatialAttentionDC,
    )

    names = ("sa_pool", "sa_apply", "sa_grad_stats", "sa_grad_apply")
    for name in names:
        monkeypatch.setattr(S, name + "_plain", pytest.fail)
    m = (SpatialAttentionConv(7) if gate == "conv"
         else SpatialAttentionDC()).to(dev).train()
    x = torch.randn(2, 64, 16, 16, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    before = {k: K.LAUNCHES[k] for k in names}
    m(x).float().square().sum().backward()
    torch.cuda.synchronize()
    assert {k: K.LAUNCHES[k] - before[k] for k in names} == \
        dict.fromkeys(names, 1)
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad).all()
