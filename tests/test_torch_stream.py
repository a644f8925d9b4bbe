"""The port's streaming scene inference (``insarseg_torch/data/serve.py``)
on the CPU, against the port's in-memory ``sliding_window_inference``
(itself held to the JAX package's within 1e-6) and against the JAX
package's ``stream_scene_inference`` on the same inputs:

- the toy 2-logit forward of ``tests/test_serve.py`` at tile 48 / overlap
  16 over its grid of band layouts (uniform rows, a clamped last band at
  several shifts, one band, a clamped band after many) and batches (one
  band a call, and more bands than the scene has), device and host
  stitch: within 1e-5, and the device stitch equal bit for bit (it adds
  in plan order, as the in-memory stitch does), also where a row lies in
  three bands (``2 * overlap > tile``);
- ``emit="argmax"`` equal to the in-memory argmax; several bands a call
  with a padded last call; uint8 normalized on the device equal to the
  CLI's ``normalize_scene``; memory-mapped and callable readers and
  writers, the rows written in order; one engine batch of whole bands for
  every call;
- the JAX package's stream on three of those cases (logits within 1e-5,
  argmax equal);
- the slice as a whole: U-Net-CA at base 16, its weights carried across
  by ``unet_variables_to_torch``, a uint8 scene streamed through the JAX
  module's jitted apply and the port's module engine: logits within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insarseg.data.serve import stream_scene_inference as jax_stream
from insarseg_torch.cli import normalize_scene
from insarseg_torch.config import Config
from insarseg_torch.data import stream_scene_inference
from insarseg_torch.data.serve import bands_per_call, normalize_u8
from insarseg_torch.data.stitch import sliding_window_inference

TILE, OVERLAP = 48, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def apply_fn(x):
    """The toy forward: (B, t, t, 1) -> (B, t, t, 2)."""
    return torch.cat([x * 2.0 + 1.0, -x], dim=-1)


def jax_apply_fn(x):
    return jnp.concatenate([x * 2.0 + 1.0, -x], axis=-1)


def _scene(seed, h, w):
    return np.random.default_rng(seed).standard_normal((h, w, 1)) \
        .astype(np.float32)


def in_memory(scene, tile=TILE, overlap=OVERLAP):
    return sliding_window_inference(apply_fn, scene, tile=tile,
                                    overlap=overlap, device="cpu").numpy()


def stream(scene, shape, **kw):
    kw = {"tile": TILE, "overlap": OVERLAP, "normalize": None,
          "device": "cpu", **kw}
    return stream_scene_inference(apply_fn, scene, shape, 2, **kw)


@pytest.mark.parametrize("device_stitch", [True, False])
@pytest.mark.parametrize("bs", [2, 100])
@pytest.mark.parametrize("h", [112, 96, 114, 104, 48, 146])
def test_stream_matches_in_memory(h, bs, device_stitch):
    w = 130
    scene = _scene(7, h, w)
    want = in_memory(scene)
    got = stream(scene, (h, w), batch_size=bs, device_stitch=device_stitch)
    assert got.shape == (h, w, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if device_stitch:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h", [112, 114, 48, 146])
def test_stream_emit_argmax(h):
    w = 130
    scene = _scene(21, h, w)
    got = stream(scene, (h, w), batch_size=6, emit="argmax")
    assert got.dtype == np.uint8 and got.shape == (h, w)
    np.testing.assert_array_equal(got, in_memory(scene).argmax(-1))


@pytest.mark.parametrize("emit", ["logits", "argmax"])
def test_stream_big_overlap_stitches_on_the_device(emit):
    """2 * overlap > tile: a row lies in three bands; the rolling
    accumulator carries it from band to band, equal bit for bit to the
    in-memory stitch (the argmax: to its argmax)."""
    scene = _scene(23, 96, 96)
    want = in_memory(scene, 48, 30)
    got = stream(scene, (96, 96), tile=48, overlap=30, batch_size=4,
                 emit=emit)
    if emit == "argmax":
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want.argmax(-1))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bs", [9, 11])
def test_stream_several_bands_a_call_with_pad_bands(bs):
    """7 bands of 3 column tiles at batch 9 (11 rounds down to whole
    bands): calls of 3, 3 and 1 bands, the last padded with zero tiles,
    every call one batch."""
    h, w = 240, 96
    scene = _scene(8, h, w)
    shapes = []

    def spying(x):
        shapes.append(tuple(x.shape))
        return apply_fn(x)

    got = stream_scene_inference(spying, scene, (h, w), 2, TILE, OVERLAP,
                                 batch_size=bs, normalize=None, device="cpu")
    np.testing.assert_array_equal(got, in_memory(scene))
    assert shapes == [(9, TILE, TILE, 1)] * 3


@pytest.mark.parametrize("device_stitch", [True, False])
@pytest.mark.parametrize("bs", [1, 5, 16])
def test_every_engine_call_has_one_batch(bs, device_stitch):
    h, w = 146, 130  # 5 bands of 4 column tiles
    shapes = []

    def spying(x):
        shapes.append(tuple(x.shape))
        return apply_fn(x)

    stream_scene_inference(spying, _scene(3, h, w), (h, w), 2, TILE,
                           OVERLAP, batch_size=bs, normalize=None,
                           device_stitch=device_stitch, device="cpu")
    # the device stitch: whole bands, at least one, spread evenly over the
    # calls (bs 5: one band of 4 tiles; bs 16: 4 bands -> calls of 3 and 2)
    eb = {1: 4, 5: 4, 16: 12}[bs] if device_stitch else bs
    assert shapes and set(shapes) == {(eb, TILE, TILE, 1)}, shapes


def test_bands_per_call_keeps_the_calls_and_pads_least():
    """As many whole bands as the batch holds (at least one), lowered to
    the fewest that need no more calls."""
    assert bands_per_call(19, 19, 128) == 5  # 8192 wide: 5, 5, 5, 4
    assert bands_per_call(37, 37, 128) == 3  # 16384 wide: 13 calls of 3
    assert bands_per_call(3, 40, 32) == 1    # a band over the batch
    for n in range(1, 41):
        for n_cols in range(1, 9):
            for bs in range(1, 50):
                g0 = min(max(1, bs // n_cols), n)
                calls = -(-n // g0)
                g = bands_per_call(n, n_cols, bs)
                assert -(-n // g) == calls and g <= g0
                assert g == 1 or -(-n // (g - 1)) > calls
                assert calls * g - n < calls


def test_normalize_u8_equals_normalize_scene():
    """The device normalize divides by tensors on the device, which rounds
    as the host's ``normalize_scene`` does: equal bit for bit."""
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for mean, std in ((0.5, 0.5), (0.3, 0.2), (0.485, 0.229)):
        cfg = Config(normalize_mean=mean, normalize_std=std)
        got = normalize_u8(torch.from_numpy(u8), mean, std).numpy()
        np.testing.assert_array_equal(got[..., None],
                                      normalize_scene(u8, cfg))


@pytest.mark.parametrize("device_stitch", [True, False])
def test_stream_u8_normalizes(device_stitch):
    """uint8 scenes go up as bytes and are normalized on the device (the
    host path: in C on the host)."""
    h, w = 114, 96
    u8 = np.random.default_rng(9).integers(0, 256, (h, w), np.uint8)
    want = in_memory(normalize_scene(u8, Config()))
    got = stream_scene_inference(apply_fn, u8, (h, w), 2, TILE, OVERLAP,
                                 batch_size=8, normalize=(0.5, 0.5),
                                 device_stitch=device_stitch, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if device_stitch:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("emit", ["logits", "argmax"])
def test_stream_memmap_reader_and_writer(tmp_path, emit):
    """The scene and the output both in memory-mapped files."""
    h, w = 146, 112
    scene = _scene(10, h, w)
    src = np.lib.format.open_memmap(tmp_path / "scene.npy", "w+",
                                    np.float32, (h, w, 1))
    src[:] = scene
    src.flush()
    src = np.load(tmp_path / "scene.npy", mmap_mode="r")
    shape = (h, w, 2) if emit == "logits" else (h, w)
    dst = np.lib.format.open_memmap(
        tmp_path / "out.npy", "w+",
        np.float32 if emit == "logits" else np.uint8, shape)
    assert stream(src, (h, w), batch_size=6, writer=dst, emit=emit) is None
    want = in_memory(scene)
    np.testing.assert_array_equal(
        np.asarray(dst), want if emit == "logits" else want.argmax(-1))


def test_stream_callable_reader_and_ordered_writer():
    """A callable reader sees only full band windows (and one 1-row dtype
    probe); a callable writer gets the rows in ascending order, each row
    once."""
    h, w = 146, 96
    scene = _scene(11, h, w)
    seen, written = [], []
    got = np.full((h, w, 2), np.nan, np.float32)

    def reader(r0, n):
        seen.append((r0, n))
        return scene[r0:r0 + n]

    def writer(r0, rows):
        written.append((r0, rows.shape[0]))
        got[r0:r0 + rows.shape[0]] = rows

    for device_stitch in (True, False):
        seen.clear(), written.clear()
        assert stream(reader, (h, w), batch_size=4, writer=writer,
                      device_stitch=device_stitch) is None
        np.testing.assert_allclose(got, in_memory(scene), rtol=0, atol=1e-5)
        bands = [rn for rn in seen if rn != (0, 1)]
        assert all(n == TILE for _, n in bands) and len(bands) == 5
        rows = [r for r0, n in written for r in range(r0, r0 + n)]
        assert rows == list(range(h))


def test_channel_major_fetch_changes_nothing():
    h, w = 114, 130
    scene = _scene(12, h, w)
    base = stream(scene, (h, w), batch_size=6)
    for cmf in (True, False):
        for device_stitch in (True, False):
            np.testing.assert_allclose(
                stream(scene, (h, w), batch_size=6, channel_major_fetch=cmf,
                       device_stitch=device_stitch),
                base, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w,bs,emit", [(146, 130, 2, "logits"),
                                         (240, 96, 9, "logits"),
                                         (114, 130, 6, "argmax")])
def test_stream_matches_jax_stream(h, w, bs, emit):
    scene = _scene(31, h, w)
    want = jax_stream(jax_apply_fn, scene, (h, w), 2, TILE, OVERLAP,
                      batch_size=bs, normalize=None, emit=emit)
    got = stream(scene, (h, w), batch_size=bs, emit=emit)
    assert got.dtype == want.dtype and got.shape == want.shape
    if emit == "argmax":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_stream_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_scene_inference(apply_fn, _scene(0, 48, 48), (48, 48), 2,
                               TILE, OVERLAP, normalize=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_scene_inference(apply_fn, _scene(0, 48, 48), (48, 48), 2,
                               TILE, OVERLAP, normalize=None,
                               device_stitch=False)


def test_unet_ca_stream_matches_jax():
    """The slice: U-Net-CA (base 16) weights crossed from JAX, a uint8
    scene streamed through the JAX module's jitted apply by the JAX
    package and through the port's module engine by the port (tile 32,
    overlap 8, a clamped last band and column): logits within 1e-4."""
    from insarseg_torch.engines import make_engine
    from tests.test_torch_common import make_pair

    jm, v, tm = make_pair(base=16, use_se=True, hw=32)
    h, w = 96, 130
    u8 = np.random.default_rng(5).integers(0, 256, (h, w), np.uint8)
    want = jax_stream(jax.jit(lambda x: jm.apply(v, x, train=False)), u8,
                      (h, w), 2, 32, 8, batch_size=8)
    eng = make_engine("unet", "channel", tm, None, "module", device="cpu")
    got = stream_scene_inference(eng, u8, (h, w), 2, 32, 8, batch_size=8,
                                 device="cpu")
    assert got.shape == want.shape == (h, w, 2)
    err = float(np.abs(got - want).max())
    print(f"U-Net-CA stream vs JAX stream: max |delta| {err:.3g}, max|logit| "
          f"{float(np.abs(want).max()):.3g}")
    assert err <= 1e-4, err
