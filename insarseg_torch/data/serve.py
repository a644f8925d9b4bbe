"""Streaming full-scene inference for scenes larger than memory
(counterpart of ``insarseg/data/serve.py``, with its names, arguments,
defaults and return contract).

``sliding_window_inference`` (``data/stitch.py``) holds the whole scene,
every tile and the stitched ``(H, W, C)`` f32 logits on the device: 2 GB
at 16384^2 with two classes. This module streams instead:

- the scene is read one *row band* (``tile`` rows) at a time from a
  ``reader`` (an ``np.memmap``, a window reader, anything sliceable or
  callable);
- each band is cut into column tiles, which go to the engine in calls of
  one fixed batch (the tail padded with zero tiles);
- the stitched rows go to a ``writer`` as soon as no later band can touch
  them, so only one band's accumulator lives on the device.

Two stitch paths:

- the device stitch (the default, ``_stream_device_stitch``): uint8 tiles
  are uploaded as bytes and normalized on the card; each call holds
  ``G`` row bands, which the card window-weights and adds into a rolling
  ``(tile, W, C)`` f32 accumulator, and the host only reads input rows and
  writes finished output rows. Call k+1 is read, uploaded and queued
  before call k's rows are fetched, so the host's IO overlaps the card;
- the host stitch (``device_stitch=False``): tiles normalized on the host
  (``native_loader.normalize_batch_host``) and logits added on the host
  (``native_loader.stitch_accumulate_host``) in a rolling window
  (``_RollingStitcher``).

The device stitch adds each band's tiles onto the rows the previous bands
left, in plan order, and divides by denominators summed in the same order
on the host, so its logits are those of ``sliding_window_inference`` bit
for bit whenever the engine gives a tile the same logits in any batch (the
int8 engines do). The JAX package's device stitch sums each band from
zero and adds the carried rows after, an f32 ulp away.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from insarseg_torch.data.native_loader import (
    normalize_batch_host,
    stitch_accumulate_host,
)
from insarseg_torch.data.stitch import _window
from insarseg_torch.data.stitch import tile_starts as _starts
from insarseg_torch.device import DeviceLike, resolve_device
from insarseg_torch.ops.quant import f32_scalar

Reader = Union[np.ndarray, Callable[[int, int], np.ndarray]]
Writer = Union[np.ndarray, Callable[[int, np.ndarray], None]]


def _read_band(reader: Reader, r0: int, nrows: int) -> np.ndarray:
    band = reader(r0, nrows) if callable(reader) else reader[r0:r0 + nrows]
    band = np.asarray(band)
    if band.ndim == 2:
        band = band[..., None]
    return band


def _write_rows(writer: Writer, r0: int, rows: np.ndarray) -> None:
    if callable(writer):
        writer(r0, rows)
    else:
        writer[r0:r0 + rows.shape[0]] = rows


class _RollingStitcher:
    """A rolling (acc, den) window over ``tile`` scene rows on the host,
    flushed in row order as it advances; the accumulation runs in C."""

    def __init__(self, height: int, width: int, channels: int, tile: int,
                 window: np.ndarray, writer: Optional[Writer]):
        self.h, self.w, self.c, self.tile = height, width, channels, tile
        self.window = window
        self.acc = np.zeros((tile, width, channels), np.float32)
        self.den = np.zeros((tile, width, 1), np.float32)
        self.base = 0
        self.writer = writer
        self._out = None if writer is not None else np.empty(
            (height, width, channels), np.float32)

    def _emit(self, r0: int, rows: np.ndarray) -> None:
        _write_rows(self._out if self.writer is None else self.writer, r0,
                    rows)

    def advance(self, new_base: int) -> None:
        """Finalize and flush rows [base, new_base); slide the window."""
        shift = new_base - self.base
        assert 0 <= shift <= self.tile
        if shift == 0:
            return
        done = self.acc[:shift] / np.maximum(self.den[:shift], 1e-12)
        self._emit(self.base, done)
        self.acc[:self.tile - shift] = self.acc[shift:]
        self.acc[self.tile - shift:] = 0.0
        self.den[:self.tile - shift] = self.den[shift:]
        self.den[self.tile - shift:] = 0.0
        self.base = new_base

    def add(self, tile_out: np.ndarray, c0: int) -> None:
        stitch_accumulate_host(self.acc, self.den, tile_out, self.window, 0,
                               c0)

    def finish(self) -> Optional[np.ndarray]:
        self.advance(min(self.base + self.tile, self.h))
        return self._out


def stream_scene_inference(
    apply_fn: Callable,
    reader: Reader,
    scene_shape: Tuple[int, int],
    out_channels: int,
    tile: int = 512,
    overlap: int = 64,
    window: str = "hann",
    batch_size: int = 128,
    normalize: Optional[Tuple[float, float]] = (0.5, 0.5),
    writer: Optional[Writer] = None,
    n_threads: int = 4,
    channel_major_fetch: Optional[bool] = None,
    device_stitch: Optional[bool] = None,
    emit: str = "logits",
    device: DeviceLike = None,
) -> Optional[np.ndarray]:
    """Stream a scene, possibly larger than memory, through tiled
    inference on ``device`` (``None`` means ``cuda``).

    Args:
      apply_fn: the forward, ``(B, tile, tile, C_in)`` f32 on ``device``
        -> ``(B, tile, tile, out_channels)`` logits there (an engine's
        ``predict``).
      reader: the scene rows: an array sliced as ``reader[r0:r0+n]`` (an
        ``np.memmap``) or a callable ``reader(r0, n) -> (n, W[, C])``.
        uint8 input is normalized as ``(u / 255 - mean) / std`` when
        ``normalize=(mean, std)``; float input goes in as it is.
      scene_shape: (H, W) of the scene, each at least ``tile``.
      out_channels: the logit channels ``apply_fn`` returns.
      batch_size: the most tiles an engine call takes. The device stitch
        rounds it down to whole row bands, at least one, spread evenly
        over the calls (``bands_per_call``), so only the scene's last
        call carries pad tiles. The host stitch calls with
        ``batch_size`` tiles, each band's tail padded with zero tiles.
        Every call of a scene has one batch. The default is 128. On an
        "NVIDIA H100 80GB HBM3, 700.00 W" (``chip_smoke.py``'s
        ``stream`` phase), U-Net-CA base 64 int8 streamed a 16384^2
        uint8 scene (37 column tiles a band) at 996.3 tiles/s with 128
        (three bands a call, engine batch 111) and 992.9 tiles/s with 32
        (one band a call, engine batch 37), its device memory peaking at
        14.57 and 5.14 GiB.
      writer: where the finished rows go: an array assigned as
        ``writer[r0:r0+n] = rows`` (an ``np.memmap``) or a callable
        ``writer(r0, rows)``, called in ascending row order. When None,
        the scene's rows are gathered in host memory and returned.
      n_threads: host threads of the host path's uint8 normalize.
      channel_major_fetch: accepted for the JAX package's signature. The
        JAX package fetches channel-major rows to dodge the TPU's lane
        padding; the card has none, so rows are fetched channel-last
        whatever its value, with the same result.
      device_stitch: stitch on the device (default True); ``False`` takes
        the host path.
      emit: ``"logits"`` hands the writer f32 ``(n, W, out_channels)``
        rows; ``"argmax"`` (device path only) hands it uint8 ``(n, W)``
        class rows, taken on the device, so only the class rows cross to
        the host. As in the JAX package they are the argmax of the raw
        accumulated rows: the division by the per-pixel weight sum is a
        positive scale shared by the channels, but where it rounds the
        top two logits to one value the raw rows still order them, so a
        pixel in millions can differ from the argmax of the stitched
        logits (``chip_smoke.py``'s ``stream`` phase counts them).

    Returns the stitched scene when ``writer`` is None (uint8 ``(H, W)``
    with ``emit="argmax"``), else None.
    """
    h, w = scene_shape
    assert h >= tile and w >= tile, (h, w, tile)
    assert emit in ("logits", "argmax"), emit
    if device_stitch is None:
        device_stitch = True
    if device_stitch:
        return _stream_device_stitch(
            apply_fn, reader, scene_shape, out_channels, tile, overlap,
            window, batch_size, normalize, writer, emit, device)
    assert emit == "logits", "emit='argmax' needs the device-stitch path"
    dev = resolve_device(device)
    stride = tile - overlap
    row_starts = _starts(h, tile, stride)
    col_starts = _starts(w, tile, stride)
    stitcher = _RollingStitcher(h, w, out_channels, tile,
                                _np_window(tile, window), writer)

    def forward_band(band: np.ndarray) -> list:
        """Cut a (tile, W, C) band into column tiles and queue them in
        fixed-shape calls; returns the calls' outputs on the device."""
        tiles = np.stack([band[:, c0:c0 + tile] for c0 in col_starts])
        if tiles.dtype == np.uint8 and normalize is not None:
            tiles = normalize_batch_host(tiles, normalize[0], normalize[1],
                                         n_threads=n_threads)
        elif tiles.dtype != np.float32:
            tiles = tiles.astype(np.float32)
        outs = []
        for i in range(0, len(col_starts), batch_size):
            chunk = tiles[i:i + batch_size]
            valid = chunk.shape[0]
            if valid < batch_size:
                chunk = np.concatenate(
                    [chunk, np.zeros((batch_size - valid,) + chunk.shape[1:],
                                     chunk.dtype)])
            outs.append((apply_fn(torch.from_numpy(chunk).to(dev))[:valid],
                         valid))
        return outs

    def stitch_band(r0: int, outs: list) -> None:
        stitcher.advance(r0)
        j = 0
        for dev_out, valid in outs:
            arr = dev_out.to(torch.float32).cpu().numpy()
            for k in range(valid):
                stitcher.add(arr[k], col_starts[j])
                j += 1

    with torch.inference_mode():
        pending = None
        for r0 in row_starts:
            outs = forward_band(_read_band(reader, r0, tile))
            if pending is not None:
                stitch_band(*pending)  # overlaps the queued forward
            pending = (r0, outs)
        stitch_band(*pending)
    return stitcher.finish()


def _np_window(tile: int, kind: str) -> np.ndarray:
    return np.asarray(_window(tile, kind), np.float32)


def _den_states(row_starts: List[int], col_starts: List[int], tile: int,
                w: int, win: np.ndarray) -> Tuple[List[np.ndarray],
                                                  List[int]]:
    """The weight sums of the rolling window after each band, summed as
    ``stitch_tiles`` sums them: the rows the previous band left, then this
    band's windows in column order. Returns the distinct sums and, per
    band, the index of its own: bands after the first at one stride share
    one sum, so a scene has at most three."""
    states: List[np.ndarray] = []
    memo = {}
    index = []
    prev, base = None, 0
    for r0 in row_starts:
        key = (prev, r0 - base)
        if key not in memo:
            d = np.zeros((tile, w), np.float32)
            if prev is not None:
                d[:tile - (r0 - base)] = states[prev][r0 - base:]
            for c0 in col_starts:
                d[:, c0:c0 + tile] += win
            same = [i for i, e in enumerate(states) if np.array_equal(e, d)]
            if not same:
                states.append(d)
            memo[key] = same[0] if same else len(states) - 1
        prev, base = memo[key], r0
        index.append(prev)
    return states, index


def bands_per_call(n_bands: int, n_cols: int,
                   batch_size: Optional[int]) -> int:
    """The row bands of one device-stitch call: as many whole bands as
    ``batch_size`` tiles hold (at least one), lowered to the fewest that
    need no more calls, so the last call pads fewer bands than there are
    calls (19 bands at 6 a call: calls of 5, 5, 5 and 4, not 6, 6, 6 and
    1)."""
    g = min(max(1, (batch_size or n_cols) // n_cols), n_bands)
    return -(-n_bands // -(-n_bands // g))


def normalize_u8(u: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """uint8 -> f32 ``(u / 255 - mean) / std`` on ``u``'s device. The
    divisors are tensors there: a CUDA division by a host scalar is a
    multiply by its reciprocal, which rounds otherwise than the host's
    ``cli.normalize_scene``; divided this way the two are equal bit for
    bit."""
    dev = u.device
    return ((u.to(torch.float32) / f32_scalar(255.0, dev)
             - f32_scalar(mean, dev)) / f32_scalar(std, dev))


def _stream_device_stitch(
    apply_fn: Callable,
    reader: Reader,
    scene_shape: Tuple[int, int],
    out_channels: int,
    tile: int,
    overlap: int,
    window: str,
    batch_size: int,
    normalize: Optional[Tuple[float, float]],
    writer: Optional[Writer],
    emit: str = "logits",
    device: DeviceLike = None,
) -> Optional[np.ndarray]:
    """Streaming scene inference with the stitch on the device.

    Each call takes ``G`` row bands (``bands_per_call``; the last band,
    clamped to the scene's border, among them) in one engine batch ``EB =
    G * n_cols``: only the scene's last call carries pad tiles. Per call,
    on the device: the uint8 tiles are normalized (``normalize_u8``), the
    engine runs, and each
    band's column tiles times the window are added, at their column
    offsets in plan order, onto a ``(tile, W, C)`` f32 accumulator that
    starts from the rows the previous band left (no atomics: the sum order
    is fixed). When a band arrives at row ``r0``, the accumulator's rows
    above ``r0`` are final, whatever the overlap (a row may lie in more
    than two bands): they are divided by their weight sums
    (``_den_states``), or argmaxed raw, and gathered for the call. The
    host fetches them into pinned memory without blocking and waits on the
    call's event only after the next call is queued. The tiles go up from
    two alternating pinned buffers.
    """
    h, w = scene_shape
    C = out_channels
    stride = tile - overlap
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    argmax = emit == "argmax"
    row_starts = _starts(h, tile, stride)
    col_starts = _starts(w, tile, stride)
    n_cols = len(col_starts)
    win = _np_window(tile, window)
    den_np, den_index = _den_states(row_starts, col_starts, tile, w, win)

    G = bands_per_call(len(row_starts), n_cols, batch_size)
    EB = G * n_cols

    probe = _read_band(reader, 0, 1)
    is_u8 = probe.dtype == np.uint8
    do_norm = is_u8 and normalize is not None
    in_dtype = torch.uint8 if is_u8 else torch.float32

    if writer is not None:
        out = None
    else:
        out = (np.empty((h, w), np.uint8) if argmax
               else np.empty((h, w, C), np.float32))
    sink = writer if writer is not None else out

    with torch.inference_mode():
        wnd3 = torch.from_numpy(win)[:, :, None].to(dev)
        dens = [torch.from_numpy(d)[:, :, None].to(dev) for d in den_np]
        bufs = [torch.zeros((EB, tile, tile, probe.shape[-1]),
                            dtype=in_dtype, pin_memory=cuda)
                for _ in range(2)]
        uploaded = [None, None]  # each buffer's upload event
        # the rolling accumulator (scene rows [base, base + tile)) and its
        # weight sums
        acc = den = None
        base = 0

        def upload(ci: int, bands: List[int]) -> torch.Tensor:
            """Read the call's bands into pinned buffer ``ci % 2`` (once
            its previous upload is done), queue the upload and the
            normalize."""
            slot = ci % 2
            if uploaded[slot] is not None:
                uploaded[slot].synchronize()
            host = bufs[slot].numpy()
            i = 0
            for b in bands:
                band = _read_band(reader, row_starts[b], tile)
                for c0 in col_starts:
                    host[i] = band[:, c0:c0 + tile]
                    i += 1
            host[i:] = 0  # pad tiles, their logits dropped
            x = bufs[slot].to(dev, non_blocking=True)
            if cuda:
                uploaded[slot] = torch.cuda.Event()
                uploaded[slot].record()
            if do_norm:
                return normalize_u8(x, *normalize)
            return x.to(torch.float32)

        def finish_rows(raw: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
            if argmax:
                return raw.argmax(-1).to(torch.uint8)
            return raw / d

        def stitch(logits: torch.Tensor, bands: List[int],
                   last: bool) -> List[torch.Tensor]:
            """Add the call's bands to the rolling accumulator in plan
            order; returns the rows they finish, in scene order."""
            nonlocal acc, den, base
            done = []
            for g, b in enumerate(bands):
                r0 = row_starts[b]
                nxt = torch.zeros((tile, w, C), dtype=torch.float32,
                                  device=dev)
                if acc is not None:
                    s = r0 - base
                    done.append(finish_rows(acc[:s], den[:s]))
                    nxt[:tile - s] = acc[s:]
                for k, c0 in enumerate(col_starts):
                    nxt[:, c0:c0 + tile] += \
                        logits[g * n_cols + k].to(torch.float32) * wnd3
                acc, den, base = nxt, dens[den_index[b]], r0
            if last:
                done.append(finish_rows(acc, den))
            return done

        n_bands = len(row_starts)
        calls = [list(range(i, min(i + G, n_bands)))
                 for i in range(0, n_bands, G)]
        next_row = 0
        pending = None
        for ci, bands in enumerate(calls):
            logits = apply_fn(upload(ci, bands))[:len(bands) * n_cols]
            done = stitch(logits, bands, ci == len(calls) - 1)
            fetched = None
            if done:
                rows = done[0] if len(done) == 1 else torch.cat(done)
                ev = None
                if cuda:
                    rows = torch.empty(rows.shape, dtype=rows.dtype,
                                       pin_memory=True).copy_(
                                           rows, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record()
                fetched = (next_row, rows, ev)
                next_row += rows.shape[0]
            if pending is not None:
                _drain(sink, *pending)  # host IO overlaps the queued call
            pending = fetched
        if pending is not None:
            _drain(sink, *pending)
    return out


def _drain(sink: Writer, r0: int, rows: torch.Tensor, ev) -> None:
    if ev is not None:
        ev.synchronize()
    _write_rows(sink, r0, rows.numpy())
