"""Sliding-window split and overlap stitching for full-scene inference
(counterpart of the in-memory half of ``insarseg/data/stitch.py``).

- ``plan_tiles``: the static tile grid for (H, W, tile, overlap), the last
  tile of each axis clamped flush to the border;
- ``extract_tiles``: the (N, tile, tile, C) tile batch of a scene;
- ``stitch_tiles``: weighted overlap-add of per-tile logits (Hann window
  with a 1e-3 floor, or uniform), accumulated tile by tile in plan order
  as the JAX ``lax.scan`` does, then divided by the summed weights;
- ``sliding_window_inference``: tiles -> chunked forward (the tail chunk
  zero-padded to the chunk size) -> stitch;
- ``sliding_window_inference_batched``: S same-shaped scenes through one
  stream of fixed-size forward chunks over their shared tile plan, each
  chunk added into the scenes' accumulator before the next is gathered.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from insarseg_torch.device import DeviceLike, resolve_device


def tile_starts(n: int, tile: int, stride: int) -> List[int]:
    """Tile origins along one axis: stride-spaced, the last clamped flush."""
    s = list(range(0, n - tile + 1, stride))
    if s[-1] != n - tile:
        s.append(n - tile)
    return s


def plan_tiles(h: int, w: int, tile: int,
               overlap: int) -> List[Tuple[int, int]]:
    """Static (row, col) origins covering (h, w) with the given overlap."""
    if not 0 <= overlap < tile:
        raise ValueError(f"need 0 <= overlap < tile, got {(tile, overlap)}")
    if h < tile or w < tile:
        raise ValueError(f"scene {(h, w)} is smaller than the tile {tile}")
    stride = tile - overlap
    return [(r, c) for r in tile_starts(h, tile, stride)
            for c in tile_starts(w, tile, stride)]


def _window(tile: int, kind: str) -> np.ndarray:
    if kind == "uniform":
        return np.ones((tile, tile), np.float32)
    if kind == "hann":
        # no exact zeros at the borders, so edge tiles keep full coverage
        w1 = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(tile) + 0.5) / tile)
        w = np.outer(w1, w1).astype(np.float32)
        return np.maximum(w, 1e-3)
    raise KeyError(f"unknown window {kind!r}")


def extract_tiles(scene: torch.Tensor, coords: Sequence[Tuple[int, int]],
                  tile: int) -> torch.Tensor:
    """(H, W, C) scene -> (N, tile, tile, C) tile batch."""
    return torch.stack([scene[r:r + tile, c:c + tile] for r, c in coords])


def stitch_tiles(tiles: torch.Tensor, coords: Sequence[Tuple[int, int]],
                 out_hw: Tuple[int, int],
                 window: str = "hann") -> torch.Tensor:
    """(N, tile, tile, C) -> (H, W, C) weighted overlap-add."""
    n, t, _, c = tiles.shape
    if n != len(coords):
        raise ValueError(f"{n} tiles but {len(coords)} coordinates")
    w = torch.as_tensor(_window(t, window), device=tiles.device)[:, :, None]
    acc = torch.zeros(tuple(out_hw) + (c,), dtype=torch.float32,
                      device=tiles.device)
    den = torch.zeros(tuple(out_hw) + (1,), dtype=torch.float32,
                      device=tiles.device)
    for tile_i, (r, cc) in zip(tiles, coords):
        acc[r:r + t, cc:cc + t] += tile_i.to(torch.float32) * w
        den[r:r + t, cc:cc + t] += w
    return (acc / den).to(tiles.dtype)


def _chunked_forward(apply_fn: Callable, tiles: torch.Tensor,
                     batch_size: Optional[int]) -> torch.Tensor:
    """Run ``apply_fn`` over the tile batch in fixed-size chunks (the tail
    chunk is zero-padded, so every call sees one shape)."""
    n = tiles.shape[0]
    bs = batch_size or n
    outs = []
    for i in range(0, n, bs):
        chunk = tiles[i:i + bs]
        pad = bs - chunk.shape[0]
        if pad:
            chunk = torch.cat([chunk,
                               chunk.new_zeros((pad,) + chunk.shape[1:])])
            outs.append(apply_fn(chunk)[: bs - pad])
        else:
            outs.append(apply_fn(chunk))
    return torch.cat(outs)


def sliding_window_inference(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    scene,
    tile: int = 512,
    overlap: int = 64,
    window: str = "hann",
    batch_size: Optional[int] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Full-scene logits via tiled forward + overlap stitch, on ``device``
    (``None`` means ``cuda``).

    apply_fn: batched forward, (B, tile, tile, C_in) -> (B, tile, tile,
    C_out), e.g. an engine's ``predict``. scene: (H, W, C_in)."""
    scene = torch.as_tensor(scene, device=resolve_device(device))
    h, w, _ = scene.shape
    # scenes smaller than the tile in either axis: zero-pad up, crop back
    pad_h, pad_w = max(0, tile - h), max(0, tile - w)
    if pad_h or pad_w:
        scene = F.pad(scene, (0, 0, 0, pad_w, 0, pad_h))
    ph, pw = scene.shape[:2]
    coords = plan_tiles(ph, pw, tile, overlap)
    logits = _chunked_forward(apply_fn, extract_tiles(scene, coords, tile),
                              batch_size)
    out = stitch_tiles(logits, coords, (ph, pw), window)
    return out[:h, :w] if (pad_h or pad_w) else out


def sliding_window_inference_batched(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    scenes,
    tile: int = 512,
    overlap: int = 64,
    window: str = "hann",
    batch_size: Optional[int] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Multi-scene sliding-window inference, ``(S, H, W, C_in) -> (S, H,
    W, C_out)``, on ``device`` (``None`` means ``cuda``).

    The scenes share one tile plan, so their S x N tiles form one stream
    of ``batch_size``-tile forward chunks (scene-major, plan order): the
    card stays filled whatever a scene's tile count. The tail chunk is
    padded by repeating its last tile index, and the repeats are left out
    of the overlap-add. Each chunk is added into the f32 accumulator
    before the next is gathered, so the peak memory is the (S, H, W,
    C_out) accumulator plus one chunk. Every scene's tiles are added in
    plan order onto its own slice, so each result equals
    :func:`sliding_window_inference` of that scene alone, bit for bit."""
    scenes = torch.as_tensor(scenes, device=resolve_device(device))
    s, h, w, _ = scenes.shape
    pad_h, pad_w = max(0, tile - h), max(0, tile - w)
    if pad_h or pad_w:
        scenes = F.pad(scenes, (0, 0, 0, pad_w, 0, pad_h))
    ph, pw = scenes.shape[1:3]
    coords = plan_tiles(ph, pw, tile, overlap)
    n = len(coords)
    total = s * n
    bs = batch_size or total
    wnd = torch.as_tensor(_window(tile, window),
                          device=scenes.device)[:, :, None]
    flat = [(k // n,) + coords[k % n] for k in range(total)]
    acc = den = out_dtype = None
    for i in range(0, total, bs):
        chunk = flat[i:i + bs]
        valid = len(chunk)
        chunk = chunk + [chunk[-1]] * (bs - valid)
        logits = apply_fn(torch.stack(
            [scenes[si, r:r + tile, c:c + tile] for si, r, c in chunk]))
        if acc is None:
            out_dtype = logits.dtype
            acc = torch.zeros((s, ph, pw, logits.shape[-1]),
                              dtype=torch.float32, device=scenes.device)
            den = torch.zeros((s, ph, pw, 1), dtype=torch.float32,
                              device=scenes.device)
        for lg, (si, r, c) in zip(logits[:valid], chunk[:valid]):
            acc[si, r:r + tile, c:c + tile] += lg.to(torch.float32) * wnd
            den[si, r:r + tile, c:c + tile] += wnd
    out = (acc / den).to(out_dtype)
    return out[:, :h, :w] if (pad_h or pad_w) else out
