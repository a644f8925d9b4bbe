"""K2 ``se_squeeze_i8`` + ``se_excite_i8``: the int8 squeeze-excite tail.

Replaces the SE tail of ``insarseg/models/unet_int8.py::_dc_i8``. Kernels:
``insarseg_torch/csrc/se_i8.cu``. The MLP between squeeze and excite stays
in torch (``insarseg_torch.models.unet_int8._dc_i8``).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from insarseg_torch.kernels._lib import (
    check_cuda,
    device_guard,
    launch,
    stream_of,
)

_SQUEEZE_THREADS = 256
_SQUEEZE_UNROLL = 8          # 16-byte loads a thread keeps in flight
_TARGET_BLOCKS = 4 * 132     # a wave of 4 blocks on each of the 132 SMs
_MAX_SPLITS = 64             # partial sums the last block adds a channel
# per (device, stream): the last-block reduction's counters (zero between
# launches: each launch's last blocks reset theirs) and partial-sum scratch
_WORK: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _check_channels(c: int) -> None:
    if c % 16 or c > 16 * _SQUEEZE_THREADS:
        raise ValueError(
            f"SE kernels take C % 16 == 0 and C <= 4096 channels, got {c}")


@functools.lru_cache(maxsize=None)
def squeeze_plan(b: int, hw: int, c: int):
    """The squeeze kernel's grid for (b, hw, c) codes: ``(cg, splits,
    per)``.

    A block sums ``cg`` channels (a divisor of ``c`` up to 256, as wide
    as possible, so that 16-byte loads of neighbouring threads fill whole
    cache lines, but narrower, down to 32, where a small batch would leave
    the grid short of blocks) over ``per`` pixels of one image, ``splits``
    blocks an (image, channel group). ``per`` is a whole number of the block's load batches
    (``256 / (cg / 16)`` pixel lanes x ``_SQUEEZE_UNROLL``) where the image
    has that many pixels. The grid fills the card (about ``_TARGET_BLOCKS``
    blocks) while the last block's sum stays short (at most
    ``_MAX_SPLITS`` partial sums a channel)."""
    nvc = c // 16
    divs = [d for d in range(16, 0, -1) if nvc % d == 0]
    divs = [d for d in divs if d >= 2] or divs
    nv = next((d for d in divs
               if b * (nvc // d) * _MAX_SPLITS >= _TARGET_BLOCKS // 2),
              divs[-1])
    cg, groups = 16 * nv, nvc // nv
    batch = _SQUEEZE_THREADS // nv * _SQUEEZE_UNROLL  # pixels a batch
    batches = -(-hw // batch)
    target = max(1, min(-(-_TARGET_BLOCKS // (b * groups)), _MAX_SPLITS))
    per = -(-batches // target) * batch
    return cg, -(-hw // per), per


def _workspace(dev: torch.device, stream: int, n_counters: int,
               n_scratch: int):
    key = (dev.index, stream)
    counters, scratch = _WORK.get(key, (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 1024), dtype=torch.int32,
                               device=dev)
    if scratch is None or scratch.numel() < n_scratch:
        scratch = torch.empty(max(n_scratch, 1 << 18), dtype=torch.int32,
                              device=dev)
    _WORK[key] = counters, scratch
    return counters, scratch


def se_squeeze_i8_plain(q: torch.Tensor) -> torch.Tensor:
    return q.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32)


def se_squeeze_i8(q: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) int8 codes -> (B, C) int32 per-channel sums (exact)."""
    if q.device.type == "cpu":
        return se_squeeze_i8_plain(q)
    if q.device.type != "cuda":
        raise ValueError(f"se_squeeze_i8: unsupported device {q.device}")
    b, h, w, c = q.shape
    _check_channels(c)
    check_cuda("q", q, torch.int8, q.device)
    hw = h * w
    if hw * 128 >= 2 ** 31:
        raise ValueError(f"se_squeeze_i8: {hw} pixels may overflow an int32 "
                         "sum")
    sums = torch.empty((b, c), dtype=torch.int32, device=q.device)
    if sums.numel() == 0 or hw == 0:
        return sums.zero_()
    cg, splits, per = squeeze_plan(b, hw, c)
    with device_guard(q.device):
        stream = stream_of(q)
        counters = scratch = 0
        if splits > 1:
            ct, st = _workspace(q.device, stream, b * (c // cg),
                                b * c * splits)
            counters, scratch = ct.data_ptr(), st.data_ptr()
        launch("se_squeeze_i8", "insarseg_se_squeeze_i8", q.data_ptr(),
               sums.data_ptr(), scratch, counters, b, hw, c, cg, splits, per,
               stream)
    return sums


def se_excite_i8_plain(q: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    g = gain[:, None, None, :]
    if gain.dtype == torch.bfloat16:
        return q.to(torch.bfloat16) * g
    return torch.round(q.to(torch.float32) * g).clamp_(-127, 127) \
        .to(torch.int8)


def se_excite_i8(q: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) int8 codes x (B, C) gain. An f32 gain gives int8 codes
    ``clip(rint(q * gain), ±127)``; a bf16 gain gives bf16 ``q * gain``."""
    if q.device.type == "cpu":
        return se_excite_i8_plain(q, gain)
    if q.device.type != "cuda":
        raise ValueError(f"se_excite_i8: unsupported device {q.device}")
    b, h, w, c = q.shape
    _check_channels(c)
    bf16 = gain.dtype == torch.bfloat16
    check_cuda("q", q, torch.int8, q.device)
    check_cuda("gain", gain, torch.bfloat16 if bf16 else torch.float32,
               q.device)
    if gain.shape != (b, c):
        raise ValueError(f"gain must have shape {(b, c)}, got "
                         f"{tuple(gain.shape)}")
    out = torch.empty(q.shape, device=q.device,
                      dtype=torch.bfloat16 if bf16 else torch.int8)
    with torch.cuda.device(q.device):
        launch("se_excite_i8", "insarseg_se_excite_i8", q.data_ptr(),
               gain.data_ptr(), out.data_ptr(), q.numel() // 16, h * w * c,
               c, int(bf16), stream_of(q))
    return out
