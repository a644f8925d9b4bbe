"""The native host data path (counterpart of
``insarseg/data/native_loader.py``): ctypes bindings of the port's own
``csrc/tileops.cpp`` and a prefetching loader.

- :func:`lib` builds ``csrc/tileops.cpp`` at first use with
  ``g++ -O3 -shared -fPIC`` into ``insarseg_torch/_build/tileops-<key>/``
  (``<key>`` hashes the source and the flags; the source tree is never
  written) and loads it. Unlike the JAX package's ``lib()``, which returns
  None on any failure, it raises: a run that asked for the native path
  gets it or stops.
- :class:`NativeVOCSegDataset`: ``data/voc.py::VOCSegDataset`` with the
  normalize and mask conversions in C (one fused pass); PIL still decodes
  and resizes. Its images are the JAX package's native loader's bit for
  bit; they are within an f32 ulp or two of the Python path's
  ``(x / 255 - mean) / std``, since C computes ``x * a + b``.
- :func:`normalize_batch_host`, :func:`stitch_accumulate_host`: a
  threaded u8 -> f32 batch conversion and the host overlap-add.
- :class:`PrefetchLoader`: a background thread and a bounded queue over
  any batch iterable, so host decoding overlaps the card's steps.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from insarseg_torch.data.voc import VOCSegDataset

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG / "csrc" / "tileops.cpp"
BUILD_ROOT = PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libtileops.so"

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _build(final: Path) -> None:
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp / LIB_NAME),
                            str(SOURCE)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n"
                               f"{r.stdout}{r.stderr}")
        try:
            os.replace(tmp, final)
        except OSError:  # another process finished the same build first
            if not (final / LIB_NAME).is_file():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def lib() -> ctypes.CDLL:
    """Build (once) and load the native library; raises if either
    fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        h.update(SOURCE.read_bytes())
        final = BUILD_ROOT / f"tileops-{h.hexdigest()[:16]}"
        if not (final / LIB_NAME).is_file():
            _build(final)
        L = ctypes.CDLL(str(final / LIB_NAME))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        L.normalize_u8.argtypes = [u8p, f32p, ctypes.c_int64,
                                   ctypes.c_float, ctypes.c_float]
        L.mask_legacy.argtypes = [u8p, i32p, ctypes.c_int64]
        L.mask_index.argtypes = [u8p, i32p, ctypes.c_int64]
        L.normalize_batch.argtypes = [ctypes.POINTER(u8p), f32p,
                                      ctypes.c_int32, ctypes.c_int64,
                                      ctypes.c_float, ctypes.c_float,
                                      ctypes.c_int32]
        L.stitch_accumulate.argtypes = [f32p, f32p] \
            + [ctypes.c_int64] * 3 + [f32p, f32p] + [ctypes.c_int64] * 3
        for fn in (L.normalize_u8, L.mask_legacy, L.mask_index,
                   L.normalize_batch, L.stitch_accumulate):
            fn.restype = None
        _LIB = L
        return L


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeVOCSegDataset(VOCSegDataset):
    """:class:`~insarseg_torch.data.voc.VOCSegDataset` with the normalize
    and mask conversions in C (``raw_u8`` images ship as bytes and are
    normalized on the device instead). Builds the library when made."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lib = lib()

    def __getitem__(self, idx: int):
        if self.raw_u8:
            return super().__getitem__(idx)
        u8, mu8 = (np.ascontiguousarray(a) for a in self.read_u8(idx))
        s = self.image_size
        x = np.empty((s, s), np.float32)
        self._lib.normalize_u8(_ptr(u8, ctypes.c_uint8),
                               _ptr(x, ctypes.c_float), u8.size,
                               ctypes.c_float(self.mean),
                               ctypes.c_float(self.std))
        m = np.empty((s, s), np.int32)
        fn = (self._lib.mask_legacy if self.mask_contract == "legacy"
              else self._lib.mask_index)
        fn(_ptr(mu8, ctypes.c_uint8), _ptr(m, ctypes.c_int32), mu8.size)
        return x[..., None], m


def normalize_batch_host(u8_batch: np.ndarray, mean: float = 0.5,
                         std: float = 0.5, n_threads: int = 4) -> np.ndarray:
    """A (B, ...) uint8 batch -> normalized f32, one fused threaded pass in
    C."""
    u8_batch = np.ascontiguousarray(u8_batch, np.uint8)
    b = u8_batch.shape[0]
    out = np.empty(u8_batch.shape, np.float32)
    if b == 0:
        return out
    L = lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    srcs = (u8p * b)(*(u8_batch[i].ctypes.data_as(u8p) for i in range(b)))
    L.normalize_batch(srcs, _ptr(out, ctypes.c_float), b,
                      u8_batch.size // b, ctypes.c_float(mean),
                      ctypes.c_float(std), ctypes.c_int32(n_threads))
    return out


class PrefetchLoader:
    """A background thread prefetching up to ``depth`` batches of any
    batch iterable. A worker's error reaches the consumer at the batch it
    failed on; a consumer that stops early drains the queue so the thread
    ends with the iterator."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        end = object()
        err = []
        stop = threading.Event()

        def worker():
            try:
                for batch in self.loader:
                    if stop.is_set():
                        return
                    q.put(batch)
            except BaseException as e:  # handed to the consumer
                err.append(e)
            finally:
                q.put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        raised = closed = False
        try:
            while True:
                item = q.get()
                if item is end:
                    if err:
                        raised = True
                        raise err[0]
                    return
                yield item
        except GeneratorExit:
            # an early close (a calibration peek): the consumer never asked
            # for a batch that failed, so its error is reported, not raised
            closed = True
            raise
        finally:
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            if err and not raised:
                if closed:
                    print("PrefetchLoader: worker error on a prefetched "
                          f"batch after early close (ignored): {err[0]!r}",
                          file=sys.stderr)
                else:
                    raise err[0]


def stitch_accumulate_host(acc: np.ndarray, den: np.ndarray,
                           tile: np.ndarray, window: np.ndarray, r0: int,
                           c0: int) -> None:
    """``acc[r0:r0+t, c0:c0+t] += tile * window`` and ``den`` += window, in
    place, in C. ``acc`` (H, W, C) and ``den`` (H, W, 1) contiguous
    float32; ``tile`` (t, t, C), ``window`` (t, t)."""
    for name, a in (("acc", acc), ("den", den)):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            raise ValueError(f"{name} must be a contiguous float32 array")
    h, w, c = acc.shape
    t = tile.shape[0]
    if den.shape != (h, w, 1) or tile.shape != (t, t, c) \
            or window.shape != (t, t) or not (0 <= r0 <= h - t
                                              and 0 <= c0 <= w - t):
        raise ValueError("stitch_accumulate_host: shapes or offsets do not "
                         "fit the accumulator")
    tile = np.ascontiguousarray(tile, np.float32)
    window = np.ascontiguousarray(window, np.float32)
    lib().stitch_accumulate(_ptr(acc, ctypes.c_float),
                            _ptr(den, ctypes.c_float), h, w, c,
                            _ptr(tile, ctypes.c_float),
                            _ptr(window, ctypes.c_float), t, r0, c0)
