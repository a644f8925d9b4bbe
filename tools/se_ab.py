#!/usr/bin/env python3
"""Side-by-side timing of the SE kernels K2 squeeze and K5b, an earlier
version against the port's, on one NVIDIA GPU:

    PYTHONPATH=. python3 tools/se_ab.py OLD_DIR [DIR ...]

OLD_DIR holds an earlier ``se_i8.cu`` and ``block_i8.cu`` with the entry
points of commit 249cd37 (its squeeze adds into a zeroed (B, C) result:
``x, sums, B, HW, C, splits, pix_per_block, stream``; its K5b takes the
arguments the port's still takes). The script compiles them into one
library with the port's nvcc flags. The current kernels are called through
the port's wrappers (``insarseg_torch.kernels``). Each further DIR holds
versions of the current ``se_i8.cu`` and ``block_i8.cu`` (with the
``.cuh`` they include), built the same way and called through the same
wrappers.

At the shapes one int8 forward of each main path gives the two kernels
(512^2 tiles, batch 8: U-Net-CA in H-s2d, FCN-ResNet50-CA,
DeepLabV3-ResNet50), at the batch-1 squeeze of a scene's last chunk and at
one 16-channel pixel (the floor of a launch), it checks every version
against the plain version and times the versions in turns (A B C C B A),
device alone (``chip_smoke.device_ms``: 10 calls queued behind a spin
kernel, best turn), on the same tensors in one process. It prints each
call's times beside its bytes bound, the host us a call (the old squeeze's
host path is only its launch and the zeroing of its result), the sums over
one forward of each main path and the card's ``nvidia-smi`` line. Needs a
CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from chip_smoke import PEAK_BYTES, device_ms, nvidia_smi_line
from insarseg_torch import kernels as K
from insarseg_torch.kernels import _lib
from insarseg_torch.kernels._lib import NVCC_FLAGS, _nvcc

_vp, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)

# (b, h, w, c): the calls of one int8 forward of each main path
SQUEEZE = (  # shape, calls a forward {path: n}
    ((8, 256, 512, 128), {"U-Net-CA": 2}),
    ((8, 256, 256, 128), {"U-Net-CA": 2}),
    ((8, 128, 128, 256), {"U-Net-CA": 2, "FCN-CA": 3}),
    ((8, 64, 64, 512), {"U-Net-CA": 2, "FCN-CA": 4}),
    ((8, 32, 32, 1024), {"U-Net-CA": 1}),
    ((8, 64, 64, 1024), {"FCN-CA": 6}),
    ((8, 64, 64, 2048), {"FCN-CA": 3, "DeepLabV3": 1}),
    ((1, 256, 512, 128), {}),  # a scene's last chunk of one tile
    ((1, 1, 1, 16), {}),  # the floor: one launch that reads 16 bytes
)
RESIDUAL = (  # shape, identity, calls a forward of FCN-CA
    ((8, 128, 128, 256), "f32", 1), ((8, 128, 128, 256), "s8", 2),
    ((8, 64, 64, 512), "f32", 1), ((8, 64, 64, 512), "s8", 3),
    ((8, 64, 64, 1024), "f32", 1), ((8, 64, 64, 1024), "s8", 5),
    ((8, 64, 64, 2048), "f32", 1), ((8, 64, 64, 2048), "s8", 2),
    ((1, 1, 1, 16), "s8", 0),  # the floor
)


def build_old(src: Path, out_dir: Path) -> ctypes.CDLL:
    so = out_dir / "libse_old.so"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so),
                        str(src / "se_i8.cu"), str(src / "block_i8.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout[-4000:]}"
                           f"{r.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    lib.insarseg_se_squeeze_i8.argtypes = [_vp, _vp, _i, _i, _i, _i, _i, _vp]
    lib.insarseg_se_residual_i8.argtypes = [_vp, _vp, _vp, _vp, _ll, _ll, _i,
                                            _i, _f, _f, _vp]
    for fn in (lib.insarseg_se_squeeze_i8, lib.insarseg_se_residual_i8):
        fn.restype = ctypes.c_int
    return lib


def build_new(src: Path, out_dir: Path) -> ctypes.CDLL:
    """A version with the port's entry points, loaded as the port loads
    its library (``_lib.load_library``), for the wrappers to call."""
    so = out_dir / "libse_new.so"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so),
                        str(src / "se_i8.cu"), str(src / "block_i8.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout[-4000:]}"
                           f"{r.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    for name in ("insarseg_se_squeeze_i8", "insarseg_se_residual_i8"):
        getattr(lib, name).argtypes = list(_lib._SIGNATURES[name])
        getattr(lib, name).restype = ctypes.c_int
    return lib


def on_lib(lib, fn):
    """``fn`` with the port's wrappers launching from ``lib``."""
    def call():
        saved, _lib._lib = _lib._lib, lib
        try:
            return fn()
        finally:
            _lib._lib = saved
    return call


def old_squeeze(lib, q):
    """The earlier wrapper: a zeroed result and its grid."""
    b, h, w, c = q.shape
    hw = h * w
    ppi = 256 // (c // 16)
    splits = max(1, min(-(-4 * 132 // b), -(-hw // ppi)))
    per = -(-hw // splits)
    splits = -(-hw // per)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        sums = torch.zeros((b, c), dtype=torch.int32, device=q.device)
        rc = lib.insarseg_se_squeeze_i8(q.data_ptr(), sums.data_ptr(), b, hw,
                                        c, splits, per, stream)
        if rc:
            raise RuntimeError(f"old squeeze: CUDA error {rc}")
        return sums
    return call


def old_residual(lib, y3q, gate, idn, in_s, out_s):
    b, h, w, c = y3q.shape
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        out = torch.empty_like(y3q)
        rc = lib.insarseg_se_residual_i8(
            y3q.data_ptr(), gate.data_ptr(), idn.data_ptr(), out.data_ptr(),
            y3q.numel() // 16, h * w * c, c, int(idn.dtype == torch.float32),
            1.0 if in_s is None else in_s, out_s, stream)
        if rc:
            raise RuntimeError(f"old se_residual: CUDA error {rc}")
        return out
    return call


def turns(calls, plain, reps=10):
    """Checks each call against ``plain``; times them in turns; returns
    the best device ms and the mean host us of each."""
    want = plain()
    for name, fn in calls.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from the plain version")
    names = list(calls)
    ms = {n: [] for n in names}
    host = {n: [] for n in names}
    for n in names + names[::-1]:
        d, h = device_ms(calls[n], reps)
        ms[n].append(d)
        host[n].append(h)
    return ({n: min(v) for n, v in ms.items()},
            {n: sum(v) / len(v) for n, v in host.items()})


def report(tag, nbytes, best, host):
    bms = nbytes / PEAK_BYTES * 1e3
    fast = min(best.values())
    print(f"{tag:28s} bound {bms:.4f}  "
          + "  ".join(f"{n} {t:.4f} ({h:.0f} us)"
                      for (n, t), h in zip(best.items(), host.values()))
          + f"  best at {100 * bms / fast:.0f}% of the bound", flush=True)


def main(argv) -> int:
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    tmp = tempfile.TemporaryDirectory(prefix="se_ab-")
    old = build_old(Path(argv[0]), Path(tmp.name))
    others = {}
    for i, d in enumerate(argv[1:]):
        (Path(tmp.name) / str(i)).mkdir()
        others[Path(d).name] = build_new(Path(d), Path(tmp.name) / str(i))
    K.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print("K2 squeeze: device ms (best turn) and host us a call", flush=True)
    sums = {}
    for shape, per_path in SQUEEZE:
        q = torch.randint(-128, 128, shape, device=dev, generator=gen,
                          dtype=torch.int8)
        calls = {"old": old_squeeze(old, q),
                 "new": lambda q=q: K.se_squeeze_i8(q)}
        for name, lib in others.items():
            calls[name] = on_lib(lib, lambda q=q: K.se_squeeze_i8(q))
        best, host = turns(calls, lambda q=q: K.se_squeeze_i8_plain(q))
        report("b{} {}x{}x{}".format(*shape), q.numel() + 4 * shape[0]
               * shape[3], best, host)
        for path, n in per_path.items():
            for v, t in best.items():
                key = ("squeeze", path, v)
                sums[key] = sums.get(key, 0.0) + n * t
        del q
    print("K5b se_residual_i8: device ms (best turn) and host us a call",
          flush=True)
    for shape, kind, n in RESIDUAL:
        y3q = torch.randint(-127, 128, shape, device=dev, generator=gen,
                            dtype=torch.int8)
        gate = torch.rand(shape[0], shape[3], device=dev, generator=gen) \
            * 0.05
        if kind == "s8":
            idn, in_s = torch.randint(-127, 128, shape, device=dev,
                                      generator=gen, dtype=torch.int8), 0.02
        else:
            idn, in_s = torch.randn(shape, device=dev, generator=gen) * 3, \
                None
        args = (y3q, gate, idn, in_s, 0.03)
        calls = {"old": old_residual(old, *args),
                 "new": lambda args=args: K.se_residual_i8(*args)}
        for name, lib in others.items():
            calls[name] = on_lib(lib, lambda args=args:
                                 K.se_residual_i8(*args))
        best, host = turns(calls,
                           lambda args=args: K.se_residual_i8_plain(*args))
        report("b{} {}x{}x{} +{}".format(*shape, kind),
               y3q.numel() * (2 + idn.element_size()) + gate.numel() * 4,
               best, host)
        for v, t in best.items():
            key = ("residual", "FCN-CA", v)
            sums[key] = sums.get(key, 0.0) + n * t
        del y3q, gate, idn
    print("sums over one int8 forward (ms):", flush=True)
    for (kernel, path, v), t in sorted(sums.items()):
        print(f"  {kernel:9s} {path:10s} {v:11s} {t:.4f}", flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
