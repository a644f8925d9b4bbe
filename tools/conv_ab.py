#!/usr/bin/env python3
"""A/B of versions of the int8 convolution kernel K5a on one NVIDIA GPU.

Each argument names a directory holding a version of ``conv_i8.cu`` and the
headers it includes (``igemm_i8.cuh`` and, in the current one,
``gmma_sm90.cuh``; ``insarseg_torch/csrc`` is the current one).
The script compiles each into its own library with the port's nvcc flags,
then, at the shapes the main paths give the kernel (512^2 tiles, batch 8)
and two ragged ones, checks each version's output against the plain
version (a version that computes something else, kept to see where the
time goes, is reported as differing and timed all the same) and times the
versions in turns (A B ... B A, twice; CUDA events over 10 launches; the
best turn is printed), on the same tensors in one process:

    PYTHONPATH=. python3 tools/conv_ab.py insarseg_torch/csrc other/ [DIR:64]

``DIR:64`` runs that directory's version with 64-wide N tiles whatever
``tile_n`` picks. Needs a CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from insarseg_torch.kernels import conv_i8_plain, repack_conv_weight, tile_n
from insarseg_torch.kernels._lib import NVCC_FLAGS, _nvcc

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = [_vp] * 6 + [_i] * 12 + [_f, _f, _i, _i, _vp]

SHAPES = (  # b, h, w, cin, cout, k, stride, dilation, exit, identity
    (8, 256, 512, 256, 128, 3, 1, 1, 0, 0),   # U-Net-CA H-s2d level 1
    (8, 512, 512, 128, 64, 3, 1, 1, 0, 0),    # U-Net-SA level 1
    (8, 512, 512, 16, 64, 3, 1, 1, 0, 0),     # inc.c1, Cin 1 padded
    (8, 256, 512, 16, 128, 3, 1, 1, 0, 0),    # inc.c1 in H-s2d, Cin 2
    (8, 512, 512, 64, 64, 3, 1, 1, 0, 0),
    (8, 64, 64, 2048, 512, 3, 1, 1, 2, 0),    # FCN head, bf16 exit
    (8, 64, 64, 2048, 256, 3, 1, 12, 0, 0),   # ASPP branch
    (8, 64, 64, 1024, 512, 3, 1, 1, 0, 0),
    (8, 32, 32, 1024, 1024, 3, 1, 1, 0, 0),
    (8, 64, 64, 256, 1024, 1, 1, 1, 0, 1),    # conv3 + int8 identity
    (8, 64, 64, 256, 1024, 1, 1, 1, 0, 0),
    (8, 128, 128, 64, 256, 1, 1, 1, 0, 1),
    (8, 128, 128, 64, 256, 1, 1, 1, 0, 2),    # conv3 + f32 identity
    (8, 64, 64, 1024, 256, 1, 1, 1, 0, 0),
    (8, 64, 64, 2048, 512, 1, 1, 1, 0, 0),
    (8, 64, 64, 512, 2048, 1, 1, 1, 0, 1),
    (3, 7, 9, 40, 2, 3, 1, 1, 0, 2),          # ragged
    (2, 13, 11, 96, 192, 3, 2, 1, 2, 1),      # ragged, stride 2
)


def build(src: Path, out_dir: Path):
    """Compile ``src/conv_i8.cu`` into a library; return its entry point."""
    so = out_dir / "libconv.so"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so),
                        str(src / "conv_i8.cu")], capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout[-4000:]}"
                           f"{r.stderr[-4000:]}")
    fn = ctypes.CDLL(str(so)).insarseg_conv_i8
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def main(argv) -> int:
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    versions = []
    tmp = tempfile.TemporaryDirectory(prefix="conv_ab-")
    for i, arg in enumerate(argv):
        src, _, bn = arg.partition(":")
        out_dir = Path(tmp.name) / str(i)
        out_dir.mkdir()
        versions.append((arg, build(Path(src), out_dir), int(bn or 0)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"{'shape':40s} " + " ".join(f"{v[0][-12:]:>12s}" for v in versions)
          + "   TOP/s (best)", flush=True)
    for b, h, w, cin, cout, k, st, dil, ex, ik in SHAPES:
        cin16 = -(-cin // 16) * 16
        x = torch.zeros((b, h, w, cin16), dtype=torch.int8, device=dev)
        x[..., :cin] = torch.randint(-127, 128, (b, h, w, cin), device=dev,
                                     generator=gen, dtype=torch.int8)
        wt = repack_conv_weight(torch.randint(
            -127, 128, (k, k, cin, cout), device=dev, generator=gen,
            dtype=torch.int8))
        pad = dil * (k - 1) // 2
        ho = (h + 2 * pad - dil * (k - 1) - 1) // st + 1
        wo = (w + 2 * pad - dil * (k - 1) - 1) // st + 1
        mult = torch.rand(cout, device=dev, generator=gen) * 1e-4
        off = torch.randn(cout, device=dev, generator=gen)
        idn, in_s = None, None
        if ik == 1:
            idn, in_s = torch.randint(-127, 128, (b, ho, wo, cout),
                                      device=dev, generator=gen,
                                      dtype=torch.int8), 0.3
        elif ik == 2:
            idn = torch.randn((b, ho, wo, cout), device=dev, generator=gen)
        out_s = 0.5 if ex == 0 else None
        want = conv_i8_plain(x, wt, mult, off, st, dil, True, out_s, idn,
                             in_s, ex == 2)
        calls = []
        for name, fn, bn in versions:
            out = torch.empty(want.shape, dtype=want.dtype, device=dev)
            args = (x.data_ptr(), wt.data_ptr(), mult.data_ptr(),
                    off.data_ptr(), 0 if idn is None else idn.data_ptr(),
                    out.data_ptr(), b, h, w, cin16, ho, wo, cout, k, st, dil,
                    1, ik, 1.0 if in_s is None else in_s,
                    1.0 if out_s is None else out_s, ex, bn or tile_n(cout))
            calls.append(lambda fn=fn, args=args: fn(
                *args, torch.cuda.current_stream().cuda_stream))
            rc = calls[-1]()
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")
            if not torch.equal(out, want):
                bad = int((out.double() != want.double()).sum())
                print(f"  {name}: differs from the plain version at "
                      f"{bad} of {out.numel()}", flush=True)
        times = [[] for _ in versions]
        order = list(range(len(versions)))
        for i in (order + order[::-1]) * 2:
            calls[i]()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(10):
                calls[i]()
            e1.record()
            torch.cuda.synchronize()
            times[i].append(e0.elapsed_time(e1) / 10)
        best = [min(t) for t in times]
        ops = 2.0 * b * ho * wo * cin * cout * k * k
        tag = f"b{b} {h}x{w} {cin}->{cout} k{k} s{st} d{dil} e{ex} i{ik}"
        print(f"{tag:40s} " + " ".join(f"{t:12.4f}" for t in best)
              + f"   {ops / min(best) / 1e9:9.1f}", flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
