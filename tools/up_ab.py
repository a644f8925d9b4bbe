#!/usr/bin/env python3
"""Side-by-side timing of the U-Net up-path kernel K6 (``up_concat_i8``),
an earlier version against the port's, on one NVIDIA GPU:

    PYTHONPATH=. python3 tools/up_ab.py OLD_DIR [DIR ...]

OLD_DIR holds an earlier ``up_i8.cu`` (with the ``requant_i8.cuh`` it
includes) with the entry point of commit 478e63b: the same arguments as the
port's, but the weight as (Cin, taps * Cout), the transpose of the port's
``pack_up_weight``. Take it from git: ``git archive 478e63b
insarseg_torch/csrc`` unpacked into a gitignored directory such as
``_tree/``. Each further DIR holds a version of the current ``up_i8.cu``
(with the headers it includes), which takes the port's weight layout. The
script compiles each with the port's nvcc flags; the port's kernel is
called through its wrapper (``insarseg_torch.kernels``).

On the K6 calls of one int8 forward of each U-Net main path (512^2 tiles,
batch 8, seeded random weights as ``chip_smoke.py`` makes them: U-Net-CA in
H-s2d, U-Net-SA, U-Net-fast-CA) and on one tie-heavy call (``cat_s`` 0.5,
z about N(0, 20^2), at up3's shape), it checks every version against the
plain version (the earlier one must be equal; for the others the share of
differing codes is printed), then times them in turns (old, the DIRs, the
port's, then back; device alone by ``chip_smoke.device_ms``, 10 calls a
turn, best turn) beside ``F.conv_transpose2d`` bf16 on the same input and
the call's bound. It prints each call, the sums over one forward
of each path, and the card's ``nvidia-smi`` line. Needs a CUDA device and
nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from insarseg_torch import kernels as K
from insarseg_torch.kernels._lib import NVCC_FLAGS, _SIGNATURES, _nvcc
from insarseg_torch.models import unet_int8

PATHS = (("unet", "channel", "U-Net-CA"), ("unet", "spatial", "U-Net-SA"),
         ("unet-fast", "channel", "U-Net-fast-CA"))


def build(src: Path, out_dir: Path):
    """Compile ``src/up_i8.cu`` into a library; return its entry point."""
    so = out_dir / "libup.so"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so),
                        str(src / "up_i8.cu")], capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout[-4000:]}"
                           f"{r.stderr[-4000:]}")
    fn = ctypes.CDLL(str(so)).insarseg_up_concat_i8
    fn.argtypes = list(_SIGNATURES["insarseg_up_concat_i8"])
    fn.restype = ctypes.c_int
    return fn


def entry_call(fn, a, transpose):
    """A callable that runs a built version on the wrapper's arguments
    ``a`` (with ``transpose``, the weight transposed once, here, for the
    earlier layout)."""
    y, w, bias, skip = a["y"], a["w"], a["bias"], a["skip"]
    rt = 1 if a["s2d"] else 2
    b, h, wd, cin = y.shape
    n = w.shape[0]
    wt = w.t().contiguous() if transpose else w
    out = torch.empty(skip.shape[:3] + (skip.shape[-1] + n // (2 * rt),),
                      dtype=torch.int8, device=y.device)

    def run():
        rc = fn(y.data_ptr(), wt.data_ptr(),
                None if bias is None else bias.data_ptr(), skip.data_ptr(),
                out.data_ptr(), b * h * wd, cin, n, n // (2 * rt), wd,
                skip.shape[-1], rt, float(a["cat_s"]),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"K6 version: launch failed, CUDA error {rc}")
        return out
    return run


def tie_case(dev):
    """up3's shape (b8, 128^2 x 256 -> 128 x 4) with z about N(0, 20^2)
    and ``cat_s`` 0.5: a quarter of the bf16 z lie on the ties of
    z / cat_s."""
    gen = torch.Generator().manual_seed(cs.SEED + 7)
    b, h, w, cin, cout = 8, 128, 128, 256, 128
    y = (torch.randn((b, h, w, cin), generator=gen) * 20).to(torch.bfloat16)
    k = torch.randn((2, 2, cin, cout), generator=gen) / np.sqrt(cin)
    skip = torch.randint(-127, 128, (b, 2 * h, 2 * w, 128), generator=gen,
                         dtype=torch.int8)
    bias = (torch.randn(cout, generator=gen) * 0.5).to(torch.bfloat16)
    return {"y": y.to(dev), "w": K.pack_up_weight(k).to(dev),
            "bias": bias.to(dev), "skip": skip.to(dev), "cat_s": 0.5,
            "s2d": False}


def main(argv) -> int:
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="up_ab-")
    built = []
    for i, d in enumerate(argv):
        out_dir = Path(tmp.name) / str(i)
        out_dir.mkdir()
        built.append((d, build(Path(d), out_dir)))
    K.load_library()
    power_line = cs.nvidia_smi_line()
    images = cs.smooth_batch(np.random.default_rng(cs.SEED + 2), cs.BATCH,
                             cs.HW, cs.HW)
    cases = []
    for name, attention, label in PATHS:
        model = cs.build_model(name, attention)
        rng = np.random.default_rng(cs.SEED + 1)
        calib = [cs.smooth_batch(rng, 4, cs.HW, cs.HW) for _ in range(2)]
        engine = cs.build_engines(dev, name, attention, model, calib,
                                  full=False)["int8"]
        calls = cs.record_calls(unet_int8, ["up_concat_i8"], engine, images)
        cases += [(label, a) for a in calls["up_concat_i8"]]
        del engine, model
    cases.append(("ties", tie_case(dev)))

    names = ["old"] + [f"dir{i}" for i in range(1, len(built))] + ["new"]
    sums = {}
    print(f"{'path':14s} {'call':44s} "
          + " ".join(f"{n:>9s}" for n in names)
          + f" {'library':>9s} {'bound':>8s}  differing codes (new)",
          flush=True)
    for label, a in cases:
        c = cs.kernel_cases({"up_concat_i8": [a]}, label)["up_concat_i8"][0]
        want = c["plain"]()
        runs = [entry_call(fn, a, i == 0) for i, (_, fn) in enumerate(built)]
        runs.append(c["kernel"])
        if not torch.equal(runs[0](), want):
            raise AssertionError(f"{label} {c['shape']}: the old kernel "
                                 "differs from the plain version")
        for d, run in zip(argv[1:], runs[1:-1]):
            dmax, share = K.assert_up_codes_close(
                run(), want, a["skip"].shape[-1], 1.0)
            print(f"  {d}: {share:.3e} of the codes differ (max |d| "
                  f"{dmax})", flush=True)
        dmax, share = K.assert_up_codes_close(
            c["kernel"](), want, a["skip"].shape[-1], 1.0)
        del want
        times = [[] for _ in runs]
        order = list(range(len(runs)))
        for i in order + order[::-1]:
            times[i].append(cs.device_ms(runs[i], reps=10)[0])
        best = [min(t) for t in times]
        t_lib = cs.device_ms(c["lib"], reps=10)[0]
        t_bound = cs.bound(c["ops"], c["bytes"], c["peak"])[0]
        print(f"{label:14s} {c['shape']:44s} "
              + " ".join(f"{t:9.4f}" for t in best)
              + f" {t_lib:9.4f} {t_bound:8.4f}  {share:.3e} (max |d| "
              f"{dmax})", flush=True)
        sm = sums.setdefault(label, [0.0] * (len(best) + 2))
        for i, t in enumerate(best + [t_lib, t_bound]):
            sm[i] += t
        torch.cuda.empty_cache()
    for label, sm in sums.items():
        t_new, t_lib, t_bound = sm[-3], sm[-2], sm[-1]
        print(f"sum {label}: "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in zip(names, sm))
              + f" (old / new {sm[0] / t_new:.2f}x), library {t_lib:.4f} "
              f"ms, bound {t_bound:.4f} ms ({100 * t_bound / t_new:.1f}% "
              "of it for new)", flush=True)
    print(f"card: {power_line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
