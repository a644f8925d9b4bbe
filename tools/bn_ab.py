#!/usr/bin/env python3
"""Side-by-side timing of the DoubleConv train epilogue's reductions, K8a
``bn_stats`` and K9a ``bn_relu_grad_stats``, an earlier version against
the port's, on one NVIDIA GPU:

    PYTHONPATH=. python3 tools/bn_ab.py OLD_DIR [--plan SPEC ...] \
        [--also DIR[:SPEC] ...]

OLD_DIR holds an earlier ``bn_act.cu`` with the entry points of commit
f0056a5 (a reduce launch into a per-call workspace of S partial sums, then
a second launch that adds them: ``insarseg_bn_stats(y, bias, ws, stats, N,
HW, C, S, bf16, layout, vec, stream)`` and ``insarseg_bn_relu_grad_stats(
dy, y, bias, stats, gamma, beta, ws, gstats, N, HW, C, S, eps, bf16,
layout, vec, stream)``, S from ``kernels/bn_act.py::plan``). The script
compiles it with the port's nvcc flags; the current kernels are called
through the port's wrappers. ``--plan`` times the current kernels once
more for each SPEC, ``NAME=VALUE[,NAME=VALUE]`` of the plan's constants
in ``kernels/bn_act.py`` (``STATS_BLOCKS``, ``RED_MIN_TRIPS``, ...) set
while they run. Each ``--also`` DIR holds another version of the current
``bn_act.cu`` (the current entry points), built the same way and called
through the same wrappers, under its SPEC where one is given (the
constants it was built with: ``GROUP_LANES``, ``RED_BYTES``).

At the five levels of a U-Net-CA (base 64) train step at 512^2 b8, in bf16
channels-last (the bf16 step's layout: 4, 4, 4, 4 and 2 BatchNorms a
level) and f32 NCHW (the f32 step's), it checks every version against the
plain version (``chip_smoke.bn_compare``: f64 sums within 1e-10 of their
largest value), times the versions in turns (A B .. B A), device alone
(``chip_smoke.device_ms``: 10 calls queued behind a spin kernel, best
turn), with ``torch.batch_norm_stats`` / ``batch_norm_backward_reduce`` on
the biased t beside them, and prints each level's times beside its bytes
bound, the host us a call, the sums over the step's 18 calls and the
card's ``nvidia-smi`` line. Needs a CUDA device and nvcc; imports no JAX.

:func:`library_route` is the route the ResNet families' train-mode
BatchNorms took before K8a-K9b served them (cuDNN's ``F.batch_norm(
training=True)``, then the ReLU or the residual add and ReLU as separate
ops), kept here as a measurement only: ``chip_smoke.py``'s training phase
times the DeepLabV3-ResNet50 step through it in turns with the port's.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from chip_smoke import (PEAK_BYTES, bn_compare, bn_inputs, bn_sass_counts,
                        device_ms, nvidia_smi_line, sass_text)
from insarseg_torch.kernels import _lib
from insarseg_torch.kernels import bn_act as B
from insarseg_torch.kernels._lib import NVCC_FLAGS, _nvcc

_vp, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
# (level, BatchNorms of the level in one step)
LEVELS = ((0, 4), (1, 4), (2, 4), (3, 4), (4, 2))
FORMS = (("bfloat16", True), ("float32", False))


@contextlib.contextmanager
def library_route():
    """While open, every train-mode BatchNorm of the ResNet families
    (``ops/layers.py::bn_train``, which ``bn_act`` and ``BNSequential``
    call) runs as stock PyTorch ran it: cuDNN's ``F.batch_norm(
    training=True)``, then the ReLU, or the residual add and the ReLU,
    each its own op. One process only: the moments are this process's
    batch's."""
    import torch.nn.functional as F

    from insarseg_torch.ops import layers

    def bn_train(x, bn, mode="none", residual=None, bias=None):
        if bias is not None:
            x = x + bias.to(x.dtype)[:, None, None]
        y = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, True, bn.momentum, bn.eps)
        bn.num_batches_tracked.add_(1)
        if mode == "residual":
            y = y + residual
        return y if mode == "none" else F.relu(y)

    saved, layers.bn_train = layers.bn_train, bn_train
    try:
        yield
    finally:
        layers.bn_train = saved


def build(src: Path, so: Path) -> ctypes.CDLL:
    """``src/bn_act.cu`` compiled alone, with the port's nvcc flags."""
    so.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so),
                        str(src / "bn_act.cu")], capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout[-4000:]}"
                           f"{r.stderr[-4000:]}")
    return ctypes.CDLL(str(so))


def build_old(src: Path, out_dir: Path) -> ctypes.CDLL:
    lib = build(src, out_dir / "libbn_old.so")
    lib.insarseg_bn_stats.argtypes = [_vp] * 4 + [_ll, _ll] + [_i] * 5 \
        + [_vp]
    lib.insarseg_bn_relu_grad_stats.argtypes = [_vp] * 8 + [
        _ll, _ll, _i, _i, _f] + [_i] * 3 + [_vp]
    for fn in (lib.insarseg_bn_stats, lib.insarseg_bn_relu_grad_stats):
        fn.restype = ctypes.c_int
    return lib


def build_version(src: Path, out_dir: Path) -> ctypes.CDLL:
    """A version with the port's entry points, for the wrappers to call
    (``on_lib``)."""
    lib = build(src, out_dir / "libbn_version.so")
    for name in ("insarseg_bn_stats", "insarseg_bn_relu_grad_stats"):
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


def old_stats(lib, y, bias):
    """The earlier K8a wrapper: its plan, a workspace and a result a call."""
    n, c, h, w = y.shape
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        layout, vec, s = B.plan(y)
        stats = y.new_empty(2 * c + 1, dtype=torch.float64)
        ws = y.new_empty(s * 2 * c, dtype=torch.float64)
        rc = lib.insarseg_bn_stats(
            y.data_ptr(), bias.data_ptr(), ws.data_ptr(), stats.data_ptr(),
            n, h * w, c, s, int(y.dtype == torch.bfloat16), layout, vec,
            stream)
        if rc:
            raise RuntimeError(f"old bn_stats: CUDA error {rc}")
        return stats
    return call


def old_grad_stats(lib, dy, y, bias, stats, gamma, beta, eps=1e-5):
    n, c, h, w = y.shape
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        layout, vec, s = B.plan(y, dy)
        gstats = y.new_empty(2 * c, dtype=torch.float64)
        ws = y.new_empty(s * 2 * c, dtype=torch.float64)
        rc = lib.insarseg_bn_relu_grad_stats(
            dy.data_ptr(), y.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), ws.data_ptr(),
            gstats.data_ptr(), n, h * w, c, s, eps,
            int(y.dtype == torch.bfloat16), layout, vec, stream)
        if rc:
            raise RuntimeError(f"old bn_relu_grad_stats: CUDA error {rc}")
        return gstats
    return call


def parse_spec(spec: str) -> dict:
    """``NAME=VALUE[,NAME=VALUE]`` -> {NAME: int(VALUE)}, NAME a constant
    of ``kernels/bn_act.py``."""
    out = {}
    for item in filter(None, spec.split(",")):
        name, value = item.split("=")
        if not hasattr(B, name):
            raise ValueError(f"kernels/bn_act.py has no constant {name}")
        out[name] = int(value)
    return out


def with_plan(consts: dict, fn):
    """``fn`` with the plan's constants set to ``consts``."""
    def call():
        saved = {k: getattr(B, k) for k in consts}
        for k, v in consts.items():
            setattr(B, k, v)
        clear()
        try:
            return fn()
        finally:
            for k, v in saved.items():
                setattr(B, k, v)
            clear()
    return call


def clear():
    """Forget the plans cached under other constants."""
    B.reduce_partition.cache_clear()
    B.apply_slices.cache_clear()


def turns(calls, plain, name, reps=10):
    """Checks each call against ``plain``; times them in turns; returns
    the best device ms and the mean host us of each."""
    want = plain()
    for label, fn in calls.items():
        got = fn()
        torch.cuda.synchronize()
        try:
            bn_compare(name)(got, want)
        except AssertionError as err:
            raise AssertionError(f"{label}: {err}") from None
    names = list(calls)
    ms = {n: [] for n in names}
    host = {n: [] for n in names}
    for n in names + names[::-1]:
        d, h = device_ms(calls[n], reps)
        ms[n].append(d)
        host[n].append(h)
    return ({n: min(v) for n, v in ms.items()},
            {n: sum(v) / len(v) for n, v in host.items()})


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("old_dir")
    parser.add_argument("--plan", nargs="*", default=[])
    parser.add_argument("--also", nargs="*", default=[])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    tmp = tempfile.TemporaryDirectory(prefix="bn_ab-")
    old = build_old(Path(args.old_dir), Path(tmp.name))
    versions, built = {}, {}
    for i, arg in enumerate(args.also):
        d, _, spec = arg.partition(":")
        if d not in built:
            built[d] = build_version(Path(d), Path(tmp.name) / str(i))
        versions[Path(d).name + (f"@{spec}" if spec else "")] = (
            built[d], parse_spec(spec))
    _lib.load_library()
    libs = {"old": Path(tmp.name) / "libbn_old.so",
            "new": Path(_lib.build_info["dir"]) / _lib.LIB_NAME}
    libs.update({Path(d).name: Path(lib._name)
                 for d, lib in built.items()})
    for label, path in libs.items():
        for kernel, ops in bn_sass_counts(sass_text(path)).items():
            if "reduce_n" in kernel:
                print(f"SASS {label} {kernel}: {ops}", flush=True)
    for label, lib in [("new", _lib._lib)] + [(Path(d).name, lib)
                                              for d, lib in built.items()]:
        fn = lib.insarseg_bn_kernel_info
        fn.argtypes, fn.restype = [_i, _vp], _i
        for k, what in enumerate(("K8a bf16 channels-last",
                                  "K9a bf16 channels-last")):
            out = (_i * 6)()
            if fn(k, out) == 0:
                print(f"resources {label} {what}: {out[0]} registers, "
                      f"{out[1]} spill bytes, {out[3]} blocks an SM",
                      flush=True)
    dev = torch.device("cuda")
    power = nvidia_smi_line()
    print(f"K8a / K9a, earlier against current, device ms (best turn) and "
          f"host us a call, on {power}", flush=True)
    totals = {}
    for dtype, cl in FORMS:
        for level, sites in LEVELS:
            c, hw = 64 * 2 ** level, 512 >> level
            a = bn_inputs(dev, 8, c, hw, hw, dtype, cl, 90 + level)
            y, bias, gamma, beta, dy = (a["y"], a["bias"], a["gamma"],
                                        a["beta"], a["dout"])
            stats = B.bn_stats(y, bias)
            t = y + bias.to(y.dtype)[:, None, None]
            mean, invstd = torch.batch_norm_stats(t, 1e-5)
            cases = {
                "bn_stats": (
                    {"old": old_stats(old, y, bias),
                     "new": lambda: B.bn_stats(y, bias)},
                    lambda: B.bn_stats_plain(y, bias),
                    lambda: torch.batch_norm_stats(t, 1e-5), 1),
                "bn_relu_grad_stats": (
                    {"old": old_grad_stats(old, dy, y, bias, stats, gamma,
                                           beta),
                     "new": lambda: B.bn_relu_grad_stats(
                         dy, y, bias, stats, gamma, beta, 1e-5)},
                    lambda: B.bn_relu_grad_stats_plain(
                        dy, y, bias, stats, gamma, beta, 1e-5),
                    lambda: torch.batch_norm_backward_reduce(
                        dy, t, mean, invstd, gamma, True, True, True), 2),
            }
            for name, (calls, plain, library, reads) in cases.items():
                for label, (lib, consts) in versions.items():
                    calls[label] = with_plan(consts,
                                             on_lib(lib, calls["new"]))
                for spec in args.plan:
                    calls[f"new@{spec}"] = with_plan(parse_spec(spec),
                                                     calls["new"])
                best, host = turns(calls, plain, name)
                best["library"] = device_ms(library, 10)[0]
                host["library"] = 0.0
                nbytes = reads * y.numel() * y.element_size() + 16 * c
                bms = nbytes / PEAK_BYTES * 1e3
                tag = (f"{name} {dtype} {'channels-last' if cl else 'NCHW'}"
                       f" level {level} ({c}x{hw}x{hw})")
                print(f"{tag}: bound {bms:.4f}  " + "  ".join(
                    f"{n} {v:.4f} ({100 * bms / v:.0f}%, {host[n]:.0f} us)"
                    for n, v in best.items()), flush=True)
                tot = totals.setdefault((name, dtype), {"bound": 0.0})
                tot["bound"] += sites * bms
                for n, v in best.items():
                    tot[n] = tot.get(n, 0.0) + sites * v
            del a, y, dy, t, stats
            torch.cuda.empty_cache()
    print("over the step's 18 BatchNorms (ms; share of the bound):",
          flush=True)
    for (name, dtype), tot in totals.items():
        bms = tot.pop("bound")
        print(f"  {name} {dtype}: bound {bms:.4f}  " + "  ".join(
            f"{n} {v:.4f} ({100 * bms / v:.0f}%)" for n, v in tot.items()),
            flush=True)
    print(power, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
