#!/usr/bin/env python3
"""Host cost of the ResNet families' train-mode BatchNorm on K8a-K9b, on
one NVIDIA GPU:

    python3 tools/bn_host.py [--root DIR ...] [--out FILE]

Each ``--root`` is a checkout of the repo (default: this one); the
script imports the port from each in its own process, in turns (the
roots in order, then in reverse), so two versions of the wrappers are
compared within one call. For each root it reads, on the DeepLabV3-
ResNet50 train step at f32 128^2 b8 (``chip_smoke.resnet_train_step``;
Adam, TF32 off), a size where the step waits on the host:

- ms a step through K8a-K9b and through the library route they replaced
  (``tools/bn_ab.py::library_route``: cuDNN's ``F.batch_norm`` with
  separate ReLU and add passes), in turns (kernels, library, library,
  kernels; 5 steps a turn, CUDA events, the best turn of each);
- the host us of one BatchNorm site, forward and backward, at the step's
  layer4 map (8, 512, 16, 16) f32 NCHW in the ``relu`` mode: through
  ``ops/layers.py::bn_train`` and through the library route, and of each
  K8a-K9b wrapper called alone on the same arguments, and of its bare
  ``ctypes`` entry point on prebuilt arguments (each the mean over 400
  calls after 50, the card kept busy ahead by no more than the calls
  themselves: their device time is a fraction of the host's);
- a ``cProfile`` of 5 kernel-route steps: the functions with the most
  own time, per call and a step.

Prints one JSON line per root and writes the profiles to ``--out``
(default ``chiprun_out/bn_host.txt``). Needs a CUDA device and nvcc;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SITE = (8, 512, 16, 16)
CALLS, WARM = 400, 50


def host_us(fn, sync) -> float:
    import time

    for _ in range(WARM):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    t = time.perf_counter() - t0
    sync()
    return t / CALLS * 1e6


def site_costs(dev) -> dict:
    """Host us of one BatchNorm site and of its four wrappers."""
    import torch
    from torch import nn

    from insarseg_torch.kernels import _lib
    from insarseg_torch.kernels import bn_act as B
    from insarseg_torch.ops import layers
    from tools.bn_ab import library_route

    torch.manual_seed(0)
    bn = nn.BatchNorm2d(SITE[1]).to(dev).train()
    y = torch.randn(SITE, device=dev, requires_grad=True)
    g = torch.randn(SITE, device=dev)

    def site():
        layers.bn_train(y, bn, "relu").backward(g)

    out = {"sync": torch.cuda.synchronize}
    res = {"site_kernels": host_us(site, out["sync"])}
    with library_route():
        res["site_library"] = host_us(site, out["sync"])
    yd = y.detach()
    stats = B.bn_stats(yd, None)
    o = B.bn_apply_relu(yd, None, stats, bn.weight, bn.bias,
                        bn.running_mean, bn.running_var, bn.eps, 0.1)
    gs = B.bn_relu_grad_stats(g, yd, None, stats, bn.weight, bn.bias, bn.eps)
    calls = {
        "bn_stats": lambda: B.bn_stats(yd, None),
        "bn_apply_relu": lambda: B.bn_apply_relu(
            yd, None, stats, bn.weight, bn.bias, bn.running_mean,
            bn.running_var, bn.eps, 0.1),
        "bn_relu_grad_stats": lambda: B.bn_relu_grad_stats(
            g, yd, None, stats, bn.weight, bn.bias, bn.eps),
        "bn_relu_grad_apply": lambda: B.bn_relu_grad_apply(
            g, yd, None, stats, gs, bn.weight, bn.bias, bn.eps),
    }
    for k, fn in calls.items():
        res[k] = host_us(fn, out["sync"])
    # the bare entry point of K8b on the arguments its wrapper built
    captured = []
    real = B.launch
    B.launch = lambda *a: captured.append(a)
    try:
        calls["bn_apply_relu"]()
    finally:
        B.launch = real
    _, fn_name, *args = captured[0]
    entry = getattr(_lib.load_library(), fn_name)
    res["bn_apply_relu_entry"] = host_us(lambda: entry(*args), out["sync"])
    del o
    return res


def one_root(out_path: Path) -> dict:
    import contextlib
    import cProfile
    import io
    import pstats

    import torch

    import chip_smoke as cs
    from tools.bn_ab import library_route

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    state, step, x, m = cs.resnet_train_step(dev, "deeplabv3", "none", 128,
                                             8, "float32")
    routes = {"kernels": contextlib.nullcontext, "library": library_route}
    for route in routes.values():
        with route():
            step(state, x, m)
    ms = {r: [] for r in routes}
    for r in ("kernels", "library", "library", "kernels"):
        with routes[r]():
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(5):
                step(state, x, m)
            e1.record()
            torch.cuda.synchronize()
        ms[r].append(e0.elapsed_time(e1) / 5)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(5):
        step(state, x, m)
    torch.cuda.synchronize()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(30)
    with open(out_path, "a") as f:
        f.write(f"== {os.environ.get('BN_HOST_ROOT')}: cProfile of 5 "
                "kernel-route steps, DeepLabV3 f32 128^2 b8\n")
        f.write(text.getvalue())
    del state, step, x, m
    torch.cuda.empty_cache()
    return {"step_ms": {r: min(v) for r, v in ms.items()}, "turns": ms,
            "host_us": site_costs(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=[])
    ap.add_argument("--out", default=str(HERE / "chiprun_out" /
                                         "bn_host.txt"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(one_root(Path(args.out))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bn_host: no CUDA device", file=sys.stderr)
        return 1
    roots = [str(Path(r).resolve()) for r in args.root] or [str(HERE)]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    results = {r: [] for r in roots}
    for r in roots + roots[::-1]:
        env = dict(os.environ, PYTHONPATH=f"{r}:{HERE}", BN_HOST_ROOT=r)
        p = subprocess.run([sys.executable, __file__, "--child", "--out",
                            args.out], env=env, cwd=r, capture_output=True,
                           text=True)
        if p.returncode != 0:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            return p.returncode
        results[r].append(json.loads(p.stdout.strip().splitlines()[-1]))
    for r, runs in results.items():
        print(json.dumps({"root": r, "card": power, "runs": runs}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
