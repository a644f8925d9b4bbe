#!/usr/bin/env python3
"""Smoke run of the insarseg_torch port on one NVIDIA GPU (an H100 SXM).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and exits non-zero, printing no result, without
one. It imports the port only (no JAX, nothing of ``insarseg``) and:

1. builds the hand-written kernels from ``insarseg_torch/csrc`` (nvcc for
   sm_90a, into ``insarseg_torch/_build/``) and prints the build time and
   the card's name and power limit;
2. holds every kernel to its plain PyTorch version on the card, exactly,
   at fixed shapes (K1 at Cin 1/64/1024 x 512^2/128^2/32^2 with both exits,
   K2 at 512^2x64 and 32^2x1024 with both exits, K3 at 512^2x64), then at
   the shapes and on the tensors of one int8 U-Net-CA forward (512^2, b8),
   timing each kernel, its plain version, a PyTorch reference call where
   one exists, and computing each call's bound;
3. drives the main path at full width — U-Net-CA (base 64, 1 -> 2
   classes) with seeded random weights through ``make_engine`` 'module'
   (f32), 'serve' (f32 and bf16 input) and 'int8' (calibrated on two
   seeded 512^2 batches), each serving batches of eight 512^2 tiles, and a
   1024^2 scene through ``sliding_window_inference`` on the int8 engine —
   with the launch counters set to 0 just before and read just after;
4. checks the outputs: serve f32 within 1e-3 x max|logit| of module f32
   (TF32 off), int8 logits correlated > 0.98 with serve's, 18 / 9 / 9 / 4
   launches of K1 / K2 squeeze / K2 excite / K3 per int8 forward, the int8
   engine on the card against the same tree on the CPU (plain versions),
   a finite (1024, 1024, 2) scene;
5. prints the kernel table as one JSON line, the ``nvidia-smi`` name and
   power-limit line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

PEAK_OPS = 1979e12    # H100 SXM dense int8 tensor-core rate, operations/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth, bytes/s
BATCH, HW, BASE = 8, 512, 64
SEED = 0


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def same(a, b) -> float:
    """max |a - b| (as f64); raises unless the tensors are equal."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    if not torch.equal(a, b):
        raise AssertionError(f"kernel != plain version (max abs err {err})")
    return err


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def conv_case(gen, b, h, w, cin, cout, bf16_exit, dev):
    import torch
    from insarseg_torch.kernels import repack_conv_weight
    from insarseg_torch.ops.quant import quant_weight

    q = torch.from_numpy(quant_weight(
        np.random.default_rng(cin * 7 + cout).normal(
            0, 1, (3, 3, cin, cout)))["q"])
    x = torch.randint(-127, 128, (b, h, w, cin), generator=gen,
                      dtype=torch.int8).to(dev)
    acc_sd = 127.0 * 127.0 * np.sqrt(9 * cin) / 3
    mult = (torch.rand(cout, generator=gen) + 0.5) * (60 / acc_sd)
    off = torch.randn(cout, generator=gen) * 10
    return (x, repack_conv_weight(q).to(dev), mult.to(dev), off.to(dev),
            None if bf16_exit else 1.0)


def check_fixed_shapes(dev) -> None:
    import torch
    from insarseg_torch import kernels as K

    gen = torch.Generator().manual_seed(SEED)
    for cin in (1, 64, 1024):
        for hw in (512, 128, 32):
            for bf16_exit in (False, True):
                cout = 1024 if hw == 32 else 64
                args = conv_case(gen, 1, hw, hw, cin, cout, bf16_exit, dev)
                same(K.conv3x3_i8(*args), K.conv3x3_i8_plain(*args))
    log("K1 int8_conv3x3_epilogue == plain at Cin 1/64/1024 x "
        "512^2/128^2/32^2, int8 and bf16 exits")
    for hw, c in ((512, 64), (32, 1024)):
        q = torch.randint(-127, 128, (2, hw, hw, c), generator=gen,
                          dtype=torch.int8).to(dev)
        same(K.se_squeeze_i8(q), K.se_squeeze_i8_plain(q))
        for dt in (torch.float32, torch.bfloat16):
            gain = (torch.rand((2, c), generator=gen) * 2).to(dt).to(dev)
            same(K.se_excite_i8(q, gain), K.se_excite_i8_plain(q, gain))
    log("K2 se_squeeze_i8 / se_excite_i8 == plain at 512^2x64 and "
        "32^2x1024, int8 and bf16 exits")
    q = torch.randint(-128, 128, (2, 512, 512, 64), generator=gen,
                      dtype=torch.int8).to(dev)
    same(K.maxpool2x2_i8(q), K.maxpool2x2_i8_plain(q))
    log("K3 maxpool2x2_i8 == plain at 512^2x64")
    torch.cuda.synchronize()


def record_calls(predict, images):
    """One int8 forward with the kernel wrappers recording their
    arguments: the tensors the main path gives each kernel."""
    from insarseg_torch.models import unet_int8 as M

    calls = {"conv": [], "squeeze": [], "excite": [], "pool": []}
    orig = {n: getattr(M, n) for n in ("conv3x3_i8", "se_squeeze_i8",
                                       "se_excite_i8", "maxpool2x2_i8")}

    def rec(key, fn):
        def wrapped(*args):
            calls[key].append(args)
            return fn(*args)
        return wrapped

    M.conv3x3_i8 = rec("conv", orig["conv3x3_i8"])
    M.se_squeeze_i8 = rec("squeeze", orig["se_squeeze_i8"])
    M.se_excite_i8 = rec("excite", orig["se_excite_i8"])
    M.maxpool2x2_i8 = rec("pool", orig["maxpool2x2_i8"])
    try:
        predict(images)
    finally:
        for n, fn in orig.items():
            setattr(M, n, fn)
    return calls


def time_main_path_kernels(calls):
    """Per call: equal to the plain version, kernel / plain / library ms
    and the bound. Returns the kernel table (sums over one forward)."""
    import torch
    import torch.nn.functional as F
    from insarseg_torch import kernels as K

    def row(name, source, replaces, cases):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "lib": 0.0}
        err, by_time = 0.0, {"bytes": 0.0, "operations": 0.0}
        has_lib = True
        for c in cases:
            err = max(err, same(c["kernel"](), c["plain"]()))
            ms = cuda_ms(c["kernel"], reps=5)
            pms = cuda_ms(c["plain"], reps=2)
            bms, by = bound(c["ops"], c["bytes"])
            lms = None if c["lib"] is None else cuda_ms(c["lib"], reps=5)
            log(f"  {name} {c['shape']}: {ms:.4f} ms, plain {pms:.4f} ms, "
                f"library {'-' if lms is None else f'{lms:.4f}'} ms, "
                f"bound {bms:.4f} ms ({by})")
            tot["ms"] += ms
            tot["plain_ms"] += pms
            tot["bound_ms"] += bms
            by_time[by] += bms
            if lms is None:
                has_lib = False
            else:
                tot["lib"] += lms
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": None,
                "max_abs_err": err, "ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": max(by_time, key=by_time.get),
                "library_ms": tot["lib"] if has_lib else None,
                "calls_per_forward": len(cases)}

    conv_cases = []
    for x, w, mult, off, out_s in calls["conv"]:
        b, h, wd, cin = x.shape
        cout = w.shape[0]
        out_bytes = b * h * wd * cout * (2 if out_s is None else 1)
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)  # channels-last
        wb = w[..., :cin].permute(0, 3, 1, 2).to(torch.bfloat16)
        conv_cases.append({
            "shape": f"b{b} {h}x{wd} {cin}->{cout}",
            "kernel": lambda a=(x, w, mult, off, out_s): K.conv3x3_i8(*a),
            "plain": lambda a=(x, w, mult, off, out_s):
                K.conv3x3_i8_plain(*a),
            "lib": lambda xb=xb, wb=wb: F.conv2d(xb, wb, padding=1),
            "ops": 2.0 * b * h * wd * cin * cout * 9,
            "bytes": x.numel() + 9 * cin * cout + 8 * cout + out_bytes})
    sq_cases = [{
        "shape": f"b{q.shape[0]} {q.shape[1]}x{q.shape[2]}x{q.shape[3]}",
        "kernel": lambda q=q: K.se_squeeze_i8(q),
        "plain": lambda q=q: K.se_squeeze_i8_plain(q),
        "lib": lambda q=q: torch.sum(q, dim=(1, 2), dtype=torch.int32),
        "ops": float(q.numel()),
        "bytes": q.numel() + 4 * q.shape[0] * q.shape[3]}
        for (q,) in calls["squeeze"]]
    ex_cases = [{
        "shape": f"b{q.shape[0]} {q.shape[1]}x{q.shape[2]}x{q.shape[3]} "
                 f"-> {'bf16' if g.dtype == torch.bfloat16 else 'int8'}",
        "kernel": lambda q=q, g=g: K.se_excite_i8(q, g),
        "plain": lambda q=q, g=g: K.se_excite_i8_plain(q, g),
        "lib": None,
        "ops": 2.0 * q.numel(),
        "bytes": q.numel() * (3 if g.dtype == torch.bfloat16 else 2)
        + g.numel() * g.element_size()}
        for q, g in calls["excite"]]
    pool_cases = []
    for (q,) in calls["pool"]:
        b, h, w, c = q.shape
        pool_cases.append({
            "shape": f"b{b} {h}x{w}x{c}",
            "kernel": lambda q=q: K.maxpool2x2_i8(q),
            "plain": lambda q=q: K.maxpool2x2_i8_plain(q),
            "lib": lambda q=q, s=(b, h // 2, 2, w // 2, 2, c):
                torch.amax(q.view(s), dim=(2, 4)),
            "ops": 3.0 * q.numel() / 4,
            "bytes": q.numel() * 1.25})
    src, rep = "insarseg_torch/csrc/", "insarseg/models/unet_int8.py:"
    return [
        row("int8_conv3x3_epilogue", src + "int8_conv3x3.cu", rep + "287",
            conv_cases),
        row("se_squeeze_i8", src + "se_i8.cu", rep + "299", sq_cases),
        row("se_excite_i8", src + "se_i8.cu", rep + "303", ex_cases),
        row("maxpool2x2_i8", src + "maxpool2x2_i8.cu", rep + "322",
            pool_cases),
    ]


# ---------------------------------------------------------------------------
# 3. the main path
# ---------------------------------------------------------------------------

def random_state_dict(model, seed: int):
    """Seeded random weights in the reference state_dict's shapes: He-normal
    convs, random BN affines and running statistics (var > 0)."""
    import torch

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            a = np.zeros(shape, np.int64)
        elif k.endswith("running_mean"):
            a = rng.normal(0, 0.1, shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif len(shape) == 1 and k.endswith(".weight"):  # BN gamma
            a = rng.uniform(0.8, 1.2, shape)
        elif k.endswith(".bias"):
            a = rng.normal(0, 0.1 if len(shape) == 1 else 0.01, shape)
        elif k.startswith("up"):  # ConvTranspose2d (I, O, 2, 2)
            a = rng.normal(0, np.sqrt(1.0 / shape[0]), shape)
        else:  # Conv2d (O, I, kh, kw) or Linear (O, I)
            fan_in = int(np.prod(shape[1:]))
            a = rng.normal(0, np.sqrt(2.0 / fan_in), shape)
        sd[k] = torch.as_tensor(np.asarray(a, dtype=np.float32
                                           if a.dtype != np.int64
                                           else np.int64))
    return sd


def smooth_batch(rng, b, h, w):
    """Seeded smooth NHWC images (f32): coarse noise, bilinear upsampled."""
    import torch
    import torch.nn.functional as F

    coarse = torch.from_numpy(rng.standard_normal(
        (b, 1, h // 8, w // 8)).astype(np.float32))
    x = F.interpolate(coarse, size=(h, w), mode="bilinear",
                      align_corners=False)
    return x.permute(0, 2, 3, 1).contiguous().numpy()


def build_engines(dev, base=BASE, hw=HW, calib_batch=4):
    import torch
    from insarseg_torch.engines import make_engine
    from insarseg_torch.models.unet import UNet

    model = UNet(num_classes=2, base_features=base, use_se=True)
    model.load_state_dict(random_state_dict(model, SEED), strict=True)
    rng = np.random.default_rng(SEED + 1)
    calib = [smooth_batch(rng, calib_batch, hw, hw) for _ in range(2)]
    engines = {
        "module f32": make_engine("unet", "channel", model, None, "module",
                                  device=dev),
        "serve f32": make_engine("unet", "channel", model, None, "serve",
                                 device=dev),
        "serve bf16-input": make_engine("unet", "channel", model, None,
                                        "serve", device=dev,
                                        input_dtype=torch.bfloat16),
        "int8": make_engine("unet", "channel", model, None, "int8",
                            calib_batches=calib, device=dev),
    }
    return model, calib, engines


def serve_and_check(engines, images, dev, timed: bool, power_line: str):
    """Each engine serves the batch; returns its logits. Checks the
    agreement bars; with ``timed`` prints tiles/s per engine."""
    import torch

    out = {}
    for name, predict in engines.items():
        y = predict(images)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[name] = y.float().cpu().numpy()
        if not np.isfinite(out[name]).all():
            raise AssertionError(f"{name}: non-finite logits")
        if timed:
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                predict(images)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            log(f"  {name}: {reps * images.shape[0] / dt:.2f} tiles/s "
                f"({images.shape[1]}^2, b{images.shape[0]}) on "
                f"{power_line}")
    ref = out["module f32"]
    scale = float(np.abs(ref).max())
    err = float(np.abs(out["serve f32"] - ref).max())
    log(f"  serve f32 vs module f32: max abs err {err:.3g}, "
        f"{err / scale:.3g} x max|logit| ({scale:.4g})")
    if err > 1e-3 * scale:
        raise AssertionError("serve f32 differs from module f32")
    agree = float(np.mean(out["serve bf16-input"].argmax(-1)
                          == out["serve f32"].argmax(-1)))
    log(f"  serve bf16-input vs serve f32: argmax agreement {agree:.5f}")
    corr = float(np.corrcoef(out["int8"].ravel(),
                             out["serve f32"].ravel())[0, 1])
    agree8 = float(np.mean(out["int8"].argmax(-1)
                           == out["serve f32"].argmax(-1)))
    log(f"  int8 vs serve f32: logit correlation {corr:.5f}, argmax "
        f"agreement {agree8:.5f}")
    if not corr > 0.98:
        raise AssertionError(f"int8 logit correlation {corr} <= 0.98")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on "
              "one NVIDIA GPU", file=sys.stderr)
        return 2
    from insarseg_torch import kernels as K
    from insarseg_torch.data.stitch import sliding_window_inference
    from insarseg_torch.models.unet_int8 import (
        make_int8_predict_fn,
        pack_unet_int8,
        prepare_int8,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # 1. build
    K.load_library()
    info = K.build_info
    log(f"kernels built in {info['seconds']:.2f} s "
        f"({'cached' if info['cached'] else 'fresh build'}) into "
        f"{info['dir']}")
    with open(info["log"]) as f:
        for line in f:
            if "registers" in line or "spill" in line or "==" in line:
                log("  " + line.rstrip())
    power_line = nvidia_smi_line()
    log(f"card: {power_line}")

    # 2a. kernels against their plain versions at fixed shapes
    check_fixed_shapes(dev)

    # 3a. the engines at full width (packing launches no kernel)
    model, calib, engines = build_engines(dev)
    rng = np.random.default_rng(SEED + 2)
    images = smooth_batch(rng, BATCH, HW, HW)

    # 2b. each kernel on the tensors of one int8 forward (512^2, b8)
    log("kernels at the main path's shapes (one int8 forward, 512^2 b8):")
    calls = record_calls(engines["int8"], images)
    table = time_main_path_kernels(calls)
    del calls
    torch.cuda.empty_cache()

    # 3b. the main path, counters from 0
    K.reset_launches()
    log(f"main path: U-Net-CA base {BASE}, {HW}^2, b{BATCH}")
    serve_and_check(engines, images, dev, timed=True, power_line=power_line)
    before = dict(K.LAUNCHES)
    engines["int8"](images)
    per_forward = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    log(f"  launches in one int8 forward: {per_forward}")
    want = {"int8_conv3x3_epilogue": 18, "se_squeeze_i8": 9,
            "se_excite_i8": 9, "maxpool2x2_i8": 4}
    if per_forward != want:
        raise AssertionError(f"launches per forward {per_forward} != {want}")
    scene = smooth_batch(np.random.default_rng(SEED + 3), 1, 1024, 1024)[0]
    t0 = time.perf_counter()
    out = sliding_window_inference(engines["int8"], scene, tile=512,
                                   overlap=64, batch_size=BATCH, device=dev)
    torch.cuda.synchronize()
    log(f"  1024^2 scene (tile 512, overlap 64) through int8: "
        f"{time.perf_counter() - t0:.3f} s, shape {tuple(out.shape)}")
    if tuple(out.shape) != (1024, 1024, 2) or \
            not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("scene output is not a finite (1024, 1024, 2)")
    launches = dict(K.LAUNCHES)
    log(f"  launches on the main path: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched")
    for row in table:
        row["launches"] = launches[row["name"]]

    # 4. the same int8 tree on the CPU (plain versions) on a small input
    tree = pack_unet_int8(model.state_dict(), [c[:1, :64, :64] for c in calib],
                          device=dev)
    x_small = images[:2, :64, :64]
    gpu = make_int8_predict_fn(prepare_int8(tree, dev))(x_small)
    cpu = make_int8_predict_fn(prepare_int8(tree, "cpu"))(x_small)
    # the kernels are exact against their plain versions (phase 2); what
    # differs here is the bf16 transposed convs and head (cuDNN vs CPU)
    g, c = gpu.float().cpu().numpy(), cpu.float().numpy()
    rel = float(np.abs(g - c).max() / np.abs(c).max())
    corr = float(np.corrcoef(g.ravel(), c.ravel())[0, 1])
    agree = float(np.mean(g.argmax(-1) == c.argmax(-1)))
    log(f"int8 engine, card vs CPU plain versions (64^2, b2): max rel err "
        f"{rel:.3g}, logit correlation {corr:.6f}, argmax agreement "
        f"{agree:.5f}")
    if corr < 0.999 or agree < 0.995:
        raise AssertionError("int8 engine on the card disagrees with the "
                             "CPU plain path")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}), flush=True)
    print(power_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
