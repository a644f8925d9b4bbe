#!/usr/bin/env python3
"""Smoke run of the insarseg_torch port on one NVIDIA GPU (an H100 SXM).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and exits non-zero, printing no result, without
one. It imports the port only (no JAX, nothing of ``insarseg``) and:

1. builds the hand-written kernels from ``insarseg_torch/csrc`` (nvcc for
   sm_90a, one process per source, into ``insarseg_torch/_build/``),
   prints the build time, the compiler's register / spill report and the
   card's name and power limit, and checks in the SASS (``cuobjdump``)
   that every kernel of K1 and K5a runs on the tensor cores (IGMMA, the
   int8 ``wgmma``) and none on ``__dp4a`` (IDP), and every kernel of K6 on
   them too (HGMMA, the bf16 ``wgmma``);
2. holds every kernel to its plain PyTorch version on the card, exactly
   (K6, which sums on the tensor cores in its own order: every code within
   1 and at most a stated share differing, ``kernels.UP_SHARE_*``), at fixed
   shapes (K1 at Cin 1/64/1024 x 512^2/128^2/32^2 and at the four H-s2d
   level-1 shapes (256x512, Cin 2/128/256 -> 128), both exits; K2 at 512^2x64
   and 32^2x1024 with both exits, its squeeze also at C 16 / 2048 / 4096, b1 /
   b8 / b9 and 512^2 codes all +127 or -128; K3 at 512^2x64; K3s at 256x512x128
   and an odd width; K4a / K4b at C 128/256/512/1024 at their path sizes and a
   ragged 7x5x48; K6 in both forms at ragged sizes (a tile across taps)
   with and without a bias, and on the ties of its requant; K7 at odd sizes,
   W a multiple of 8 but not 16, three column spans and H 1, two channel
   groups; K5a at k1/k3 x stride 1/2 x
   dilation 1/2/4/12/36 x every exit
   x ReLU or not x no / int8 / f32 identity, and at Cin 1280 and 2048; K1 and
   K5a at the edges of their GEMM tiling (pixel rows that straddle images and
   leave a partial 128-row tile, Cout 2/16/40/192, Cin 1/2/40/96, odd sizes at
   stride 2, dilation 36 on 64^2, the largest accumulator: Cin 2048, 3x3, codes
   +-127); K5b with both identities and on quotients at the ties), then on the
   tensors of one int8 forward of each main path (512^2, b8), timing each
   kernel on the device alone and its wrapper's host us a call (``device_ms``),
   the kernel back to back (``back_to_back_ms``), its plain version and a
   PyTorch reference call where one exists (device alone), and computing each
   call's bound (a kernel's row sums its calls over the main paths that launch
   it);
3. drives six main paths at full width with seeded random weights, each
   with the launch counters set to 0 just before and read just after:
   U-Net-CA and U-Net-SA (base 64), the fast cell U-Net-fast-CA (level 1
   128, its int8 engine the standard-layout graph on the space-to-depth
   input), FCN-ResNet50-CA, DeepLabV3-ResNet50 and the true
   PSPNet-ResNet50-CA (its int8 backbone on K5a / K5b / K2's squeeze / K7,
   its pyramid-pooling head bf16), 1 -> 2 classes, through
   ``make_engine`` 'module' (f32 and bf16), 'serve' (f32 and bf16
   input) and 'int8' (calibrated on two seeded 512^2 batches; the
   U-Net-CA int8 engine is the H-s2d graph, U-Net-SA's the standard
   layout), each serving batches of eight 512^2 tiles, plus a
   1024^2 scene through ``sliding_window_inference`` on the U-Net-CA and
   FCN int8 engines; after each path, 9 tiles' int8 logits alone against
   the same tiles as the first 9 of 18 (bit-equal: the batched
   multi-scene ``predict`` and the stream run chunks of other sizes than
   a scene alone; PSPNet-CA's bf16 head runs in calls of a fixed
   number of tiles for this), the same comparison on the module and serve
   engines in f32 and bf16, counted and printed (no bar: cuDNN picks its
   kernels by the batch), one warm int8 forward on a CUDA input
   under ``torch.cuda.set_sync_debug_mode("error")`` (no call may
   synchronise the stream), the int8 forward timed in turns as it is, with
   its device scalars copied from host memory and with K6 / K7 replaced by
   the library chains they replace, and the device's idle share and top
   operations in a short ``torch.profiler`` window of each (a U-Net window
   may hold no transposed conv and no concat: K6 does both), and for a
   U-Net the int8 forward's argmax against the same forward with K6's
   plain version (bars ``K6_AGREE``), for PSPNet-CA its pyramid-pooling
   head with the bins sharing one integral image against one a bin, and
   its int8 forward with the head in fixed chunks against the head on
   the whole batch and one tile a call (and each one's count of
   batch-dependent logits), in turns; then
   U-Net-CA's int8 engine in the standard
   layout (``pack_unet_int8(s2d=False)``), checked for syncs and timed in
   turns against the H-s2d one; then DeepLab-CA, DeepLab-SA, FCN, FCN-SA,
   PSPNet and PSPNet-SA once each through 'int8' (512^2, b2);
4. checks the outputs: serve f32 within 1e-3 x max|logit| of module f32
   (TF32 off), int8 logits correlated with serve's > 0.98 (U-Net) and
   > 0.97 (ResNet cells, the JAX package's bar), the launches per int8
   forward (U-Net-CA H-s2d 18 / 9 / 9 / 3 / 1 / 4 of K1 / K2 squeeze /
   K2 excite / K3 / K3s / K6, in the standard layout and U-Net-fast-CA
   18 / 9 / 9 / 4 / 4 of K1 / K2 squeeze / K2 excite / K3 / K6; U-Net-SA
   18 / 4 / 4 / 4 / 4 of K1 / K3 / K4a / K4b / K6; FCN-CA 53 / 16 / 16 / 1
   of K5a / K5b / K2 squeeze / K7; DeepLabV3 58 K5a, one K2 squeeze and
   one K7; PSPNet-CA 52 / 16 / 16 / 1 of K5a / K5b / K2 squeeze / K7), the
   int8 engines on the card against the same trees on the CPU (plain
   versions; a U-Net as it is and on K6's plain version, bars
   ``CARD_VS_CPU*``), finite scenes;
5. trains U-Net-CA (base 64, f32, TF32 off) at its preset shape
   (``unet-channelattention``: 128^2, b8): ``fit`` for 2 epochs of 4
   steps on in-memory ``synthetic_batch`` data with validation and a
   ``Checkpointer`` (every loss finite, the second epoch's train loss below
   the first's; the latest checkpoint restores step, weights and Adam
   state bit for bit, the best loads on the CPU, a resume trains epoch 3),
   then times the train step (CUDA events, 3 repeats of 5 warm steps at
   128^2 b8, of 2 at 512^2 b8) beside its bound, with one warm step under
   ``set_sync_debug_mode("error")``, the peak of ``max_memory_allocated``
   and a 3-step profiler window, and holds two steps on the card to the
   CPU's at 64^2 b2; then the same in bf16 (``compute_dtype``: bf16 convs
   and matmuls over f32 parameters, Adam state and BN statistics; bound
   at the dense bf16 peak), its loss finite and falling over 5 steps on
   one batch and its parameters and Adam state f32, its two steps on the
   card against the CPU's (``BF16_CARD_VS_CPU``), ``fit`` for 2 epochs in
   bf16 (seconds); the step with ``remat`` (each DoubleConv recomputed in
   the backward pass) at 512^2 b8 in f32 and bf16 beside the step without
   it (ms and peak memory), and remat against no remat on the card under
   ``cudnn.deterministic`` (held to the difference two identical steps
   without remat show, 0 if they agree bit for bit);
6. runs the commands users run (``insarseg_torch.cli``, on the card) on
   files, the ``cli`` phase: a synthetic VOC tree (``make_synthetic_voc``)
   in a temporary directory; ``train --preset unet-channelattention``
   (base 64, 128^2 b8, 16 train and 8 val tiles) for 2 epochs on the
   native loader, then ``--resume`` to epoch 3 (finite losses, the history
   JSON's keys, best and latest written); ``eval`` of the checkpoint on
   the module and the int8 engine (calibrated on the train split, saved
   with ``--save-engine``; finite mIoU); ``predict --engine-artifact`` of
   two 1024^2 scenes and a 1536x1024 one in one call (the first two
   through the batched stitch), each PNG against a single-scene
   ``predict`` of it (agreement >= ``CLI_AGREE``, the differing pixels
   printed), with the launches of each kernel counted from 0 around the
   call; ``train --preset pspnet-channelattention`` (FCN-ResNet50-CA,
   64^2 b128, 136 train tiles) for 1 epoch, an int8 ``predict`` of one
   1024^2 scene, ``export-torch`` and the exported file's ``predict``
   (the same PNG bit for bit); one train step of ``--preset pspnet-true``
   at batch 1; ``train --compute-dtype bfloat16`` and ``train --remat
   true`` of U-Net-CA for one epoch each and a bf16 ``eval`` of the
   bf16 checkpoint; every kernel call of every command held against its plain
   version on the same arguments, as the main paths' calls are (equal,
   K6 within its counted bar; ``checked_calls``), and each kernel checked
   at least as often as it launched; each command's wall seconds and the
   checks' share of them;
7. streams scenes larger than memory, the ``stream`` phase
   (``chip_smoke.py::stream_path``): seeded smooth uint8 scenes in
   ``.npy`` memory maps, int8 engines whose classifier bias is centred so
   both classes come out (``balanced_model``); U-Net-CA (base 64, H-s2d)
   through ``data/serve.py::stream_scene_inference`` (argmax on the card
   into a memory-mapped writer) over 16384^2 and 8192x16384 at
   batch_size 128 and 16384^2 at 32: seconds, tiles/s, the peak of
   ``max_memory_allocated`` (the two heights' peaks within
   ``STREAM_PEAK_BAR``) and, in a traced repeat, the device idle share;
   the stream (logits and argmax, batch_size 32) against the in-memory
   ``sliding_window_inference_batched`` on the same engine for U-Net-CA
   (4096x6000), U-Net-SA and FCN-CA (2048x3000: a clamped last band), the
   stream normalizing on the card, the in-memory path given
   ``cli.normalize_scene`` (bars ``STREAM_LOGIT_BAR``, ``STREAM_AGREE``);
   every kernel call of a U-Net-CA stream at batch_size 8 held against
   its plain version (``checked_calls``); ``predict --stream`` of an
   8192^2 ``.npy`` against the in-memory ``predict`` of it as a PNG, one
   int8 artifact (``STREAM_AGREE`` of the pixels), each command's seconds;
8. prints the kernel table as one JSON line (each row with
   ``cli_launches``, its launches in the cli phase's predicts, and
   ``cli_checked`` / ``cli_max_abs_err``, its calls checked in the cli
   phase and their largest difference from the plain version;
   ``stream_launches``, its launches in the stream phase's streams, each
   counted from 0, and ``stream_checked``), the ``nvidia-smi`` name and
   power-limit line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

# NVIDIA's published H100 SXM peaks at the full 700 W power limit
PEAK_OPS = 1979e12    # dense int8 tensor-core rate, operations/s
PEAK_BF16 = 989e12    # dense bf16 tensor-core rate, FLOP/s
PEAK_BYTES = 3.35e12  # HBM3 bandwidth, bytes/s
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


def back_to_back_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn()`` in ms by CUDA events around ``reps`` calls made
    back to back: the stream's time per call when the host queues the
    calls as fast as it can. Where a call's host work outlasts its device
    work, this times the host."""
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


SPIN_CYCLES = 2_000_000  # ~1 ms of torch.cuda._sleep at the H100's clocks


def device_ms(fn, reps: int, warmup: int = 1):
    """(device ms per call, host us per call) of ``fn()``.

    The ``reps`` calls are queued behind a spin kernel
    (``torch.cuda._sleep``) that lasts longer than their queueing, so the
    CUDA events just before and after them time the device alone, the calls
    back to back, whatever the host's pace. The host time is that of
    queueing them (the wrapper's checks, allocations and launches). The
    spin grows until it outlasts the queueing; a call that synchronises
    never lets it, and is reported."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    for _ in range(4):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(spin)
        e1.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = time.perf_counter() - t0
        e2.record()
        torch.cuda.synchronize()
        if e0.elapsed_time(e1) > 1.5e3 * host:
            break
        spin *= 4
    else:
        log(f"  warning: the spin never outlasted the queueing "
            f"({host * 1e3:.3f} ms): the call synchronises, and its device "
            "time holds host gaps")
    return e1.elapsed_time(e2) / reps, host / reps * 1e6


def bound(ops: float, nbytes: float, peak_ops: float = PEAK_OPS):
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
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


def compare(a, b):
    """(max |a - b|, differing elements, elements): raises unless equal."""
    return same(a, b), 0, a.numel()


def up_compare(max_share: float, cs: int):
    """K6's comparison: the counted bar at ``max_share`` on the codes after
    the skip's ``cs`` channels; (max |delta|, differing codes, codes)."""
    from insarseg_torch import kernels as K

    def cmp(got, want):
        dmax, share = K.assert_up_codes_close(got, want, cs, max_share)
        n = got[..., cs:].numel()
        return float(dmax), round(share * n), n
    return cmp


# End-to-end bars of the int8 engines on the card. A U-Net forward as it is
# runs K6, whose tensor-core sums change one code by one in about 1e-6 of
# its codes (a few hundred of the 250 M of a U-Net-CA forward), and the
# random-weight networks carry such a change to the argmax of up to 1.2%
# of the pixels: over seeds 0-4 on an H100 (``tools/k6_agree.py``, PERF.md
# §6) the flipped pixels are low-margin ones, and +-1 at as many random
# codes of K6's plain version moves the argmax as far. The bars of this
# script's seed stay where it meets them (U-Net-CA's 0.999 against K6's
# plain version; 0.999 / 0.995 card vs CPU); the others, the fast cell's
# argmax card vs CPU as it is (0.99402 on this seed) among them, lie
# below the smallest reading over seeds 0-4.
#
# ``k6_agreement`` (512^2, b8): argmax, as it is against the same forward
# on K6's plain version.
K6_AGREE = {("unet", "channel"): 0.999, ("unet", "spatial"): 0.99,
            ("unet-fast", "channel"): 0.99}
# ``card_vs_cpu`` (64^2, b2): (logit correlation, argmax agreement) of the
# card's forward against the CPU's plain path. The float ops alone (every
# ResNet; a U-Net on K6's plain version): CARD_VS_CPU; a U-Net as it is
# adds K6's codes: CARD_VS_CPU_AS_IS.
CARD_VS_CPU = (0.999, 0.995)
CARD_VS_CPU_AS_IS = {("unet", "channel"): (0.999, 0.995),
                     ("unet", "spatial"): (0.999, 0.995),
                     ("unet-fast", "channel"): (0.999, 0.99)}


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def check_sass() -> None:
    """K1, K5a and K6 must run on the tensor cores: every conv kernel of
    the library has int8 tensor-core MMA instructions in its SASS (IGMMA,
    the ``wgmma`` form, or IMMA, the ``mma.sync`` one) and no IDP
    (``__dp4a``); every K6 kernel (``up_i8.cu``) has bf16 ``wgmma``
    instructions (HGMMA)."""
    import re
    from pathlib import Path

    from insarseg_torch import kernels as K
    from insarseg_torch.kernels import _lib

    tool = Path(_lib._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(tool), "--dump-sass", str(Path(K.build_info["dir"])
                                       / _lib.LIB_NAME)],
        capture_output=True, text=True, timeout=300, check=True).stdout
    counts, name, ops = {}, None, set()
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"MMA": 0, "IDP": 0, "HGMMA": 0}
        elif name is not None:
            mma = re.search(r"\b(IGMMA|IMMA)\S*", line)
            if mma:
                counts[name]["MMA"] += 1
                ops.add(mma.group(0))
            counts[name]["IDP"] += bool(re.search(r"\bIDP\b", line))
            counts[name]["HGMMA"] += bool(re.search(r"\bHGMMA\b", line))
    conv = {n: c for n, c in counts.items() if "conv_kernel" in n}
    log(f"SASS: {len(conv)} conv kernels (K1 + K5a instantiations), "
        f"tensor-core MMA instructions per kernel "
        f"{min((c['MMA'] for c in conv.values()), default=0)}-"
        f"{max((c['MMA'] for c in conv.values()), default=0)} "
        f"({', '.join(sorted(ops))}), IDP "
        f"{sum(c['IDP'] for c in conv.values())}")
    if not conv or any(c["MMA"] == 0 or c["IDP"] for c in conv.values()):
        raise AssertionError(f"conv kernels off the tensor cores: {conv}")
    up = {n: c["HGMMA"] for n, c in counts.items()
          if "up_concat_i8_kernel" in n}
    log(f"SASS: {len(up)} K6 kernels, HGMMA instructions per kernel "
        f"{sorted(up.values())}")
    if not up or min(up.values()) == 0:
        raise AssertionError(f"K6 kernels off the tensor cores: {up}")


# K1 / K5a at the edges of the GEMM tiling (128-pixel x 64/128-channel
# tiles, 64-byte K chunks): (b, h, w, cin, cout, k, stride, dilation)
IGEMM_EDGES = (
    (3, 7, 9, 64, 64, 3, 1, 1),      # M = 189: tiles straddle 3 images
    (2, 9, 11, 32, 16, 3, 1, 1),     # Cout 16
    (2, 9, 11, 32, 40, 1, 1, 1),     # Cout 40
    (2, 9, 11, 32, 2, 3, 1, 1),      # Cout 2
    (1, 20, 20, 128, 192, 3, 1, 1),  # Cout 192: three 64-wide N tiles
    (2, 13, 11, 40, 64, 3, 1, 1),    # Cin 40 -> 48: a partial K chunk
    (1, 13, 11, 96, 128, 3, 1, 1),   # Cin 96: chunks of 64 and 32 bytes
    (2, 16, 16, 1, 64, 3, 1, 1),     # Cin 1 (U-Net inc.c1)
    (2, 16, 16, 2, 128, 3, 1, 1),    # Cin 2 (U-Net inc.c1, H-s2d)
    (2, 15, 13, 64, 128, 1, 2, 1),   # 1x1 stride 2 at odd sizes
    (1, 17, 9, 256, 64, 3, 2, 1),    # 3x3 stride 2 at odd sizes
    (1, 64, 64, 64, 64, 3, 1, 36),   # dilation 36 on a 64^2 map
)


def check_fixed_shapes(dev) -> None:
    import torch
    from insarseg_torch import kernels as K

    gen = torch.Generator().manual_seed(SEED)
    for cin in (1, 64, 1024):
        for hw in (512, 128, 32):
            for exit_ in ("s8", "bf16"):
                cout = 1024 if hw == 32 else 64
                args, kw = k5a_case(gen, 1, hw, hw, cin, cout, 3, exit_,
                                    "none", dev)
                args += (kw["out_s"],)
                same(K.conv3x3_i8(*args), K.conv3x3_i8_plain(*args))
    for cin in (2, 128, 256):  # the H-s2d level-1 convs (inc, conv4)
        for exit_ in ("s8", "bf16"):
            args, kw = k5a_case(gen, 2, 256, 512, cin, 128, 3, exit_, "none",
                                dev)
            args += (kw["out_s"],)
            same(K.conv3x3_i8(*args), K.conv3x3_i8_plain(*args))
    for b, h, w, cin, cout, k, stride, dil in IGEMM_EDGES:
        if (k, stride, dil) == (3, 1, 1):
            for exit_ in ("s8", "bf16"):
                args, kw = k5a_case(gen, b, h, w, cin, cout, 3, exit_,
                                    "none", dev)
                args += (kw["out_s"],)
                same(K.conv3x3_i8(*args), K.conv3x3_i8_plain(*args))
    x, wt, mult, off = largest_accumulator(dev, 1)
    for out_s in (2.0, None):
        same(K.conv3x3_i8(x, wt, mult, off, out_s),
             K.conv3x3_i8_plain(x, wt, mult, off, out_s))
    log("K1 int8_conv3x3_epilogue == plain at Cin 1/64/1024 x "
        "512^2/128^2/32^2, at 256x512 Cin 2/128/256 -> 128, at the GEMM "
        "tiling's edges and at the largest accumulator, int8 and bf16 "
        "exits")
    for hw, c in ((512, 64), (32, 1024)):
        q = torch.randint(-127, 128, (2, hw, hw, c), generator=gen,
                          dtype=torch.int8).to(dev)
        same(K.se_squeeze_i8(q), K.se_squeeze_i8_plain(q))
        for dt in (torch.float32, torch.bfloat16):
            gain = (torch.rand((2, c), generator=gen) * 2).to(dt).to(dev)
            same(K.se_excite_i8(q, gain), K.se_excite_i8_plain(q, gain))
    for shape, fill in (((1, 1, 1, 16), None), ((9, 13, 11, 4096), None),
                        ((8, 64, 64, 2048), None), ((1, 256, 512, 128), None),
                        ((8, 512, 512, 16), 127), ((9, 512, 512, 16), -128)):
        q = torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8) \
            if fill is None else torch.full(shape, fill, dtype=torch.int8)
        q = q.to(dev)
        same(K.se_squeeze_i8(q), K.se_squeeze_i8_plain(q))
    log("K2 se_squeeze_i8 / se_excite_i8 == plain at 512^2x64 and "
        "32^2x1024, int8 and bf16 exits; the squeeze also at b1 1x1x16, b9 "
        "13x11x4096, b8 64^2x2048, b1 256x512x128 and 512^2x16 codes all "
        "+127 (b8) or -128 (b9)")
    q = torch.randint(-128, 128, (2, 512, 512, 64), generator=gen,
                      dtype=torch.int8).to(dev)
    same(K.maxpool2x2_i8(q), K.maxpool2x2_i8_plain(q))
    log("K3 maxpool2x2_i8 == plain at 512^2x64")
    for shape in ((BATCH, 256, 512, 128), (3, 5, 9, 32)):
        q = torch.randint(-128, 128, shape, generator=gen,
                          dtype=torch.int8).to(dev)
        same(K.maxpool_exit_s2d_i8(q), K.maxpool_exit_s2d_i8_plain(q))
    log(f"K3s maxpool_exit_s2d_i8 == plain at b{BATCH} 256x512x128 and "
        "5x9x32")
    for shape in ((BATCH, 512, 512, 128), (BATCH, 256, 256, 256),
                  (BATCH, 128, 128, 512), (BATCH, 64, 64, 1024),
                  (3, 7, 5, 48)):
        q = torch.randint(-128, 128, shape, generator=gen,
                          dtype=torch.int8).to(dev)
        same(K.sa_stats_i8(q, 0.0173), K.sa_stats_i8_plain(q, 0.0173))
        g = torch.rand(shape[:3], generator=gen).to(dev)
        same(K.sa_gate_i8(q, g), K.sa_gate_i8_plain(q, g))
        del q, g
    log(f"K4a sa_stats_i8 / K4b sa_gate_i8 == plain at b{BATCH} "
        "512^2x128, 256^2x256, 128^2x512, 64^2x1024 and 3x7x5x48")
    shares = []
    for b, h, w, cin, cout, s2d, cat_s in (
            (3, 9, 11, 40, 48, False, 0.015), (1, 5, 7, 128, 128, True, 0.015),
            (2, 13, 7, 72, 80, False, 0.015), (8, 128, 128, 256, 128, False,
                                               0.5)):
        scale = 20.0 if cat_s == 0.5 else 1.0
        y = (torch.randn((b, h, w, cin), generator=gen) * scale) \
            .to(torch.bfloat16)
        k = torch.randn((1 if s2d else 2, 2, cin, cout), generator=gen) \
            / np.sqrt(cin)
        skip = torch.randint(-127, 128, (b, h if s2d else 2 * h, 2 * w, 32),
                             generator=gen, dtype=torch.int8).to(dev)
        bar = K.UP_SHARE_TIES if cat_s == 0.5 else K.UP_SHARE_RANDOM
        for bias in ((torch.randn(cout, generator=gen) * 0.5)
                     .to(torch.bfloat16).to(dev), None):
            args = (y.to(dev), K.pack_up_weight(k, s2d).to(dev), bias, skip,
                    cat_s, s2d)
            dmax, n_diff, n = up_compare(bar, 32)(
                K.up_concat_i8(*args), K.up_concat_i8_plain(*args))
            shares.append(f"{n_diff / n:.2e}")
    log(f"K6 up_concat_i8 within the counted bar of plain (|d| <= 1; share "
        f"<= {K.UP_SHARE_RANDOM:g} at cat_s 0.015, <= {K.UP_SHARE_TIES:g} on "
        f"the ties) at 3x9x11x40 -> 48, 1x5x7x128 -> 128 (H-s2d up4), "
        f"2x13x7x72 -> 80 and the tie-heavy b8 128^2x256 -> 128, with and "
        f"without a bias: differing shares {', '.join(shares)}")
    for shape in ((1, 64, 7, 9), (3, 48, 11, 7), (1, 128, 5, 130),
                  (2, 64, 9, 24), (1, 64, 3, 520), (1, 16, 1, 16)):
        y = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
        for t in (y, y.contiguous(memory_format=torch.channels_last)):
            same(K.stem_pool_i8(t, 0.01), K.stem_pool_i8_plain(t, 0.01))
    log("K7 stem_pool_i8 == plain at 1x64x7x9, 3x48x11x7, 1x128x5x130, "
        "2x64x9x24, 1x64x3x520 and 1x16x1x16, NCHW and channels-last")
    torch.cuda.synchronize()


K5A_GEOMETRY = ((3, 1, 1), (3, 2, 1), (3, 1, 2), (3, 1, 4), (3, 1, 12),
                (3, 1, 36), (1, 1, 1), (1, 2, 1))


def k5a_case(gen, b, h, w, cin, cout, k, exit_, idn_kind, dev, stride=1):
    """Arguments of one K5a call whose epilogue spans the int8 range (K1
    takes the first four and ``out_s``)."""
    import torch
    from insarseg_torch.kernels import repack_conv_weight
    from insarseg_torch.ops.quant import quant_weight

    q = torch.from_numpy(quant_weight(
        np.random.default_rng(cin * 7 + cout + k).normal(
            0, 1, (k, k, cin, cout)))["q"])
    x = torch.randint(-127, 128, (b, h, w, cin), generator=gen,
                      dtype=torch.int8)
    acc_sd = 127.0 * 127.0 * np.sqrt(k * k * cin) / 3
    mult = (torch.rand(cout, generator=gen) + 0.5) * (60 / acc_sd)
    off = torch.randn(cout, generator=gen) * 10
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    idn, in_s = None, None
    if idn_kind == "s8":
        idn, in_s = torch.randint(-127, 128, (b, ho, wo, cout), generator=gen,
                                  dtype=torch.int8).to(dev), 0.3
    elif idn_kind == "f32":
        idn = (torch.randn((b, ho, wo, cout), generator=gen) * 20).to(dev)
    return ((x.to(dev), repack_conv_weight(q).to(dev), mult.to(dev),
             off.to(dev)),
            {"out_s": 0.5 if exit_ == "s8" else None, "bf16": exit_ == "bf16",
             "idn": idn, "in_s": in_s})


def largest_accumulator(dev, sign):
    """Cin 2048, 3x3, x = 127 and w = 127 * sign everywhere: interior sums
    of 9 * 2048 * 127^2 = 297,289,728 (the largest |acc| of the engines),
    with mult / off that bring the epilogue into the int8 range."""
    import torch
    from insarseg_torch.kernels import repack_conv_weight

    cin, cout = 2048, 72
    x = torch.full((1, 6, 5, cin), 127, dtype=torch.int8, device=dev)
    wt = repack_conv_weight(torch.full((3, 3, cin, cout), 127 * sign,
                                       dtype=torch.int8)).to(dev)
    mult = torch.full((cout,), 100.0 / 3e8, device=dev)
    off = torch.linspace(-20, 20, cout, device=dev)
    return x, wt, mult, off


def check_resnet_fixed_shapes(dev) -> None:
    import torch
    from insarseg_torch import kernels as K

    gen = torch.Generator().manual_seed(SEED + 5)
    n = 0
    for k, stride, dil in K5A_GEOMETRY:
        for exit_ in ("s8", "f32", "bf16"):
            for idn_kind in ("none", "s8", "f32"):
                for relu in (True, False):
                    args, kw = k5a_case(gen, 2, 40, 36, 64, 80, k, exit_,
                                        idn_kind, dev, stride)
                    kw.update(stride=stride, dilation=dil, relu=relu)
                    same(K.conv_i8(*args, **kw), K.conv_i8_plain(*args, **kw))
                    n += 1
    # the main path's wide and deep cases: ASPP at rates 12/36 on a 64^2
    # map (Cin 2048), the projection (Cin 1280), layer4's 1x1s (Cin 2048,
    # f32 exit and f32 identity), the stride-2 downsample (f32 exit)
    for b, hw, cin, cout, k, stride, dil, exit_, idn_kind in (
            (1, 64, 2048, 256, 3, 1, 12, "s8", "none"),
            (1, 64, 2048, 256, 3, 1, 36, "s8", "none"),
            (1, 64, 1280, 256, 1, 1, 1, "s8", "none"),
            (1, 64, 2048, 512, 1, 1, 1, "s8", "none"),
            (1, 64, 512, 2048, 1, 1, 1, "s8", "f32"),
            (1, 64, 512, 2048, 1, 1, 1, "s8", "s8"),
            (1, 128, 256, 512, 1, 2, 1, "f32", "none"),
            (1, 64, 2048, 512, 3, 1, 4, "bf16", "none")):
        args, kw = k5a_case(gen, b, hw, hw, cin, cout, k, exit_, idn_kind,
                            dev, stride)
        kw.update(stride=stride, dilation=dil, relu=True)
        same(K.conv_i8(*args, **kw), K.conv_i8_plain(*args, **kw))
        n += 1
    for b, h, w, cin, cout, k, stride, dil in IGEMM_EDGES:
        for exit_ in ("s8", "f32", "bf16"):
            for idn_kind in ("none", "s8", "f32"):
                args, kw = k5a_case(gen, b, h, w, cin, cout, k, exit_,
                                    idn_kind, dev, stride)
                kw.update(stride=stride, dilation=dil, relu=True)
                same(K.conv_i8(*args, **kw), K.conv_i8_plain(*args, **kw))
                n += 1
    for sign in (1, -1):
        x, wt, mult, off = largest_accumulator(dev, sign)
        one, zero = torch.ones_like(mult), torch.zeros_like(off)
        acc = K.conv_i8(x, wt, one, zero, relu=False)  # f32: the sums
        same(acc, K.conv_i8_plain(x, wt, one, zero, relu=False))
        if float(acc[0, 2, 2].abs().min()) != 9 * 2048 * 127.0 ** 2:
            raise AssertionError("largest accumulator: wrong interior sum")
        for kw in ({"out_s": 2.0}, {"bf16": True}):
            kw["relu"] = False
            same(K.conv_i8(x, wt, mult, off, **kw),
                 K.conv_i8_plain(x, wt, mult, off, **kw))
        n += 3
    log(f"K5a int8_conv_epilogue == plain in {n} cases: k1/k3 x stride 1/2 "
        "x dilation 1/2/4/12/36 x s8/f32/bf16 exits x no/s8/f32 identity x "
        "ReLU or not, Cin 1280/2048 at 64^2, the GEMM tiling's edges x "
        "every exit x identity, and the largest accumulator (+-)")
    for shape in ((2, 32, 32, 256), (1, 64, 64, 2048), (3, 7, 5, 48)):
        y3q = torch.randint(-127, 128, shape, generator=gen,
                            dtype=torch.int8).to(dev)
        gate = (torch.rand((shape[0], shape[3]), generator=gen) * 0.05) \
            .to(dev)
        for idn in (torch.randint(-127, 128, shape, generator=gen,
                                  dtype=torch.int8).to(dev),
                    (torch.randn(shape, generator=gen) * 3).to(dev)):
            in_s = 0.02 if idn.dtype == torch.int8 else None
            same(K.se_residual_i8(y3q, gate, idn, in_s, 0.03),
                 K.se_residual_i8_plain(y3q, gate, idn, in_s, 0.03))
    # quotients on the ties: y / 0.5 = q / 4 + qi (int8 identity at 0.5),
    # or q / 4 + k + 1/2 and its neighbours (f32 identity)
    y3q = torch.randint(-127, 128, (3, 5, 7, 2048), generator=gen,
                        dtype=torch.int8).to(dev)
    gate = torch.full((3, 2048), 0.125, device=dev)
    k = torch.randint(-20, 280, y3q.shape, generator=gen)
    half = (k.float() + 0.5) / 2
    for idn, in_s in ((k.clamp(-127, 127).to(torch.int8).to(dev), 0.5),
                      (torch.where(k % 3 == 0, torch.nextafter(half, half + 1),
                                   half).to(dev), None)):
        same(K.se_residual_i8(y3q, gate, idn, in_s, 0.5),
             K.se_residual_i8_plain(y3q, gate, idn, in_s, 0.5))
    log("K5b se_residual_i8 == plain at 32^2x256, 64^2x2048, 7x5x48, int8 "
        "and f32 identity, and on quotients at and beside the ties")
    torch.cuda.synchronize()


@contextlib.contextmanager
def spying(modules, names, on_call):
    """While open, each call of a kernel wrapper of ``names`` that a module
    of ``modules`` holds runs as it is, then goes to ``on_call(name, args,
    out)`` with its arguments bound to the wrapper's parameter names."""
    import inspect

    saved = [(m, n, getattr(m, n)) for m in modules for n in names
             if hasattr(m, n)]

    def spy(n, fn):
        sig = inspect.signature(fn)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            bound_args = sig.bind(*args, **kwargs)
            bound_args.apply_defaults()
            on_call(n, dict(bound_args.arguments), out)
            return out
        return wrapped

    for m, n, fn in saved:
        setattr(m, n, spy(n, fn))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def record_calls(module, names, predict, images):
    """One int8 forward with the kernel wrappers ``names`` of ``module``
    recording their arguments: the tensors the main path gives each
    kernel."""
    calls = {n: [] for n in names}
    with spying([module], names, lambda n, a, out: calls[n].append(a)):
        predict(images)
    return calls


# the wrappers' arguments that carry the batch first (every other argument
# is a weight, a scale or an option), and the tiles a plain version takes
# at a time in ``checked_calls``: the f64 plain convs of a 111-tile call
# would hold about 30 GB at once
BATCHED_ARGS = ("x", "q", "y", "y3q", "idn", "skip", "gate", "g", "gain")
CHECK_CHUNK = 16


@contextlib.contextmanager
def checked_calls(checked):
    """While open, every kernel call the int8 engines make is held against
    the wrapper's plain version on the same arguments (``CHECK_CHUNK``
    tiles of the batch at a time), as ``kernel_row`` holds the main paths'
    calls: equal, K6 within its counted bar (``up_compare`` at
    ``UP_SHARE_MAIN``, in each chunk); the first that disagrees raises.
    ``checked`` gathers per kernel name the calls, the engine batches
    they came at, the largest |delta|, the differing and all elements,
    and the seconds the checks took."""
    from insarseg_torch import kernels as K
    from insarseg_torch.models import resnet_int8, unet_int8

    kernel_of = {w: k for k, (w, _, _) in KERNELS.items()}

    def check(n, a, out):
        t0 = time.perf_counter()
        cmp = (up_compare(K.UP_SHARE_MAIN, a["skip"].shape[-1])
               if n == "up_concat_i8" else compare)
        plain = getattr(K, n + "_plain")
        e = nd = nall = 0
        for i in range(0, out.shape[0], CHECK_CHUNK):
            part = {k: v[i:i + CHECK_CHUNK]
                    if k in BATCHED_ARGS and hasattr(v, "shape") else v
                    for k, v in a.items()}
            try:
                ce, cnd, cn = cmp(out[i:i + CHECK_CHUNK], plain(**part))
            except AssertionError as err:
                shapes = {k: tuple(v.shape) for k, v in a.items()
                          if hasattr(v, "shape")}
                raise AssertionError(f"{n} on {shapes}, tiles {i}+: "
                                     f"{err}") from None
            e, nd, nall = max(e, ce), nd + cnd, nall + cn
        c = checked.setdefault(kernel_of[n], {
            "calls": 0, "batches": set(), "max_abs_err": 0.0,
            "differing": 0, "elements": 0, "seconds": 0.0})
        c["calls"] += 1
        c["batches"].add(out.shape[0])
        c["max_abs_err"] = max(c["max_abs_err"], e)
        c["differing"] += nd
        c["elements"] += nall
        c["seconds"] += time.perf_counter() - t0

    with spying([unet_int8, resnet_int8], list(kernel_of), check):
        yield


def kernel_row(name, source, replaces, cases):
    """Per call: equal to the plain version (K6: within its counted bar;
    the row's ``max_abs_err`` is then the largest code |delta| and
    ``differing_share`` the share of codes that differ); the kernel's
    device ms and host us per call (``device_ms``) and its back-to-back
    ms; the plain
    version's and the library call's device ms; the bound. Returns the
    kernel's row: sums of the ms over the calls, the mean host us."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "lib": 0.0,
           "b2b": 0.0, "host_us": 0.0}
    err, by_time = 0.0, {"bytes": 0.0, "operations": 0.0}
    by_path = {}
    has_lib = True
    n_diff = n_all = 0
    for c in cases:
        e, nd, n = c.get("compare", compare)(c["kernel"](), c["plain"]())
        err, n_diff, n_all = max(err, e), n_diff + nd, n_all + n
        ms, hus = device_ms(c["kernel"], reps=5)
        b2b = back_to_back_ms(c["kernel"], reps=5)
        pms, _ = device_ms(c["plain"], reps=2)
        bms, by = bound(c["ops"], c["bytes"], c.get("peak", PEAK_OPS))
        lms = None if c["lib"] is None else device_ms(c["lib"], reps=5)[0]
        by_path[c["path"]] = by_path.get(c["path"], 0.0) + ms
        log(f"  {name} [{c['path']}] {c['shape']}: {ms:.4f} ms device, "
            f"{hus:.1f} us host, {b2b:.4f} ms back to back, plain "
            f"{pms:.4f} ms, "
            f"library {'-' if lms is None else f'{lms:.4f}'} ms, "
            f"bound {bms:.4f} ms ({by})"
            + (f", {nd} of {n} codes differ" if nd else ""))
        tot["ms"] += ms
        tot["host_us"] += hus
        tot["b2b"] += b2b
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
            "host_us": tot["host_us"] / len(cases),
            "back_to_back_ms": tot["b2b"],
            "differing_share": n_diff / n_all if n_all else 0.0,
            "calls_timed": len(cases), "ms_by_path": by_path}


# kernel name -> (its wrapper in insarseg_torch.kernels, source, the JAX
# site it replaces)
KERNELS = {
    "int8_conv3x3_epilogue": ("conv3x3_i8", "int8_conv3x3.cu",
                              "insarseg/models/unet_int8.py:287"),
    "se_squeeze_i8": ("se_squeeze_i8", "se_i8.cu",
                      "insarseg/models/unet_int8.py:299"),
    "se_excite_i8": ("se_excite_i8", "se_i8.cu",
                     "insarseg/models/unet_int8.py:303"),
    "maxpool2x2_i8": ("maxpool2x2_i8", "maxpool2x2_i8.cu",
                      "insarseg/models/unet_int8.py:322"),
    "maxpool_exit_s2d_i8": ("maxpool_exit_s2d_i8", "maxpool2x2_i8.cu",
                            "insarseg/models/unet_s2d.py:292"),
    "sa_stats_i8": ("sa_stats_i8", "sa_i8.cu",
                    "insarseg/models/unet_int8.py:312"),
    "sa_gate_i8": ("sa_gate_i8", "sa_i8.cu",
                   "insarseg/models/unet_int8.py:312"),
    "int8_conv_epilogue": ("conv_i8", "conv_i8.cu",
                           "insarseg/models/resnet_int8.py:231"),
    "se_residual_i8": ("se_residual_i8", "block_i8.cu",
                       "insarseg/models/resnet_int8.py:262"),
    "up_concat_i8": ("up_concat_i8", "up_i8.cu",
                     "insarseg/models/unet_int8.py:345"),
    "stem_pool_i8": ("stem_pool_i8", "stem_i8.cu",
                     "insarseg/models/resnet_int8.py:278"),
}


def kernel_cases(calls, path):
    """Timing cases, per wrapper, on the tensors ``record_calls`` took in
    one forward of ``path``."""
    import torch
    import torch.nn.functional as F
    from insarseg_torch import kernels as K

    def conv(fn, a):  # K1 (3x3, stride 1, int8 or bf16 exit) and K5a
        x, w, out_s = a["x"], a["w"], a["out_s"]
        b, h, wd, cin = x.shape
        cout, k = w.shape[0], w.shape[1]
        st, dil = a.get("stride", 1), a.get("dilation", 1)
        pad = dil * (k - 1) // 2
        ho = (h + 2 * pad - dil * (k - 1) - 1) // st + 1
        wo = (wd + 2 * pad - dil * (k - 1) - 1) // st + 1
        exit_ = "s8" if out_s is not None else (
            "bf16" if a.get("bf16", True) else "f32")
        idn = a.get("idn")
        idn_bytes = 0 if idn is None else idn.numel() * idn.element_size()
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)  # channels-last
        wb = w[..., :cin].permute(0, 3, 1, 2).to(torch.bfloat16)
        return {
            "shape": f"b{b} {h}x{wd} {cin}->{cout} k{k} s{st} d{dil} {exit_}"
                     f"{'' if idn is None else ' +' + str(idn.dtype)[6:]}",
            "kernel": lambda: fn(**a),
            "plain": lambda: getattr(K, fn.__name__ + "_plain")(**a),
            "lib": lambda: F.conv2d(xb, wb, stride=st, padding=pad,
                                    dilation=dil),
            "ops": 2.0 * b * ho * wo * cin * cout * k * k,
            "bytes": x.numel() + k * k * cin * cout + 8 * cout + idn_bytes
            + b * ho * wo * cout * {"s8": 1, "bf16": 2, "f32": 4}[exit_]}

    def squeeze(a):
        q = a["q"]
        return {
            "shape": f"b{q.shape[0]} {q.shape[1]}x{q.shape[2]}x{q.shape[3]}",
            "kernel": lambda: K.se_squeeze_i8(q),
            "plain": lambda: K.se_squeeze_i8_plain(q),
            "lib": lambda: torch.sum(q, dim=(1, 2), dtype=torch.int32),
            "ops": float(q.numel()),
            "bytes": q.numel() + 4 * q.shape[0] * q.shape[3]}

    def excite(a):
        q, g = a["q"], a["gain"]
        return {
            "shape": f"b{q.shape[0]} {q.shape[1]}x{q.shape[2]}x{q.shape[3]} "
                     f"-> {'bf16' if g.dtype == torch.bfloat16 else 'int8'}",
            "kernel": lambda: K.se_excite_i8(q, g),
            "plain": lambda: K.se_excite_i8_plain(q, g),
            "lib": None,
            "ops": 2.0 * q.numel(),
            "bytes": q.numel() * (3 if g.dtype == torch.bfloat16 else 2)
            + g.numel() * g.element_size()}

    def pool(a):
        q = a["q"]
        b, h, w, c = q.shape
        return {
            "shape": f"b{b} {h}x{w}x{c}",
            "kernel": lambda: K.maxpool2x2_i8(q),
            "plain": lambda: K.maxpool2x2_i8_plain(q),
            "lib": lambda: torch.amax(q.view(b, h // 2, 2, w // 2, 2, c),
                                      dim=(2, 4)),
            "ops": 3.0 * q.numel() / 4,
            "bytes": q.numel() * 1.25}

    def pool_exit(a):
        q = a["q"]
        b, r, w, c2 = q.shape
        return {
            "shape": f"b{b} {r}x{w}x{c2}",
            "kernel": lambda: K.maxpool_exit_s2d_i8(q),
            "plain": lambda: K.maxpool_exit_s2d_i8_plain(q),
            "lib": lambda: torch.amax(
                q.view(b, r, w // 2, 2, 2, c2 // 2), dim=(3, 4)),
            "ops": 3.0 * q.numel() / 4,
            "bytes": q.numel() * 1.25}

    def sa_stats(a):
        q, s = a["q"], a["s"]
        return {
            "shape": f"b{q.shape[0]} {q.shape[1]}x{q.shape[2]}x{q.shape[3]}",
            "kernel": lambda: K.sa_stats_i8(q, s),
            "plain": lambda: K.sa_stats_i8_plain(q, s),
            "lib": None,
            "ops": 2.0 * q.numel(),
            "bytes": q.numel() + 8 * q.numel() // q.shape[3]}

    def sa_gate(a):
        q, g = a["q"], a["g"]
        return {
            "shape": f"b{q.shape[0]} {q.shape[1]}x{q.shape[2]}x{q.shape[3]}",
            "kernel": lambda: K.sa_gate_i8(q, g),
            "plain": lambda: K.sa_gate_i8_plain(q, g),
            "lib": None,
            "ops": 2.0 * q.numel(),
            "bytes": 2 * q.numel() + 4 * g.numel()}

    def residual(a):
        q, idn = a["y3q"], a["idn"]
        return {
            "shape": f"b{q.shape[0]} {q.shape[1]}x{q.shape[2]}x{q.shape[3]} "
                     f"+{str(idn.dtype)[6:]}",
            "kernel": lambda: K.se_residual_i8(**a),
            "plain": lambda: K.se_residual_i8_plain(**a),
            "lib": None,
            "ops": 4.0 * q.numel(),
            "bytes": q.numel() * (2 + idn.element_size())
            + a["gate"].numel() * 4}

    def up(a):  # K6; library: the bf16 ConvT alone (cuDNN)
        y, w, bias, skip, s2d = a["y"], a["w"], a["bias"], a["skip"], \
            a["s2d"]
        b, h, wd, cin = y.shape
        n = w.shape[0]
        rt = 1 if s2d else 2
        cout = n // (2 * rt)
        yb = y.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        wl = w.reshape(rt, 2, cout, cin).permute(3, 2, 0, 1).contiguous()
        return {
            "shape": f"b{b} {h}x{wd} {cin}->{cout}x{2 * rt} "
                     f"{'s2d' if s2d else 'k2s2'} + skip {skip.shape[-1]}",
            "kernel": lambda: K.up_concat_i8(**a),
            "plain": lambda: K.up_concat_i8_plain(**a),
            "compare": up_compare(K.UP_SHARE_MAIN, skip.shape[-1]),
            "lib": lambda: F.conv_transpose2d(yb, wl, stride=(rt, 2)),
            "ops": 2.0 * b * h * wd * n * cin, "peak": PEAK_BF16,
            "bytes": 2 * y.numel() + 2 * w.numel() + 2 * cout
            + 2 * skip.numel() + b * h * wd * n}

    def stem(a):  # K7; library: the max-pool alone
        y = a["y"]
        b, c, h, w = y.shape
        out = b * c * ((h - 1) // 2 + 1) * ((w - 1) // 2 + 1)
        return {
            "shape": f"b{b} {c}x{h}x{w} "
                     f"{'NCHW' if y.is_contiguous() else 'channels-last'}",
            "kernel": lambda: K.stem_pool_i8(**a),
            "plain": lambda: K.stem_pool_i8_plain(**a),
            "lib": lambda: F.max_pool2d(y, 3, 2, 1),
            "ops": 10.0 * out, "bytes": 2 * y.numel() + out}

    make = {"conv3x3_i8": lambda a: conv(K.conv3x3_i8, a),
            "conv_i8": lambda a: conv(K.conv_i8, a),
            "se_squeeze_i8": squeeze, "se_excite_i8": excite,
            "maxpool2x2_i8": pool, "maxpool_exit_s2d_i8": pool_exit,
            "sa_stats_i8": sa_stats, "sa_gate_i8": sa_gate,
            "se_residual_i8": residual, "up_concat_i8": up,
            "stem_pool_i8": stem}
    return {n: [dict(make[n](a), path=path) for a in args]
            for n, args in calls.items()}


# ---------------------------------------------------------------------------
# 3. the main path
# ---------------------------------------------------------------------------

def random_state_dict(model, seed: int, conv_gain: float = 2.0):
    """Seeded random weights in the reference state_dict's shapes: normal
    convs with variance ``conv_gain / fan_in`` (He for the U-Net, LeCun,
    the JAX package's init, for the ResNets), random BN affines and running
    statistics (var > 0)."""
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
        elif k.split(".")[-2].startswith("up"):  # ConvT (I, O, 2, 2)
            a = rng.normal(0, np.sqrt(1.0 / shape[0]), shape)
        else:  # Conv2d (O, I, kh, kw) or Linear (O, I)
            fan_in = int(np.prod(shape[1:]))
            a = rng.normal(0, np.sqrt(conv_gain / fan_in), shape)
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


def build_model(name: str, attention: str, seed: int = SEED):
    from insarseg_torch.models.registry import build
    from insarseg_torch.models.unet import UNet

    if name == "unet":
        model = UNet(num_classes=2, base_features=BASE,
                     use_se=attention == "channel",
                     use_sa=attention == "spatial")
        sd = random_state_dict(model, seed)
    elif name == "unet-fast":  # level 1 = 128, the JAX package's default
        model = build(name, attention, num_classes=2)
        sd = random_state_dict(model, seed)
    else:
        model = build(name, attention, num_classes=2)
        sd = random_state_dict(model, seed, conv_gain=1.0)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def build_engines(dev, name, attention, model, calib, full=True):
    """The cell's engines: int8 and serve f32, and with ``full`` module f32
    and bf16 and serve with bf16 input."""
    import torch
    from insarseg_torch.engines import make_engine

    engines = {}
    if full:
        engines["module f32"] = make_engine(name, attention, model, None,
                                            "module", device=dev)
        engines["module bf16"] = make_engine(name, attention, model, None,
                                             "module", device=dev,
                                             input_dtype=torch.bfloat16)
    engines["serve f32"] = make_engine(name, attention, model, None, "serve",
                                       device=dev)
    if full:
        engines["serve bf16-input"] = make_engine(
            name, attention, model, None, "serve", device=dev,
            input_dtype=torch.bfloat16)
    engines["int8"] = make_engine(name, attention, model, None, "int8",
                                  calib_batches=calib, device=dev)
    return engines


def serve_and_check(engines, images, dev, corr_bar: float,
                    power_line: str = "", timed: bool = False):
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
    if "module f32" in out:
        ref = out["module f32"]
        scale = float(np.abs(ref).max())
        err = float(np.abs(out["serve f32"] - ref).max())
        log(f"  serve f32 vs module f32: max abs err {err:.3g}, "
            f"{err / scale:.3g} x max|logit| ({scale:.4g})")
        if err > 1e-3 * scale:
            raise AssertionError("serve f32 differs from module f32")
    for name in ("serve bf16-input", "module bf16"):
        if name in out:
            agree = float(np.mean(out[name].argmax(-1)
                                  == out["serve f32"].argmax(-1)))
            log(f"  {name} vs serve f32: argmax agreement {agree:.5f}")
    corr = float(np.corrcoef(out["int8"].ravel(),
                             out["serve f32"].ravel())[0, 1])
    agree8 = float(np.mean(out["int8"].argmax(-1)
                           == out["serve f32"].argmax(-1)))
    log(f"  int8 vs serve f32: logit correlation {corr:.5f}, argmax "
        f"agreement {agree8:.5f}")
    if not corr > corr_bar:
        raise AssertionError(f"int8 logit correlation {corr} <= {corr_bar}")
    return out


# The main paths: (model, attention, name, int8 correlation bar, the
# kernels launched per int8 forward)
UNET_CA_STANDARD = {"int8_conv3x3_epilogue": 18, "se_squeeze_i8": 9,
                    "se_excite_i8": 9, "maxpool2x2_i8": 4,
                    "up_concat_i8": 4}
PATHS = (
    ("unet", "channel", f"U-Net-CA base {BASE}", 0.98,
     {"int8_conv3x3_epilogue": 18, "se_squeeze_i8": 9, "se_excite_i8": 9,
      "maxpool2x2_i8": 3, "maxpool_exit_s2d_i8": 1, "up_concat_i8": 4}),
    ("unet", "spatial", f"U-Net-SA base {BASE}", 0.98,
     {"int8_conv3x3_epilogue": 18, "maxpool2x2_i8": 4, "sa_stats_i8": 4,
      "sa_gate_i8": 4, "up_concat_i8": 4}),
    ("unet-fast", "channel", "U-Net-fast-CA level 1 128", 0.98,
     dict(UNET_CA_STANDARD)),
    ("fcn", "channel", "FCN-ResNet50-CA", 0.97,
     {"int8_conv_epilogue": 53, "se_residual_i8": 16, "se_squeeze_i8": 16,
      "stem_pool_i8": 1}),
    ("deeplabv3", "none", "DeepLabV3-ResNet50", 0.97,
     {"int8_conv_epilogue": 58, "se_squeeze_i8": 1, "stem_pool_i8": 1}),
    # the backbone's 52 convs (FCN's 53 less its head: the PSPNet's head
    # stays bf16)
    ("pspnet", "channel", "PSPNet-ResNet50-CA", 0.97,
     {"int8_conv_epilogue": 52, "se_residual_i8": 16, "se_squeeze_i8": 16,
      "stem_pool_i8": 1}),
)
# a U-Net int8 forward's profiler window holds none of these: K6 writes
# the decoder's transposed convs and concats (cuDNN runs a transposed
# conv as a data-gradient kernel, "dgrad")
UNET_ABSENT = ("aten::cat", "CatArray", "conv_transpose",
               "convolution_transpose", "dgrad")


def run_path(engines, images, dev, corr_bar, want, label, power_line,
             scene=None):
    """One main path with the launch counters set to 0 just before and
    read just after: every engine serves the batch (timed), one int8
    forward's launches are checked, and an optional scene is stitched
    through the int8 engine. Returns the path's launches."""
    import torch
    from insarseg_torch import kernels as K
    from insarseg_torch.data.stitch import sliding_window_inference

    K.reset_launches()
    log(f"main path: {label}, {HW}^2, b{BATCH}")
    serve_and_check(engines, images, dev, corr_bar, power_line, timed=True)
    before = dict(K.LAUNCHES)
    engines["int8"](images)
    per_forward = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
                   if K.LAUNCHES[k] != before[k]}
    log(f"  launches in one int8 forward: {per_forward}")
    if per_forward != want:
        raise AssertionError(f"launches per forward {per_forward} != {want}")
    if scene is not None:
        t0 = time.perf_counter()
        out = sliding_window_inference(engines["int8"], scene, tile=HW,
                                       overlap=HW // 8, batch_size=BATCH,
                                       device=dev)
        torch.cuda.synchronize()
        log(f"  {scene.shape[0]}^2 scene (tile {HW}, overlap {HW // 8}) "
            f"through int8: {time.perf_counter() - t0:.3f} s, shape "
            f"{tuple(out.shape)}")
        if tuple(out.shape) != scene.shape[:2] + (2,) or \
                not bool(torch.isfinite(out.float()).all()):
            raise AssertionError("scene output is not a finite "
                                 f"{scene.shape[:2] + (2,)}")
    launches = dict(K.LAUNCHES)
    log(f"  launches on the path: {launches}")
    for name in want:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on {label}")
    return launches


@contextlib.contextmanager
def host_copied_scalars():
    """The int8 forwards with each device scalar (the requant and dequant
    scales, the squeeze's pixel count) copied from host memory
    (``torch.tensor(v, device=cuda)``), which synchronises the stream: the
    other side of ``forward_turns``."""
    import torch
    from insarseg_torch.models import resnet_int8, unet_int8
    from insarseg_torch.ops import quant

    def copied(v, device):
        return torch.tensor(v, dtype=torch.float32, device=device)

    mods = (quant, resnet_int8, unet_int8)
    saved = [m.f32_scalar for m in mods]
    for m in mods:
        m.f32_scalar = copied
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.f32_scalar = f


@contextlib.contextmanager
def library_chain():
    """The int8 forwards with K6 and K7 replaced by the chains of library
    operations they replace (the U-Net up path of PRs 1-5: layout copies,
    the cuDNN bf16 transposed conv, the bf16 bias add, the f32 requant and
    ``torch.cat``; the ResNet stem exit's max-pool, copies and requant):
    the other side of ``forward_turns``."""
    import torch
    import torch.nn.functional as F
    from insarseg_torch import kernels as K
    from insarseg_torch.models import resnet_int8, unet_int8
    from insarseg_torch.ops.quant import requant

    # K6's packed weight (N, K) -> the ConvT's (Cin, Cout, kh, kw) view of
    # the (Cin, N) weight the chain took before K6 (the same strides, so
    # cuDNN picks as it did), made once per weight
    convt = {}

    def up_chain(y, w, bias, skip, cat_s, s2d=False):
        rt = 1 if s2d else 2
        n, cin = w.shape
        if w.data_ptr() not in convt:
            convt[w.data_ptr()] = w.t().contiguous() \
                .reshape(cin, rt, 2, n // (2 * rt)).permute(0, 3, 1, 2)
        wt = convt[w.data_ptr()]
        z = F.conv_transpose2d(y.permute(0, 3, 1, 2).contiguous(), wt,
                               stride=(rt, 2))
        if bias is not None:
            z = z + bias[None, :, None, None]
        zq = requant(z.permute(0, 2, 3, 1).contiguous().float(), cat_s)
        return torch.cat([skip, zq], dim=-1)

    saved = unet_int8.up_concat_i8, resnet_int8.stem_pool_i8
    unet_int8.up_concat_i8 = up_chain
    resnet_int8.stem_pool_i8 = K.stem_pool_i8_plain
    try:
        yield
    finally:
        unet_int8.up_concat_i8, resnet_int8.stem_pool_i8 = saved


@contextlib.contextmanager
def k6_plain():
    """The U-Net int8 forwards with K6 replaced by its plain version (on
    the card: the f32 sum in ascending k, which the tensor-core kernel
    does not repeat)."""
    from insarseg_torch import kernels as K
    from insarseg_torch.models import unet_int8

    saved = unet_int8.up_concat_i8
    unet_int8.up_concat_i8 = K.up_concat_i8_plain
    try:
        yield
    finally:
        unet_int8.up_concat_i8 = saved


def flip_margins(y, y_ref) -> str:
    """Where the argmax of logits ``y`` differs from ``y_ref``'s: how many
    pixels, the largest margin (top logit less the second, of ``y_ref``)
    among them, the share of all pixels whose margin is at most that, and
    the median margin of all pixels."""
    top2 = np.sort(y_ref, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    flip = y.argmax(-1) != y_ref.argmax(-1)
    med = float(np.median(margin))
    if not flip.any():
        return f"0 pixels flip; median margin {med:.4g}"
    mf = float(margin[flip].max())
    return (f"{int(flip.sum())} pixels flip, their margins at most "
            f"{mf:.4g}, below which lie {float(np.mean(margin <= mf)):.4%} "
            f"of all pixels; median margin {med:.4g}")


def k6_agreement(predict, images, label, bar) -> float:
    """The int8 forward's argmax as it is against the same forward with
    K6's plain version (``k6_plain``), where the argmax flips the margins
    (``flip_margins``), and the largest logit |delta| over max|logit|;
    fails below ``bar``."""
    y = predict(images).float().cpu().numpy()
    with k6_plain():
        y_plain = predict(images).float().cpu().numpy()
    agree = float(np.mean(y.argmax(-1) == y_plain.argmax(-1)))
    rel = float(np.abs(y - y_plain).max() / np.abs(y_plain).max())
    log(f"  {label} int8 vs the same forward with K6's plain version: "
        f"argmax agreement {agree:.6f} (bar {bar}; "
        f"{flip_margins(y, y_plain)}), max |logit delta| {rel:.3g} x "
        f"max|logit|")
    if not agree >= bar:
        raise AssertionError(f"{label}: argmax agreement with K6 plain "
                             f"{agree} < {bar}")
    return agree


def batch_difference(predict, dev):
    """9 tiles' int8 logits (512^2) alone and as the first 9 of 18: the
    count of logits that differ, of all, and the argmax agreement."""
    import torch

    x = torch.from_numpy(smooth_batch(np.random.default_rng(SEED + 9), 18,
                                      HW, HW)).to(dev)
    with torch.inference_mode():
        among = predict(x)[:9]
        alone = predict(x[:9])
    agree = float((among.argmax(-1) == alone.argmax(-1)).double().mean())
    return int((among != alone).sum()), alone.numel(), agree


def batch_invariance(predict, dev, label) -> None:
    """9 tiles' int8 logits alone and as the first 9 of 18 (512^2), since
    the batched multi-scene ``predict`` and the stream run chunks of other
    sizes than a scene alone: bit-equal, or it raises."""
    n, total, agree = batch_difference(predict, dev)
    log(f"{label}: int8 logits of 9 tiles among 18 vs alone, {n} of "
        f"{total} differ, argmax agreement {agree:.6f}")
    if n:
        raise AssertionError(f"{label}: a tile's int8 logits depend on the "
                             "batch")


FLOAT_ENGINES = ("module f32", "module bf16", "serve f32",
                 "serve bf16-input")


def float_batch_counts(engines, dev, label) -> dict:
    """``batch_difference`` on the module and serve engines in f32 and bf16:
    how many of 9 tiles' logits among 18 differ from alone. Printed, not
    held to a bar: every float conv runs in cuDNN, which picks its kernel
    by the batch."""
    counts = {}
    for name in FLOAT_ENGINES:
        n, total, agree = batch_difference(engines[name], dev)
        counts[name] = [n, total, agree]
        log(f"{label}: {name} logits of 9 tiles among 18 vs alone, {n} of "
            f"{total} differ, argmax agreement {agree:.6f}")
    return counts


def psp_batched_head_count(predict, dev, label) -> None:
    """The fault ``resnet_int8.pspnet_head_i8`` repairs: with PSPNet-CA's
    bf16 head on the whole batch in one call, as it ran before, how many
    of 9 tiles' int8 logits among 18 differ from alone (cuDNN picks the
    bottleneck conv's kernel by the batch). ``batch_invariance`` holds the
    head as it ships."""
    from insarseg_torch.models import resnet_int8

    chunked = resnet_int8.pspnet_head_i8
    resnet_int8.pspnet_head_i8 = lambda packed, h: resnet_int8.pspnet_head(
        packed, h.permute(0, 3, 1, 2))
    try:
        n, total, agree = batch_difference(predict, dev)
    finally:
        resnet_int8.pspnet_head_i8 = chunked
    log(f"{label}: with the bf16 head on the whole batch, {n} of {total} "
        f"int8 logits of 9 tiles among 18 differ from alone, argmax "
        f"agreement {agree:.6f}")


def check_no_sync(predict, x, label) -> None:
    """One warm int8 forward on a CUDA input under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that synchronises
    the stream raises."""
    import torch

    predict(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        predict(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"  {label}: a warm int8 forward on a CUDA input synchronises "
        "nothing (set_sync_debug_mode 'error')")


def device_idle_share(prof):
    """The share of a profiler window (first device activity to last) in
    which the device runs nothing; None where it traced no device
    activity."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA"))
    if not spans:
        return None
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    return 1.0 - busy / (spans[-1][1] - spans[0][0])


def profile_window(predict, x, reps: int = 3):
    """A short torch.profiler window of ``reps`` int8 forwards: the share of
    the window (first device activity to last) in which the device runs
    nothing, and the device ms per forward of the top operations. None
    where the trace holds no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    predict(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            predict(x)
        torch.cuda.synchronize()
    idle = device_idle_share(prof)
    if idle is None:
        return None, [], set()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    averages = prof.key_averages()
    top = sorted(averages, key=dev_us, reverse=True)[:10]
    return idle, [(e.key, dev_us(e) / reps / 1e3)
                  for e in top if dev_us(e) > 0], {e.key for e in averages}


def forward_turns(predict, x, label, power_line, reps: int = 5,
                  absent=()):
    """The int8 forward as it is ("filled": its device scalars filled on
    the device), with the scalars copied from host memory
    (``host_copied_scalars``) and with K6 / K7 replaced by the library
    chains they replace (``library_chain``), in turns: filled, copied,
    chain, chain, copied, filled; host clock over ``reps`` synchronised
    forwards each, on a CUDA input. Then each one's idle share and top
    operations from ``profile_window``; no operation or kernel of the
    filled window may have a name that holds one of ``absent``."""
    import torch

    modes = {"filled": contextlib.nullcontext, "copied": host_copied_scalars,
             "chain": library_chain}
    ms = {m: [] for m in modes}
    for mode in ("filled", "copied", "chain", "chain", "copied", "filled"):
        with modes[mode]():
            predict(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                predict(x)
            torch.cuda.synchronize()
            ms[mode].append((time.perf_counter() - t0) / reps * 1e3)
    idle = {}
    for mode in modes:
        with modes[mode]():
            idle[mode], top, keys = profile_window(predict, x)
        if mode != "copied":
            for key, dms in top:
                log(f"    profiler ({mode}), device ms per forward: "
                    f"{dms:.4f} {key}")
        if mode == "filled":
            found = sorted(k for k in keys for a in absent if a in k)
            if found:
                raise AssertionError(f"{label}: the int8 forward runs {found}")
            if absent:
                log(f"  {label}: the profiler window holds no "
                    f"{' / '.join(absent)}")
    share = {m: "not measured" if v is None else f"{100 * v:.1f}%"
             for m, v in idle.items()}
    turns = {m: " / ".join(f"{v:.3f}" for v in ms[m]) for m in ms}
    log(f"  {label} int8 forward ms (host clock, b{x.shape[0]}, CUDA "
        f"input): as it is {turns['filled']}, scalars copied from the host "
        f"{turns['copied']}, K6 / K7 replaced by the library chains "
        f"{turns['chain']} (turns 1 and 6, 2 and 5, 3 and 4); device idle "
        f"share under the profiler {share['filled']} / {share['copied']} / "
        f"{share['chain']}; on {power_line}")


def ppm_turns(predict, x, power_line, reps: int = 5) -> None:
    """PSPNet's pyramid-pooling head on the tensors of one int8 forward
    (its first call's: the head runs in calls of ``HEAD_CHUNK`` tiles):
    the bins sharing one integral image (``resnet_serve._ppm_apply``, as
    it ships) against each bin building its own (the head before), equal
    bit for bit, then the device ms of each (``device_ms``, ``reps`` calls)
    in turns: per bin, shared, shared, per bin."""
    import torch
    from insarseg_torch.models import resnet_int8, resnet_serve
    from insarseg_torch.ops.layers import adaptive_avg_pool_2d
    from insarseg_torch.ops.resize import resize_bilinear

    seen, ppm_apply = [], resnet_int8._ppm_apply

    def spy(pp, h):
        seen.append((pp, h))
        return ppm_apply(pp, h)
    resnet_int8._ppm_apply = spy
    try:
        predict(x)
    finally:
        resnet_int8._ppm_apply = ppm_apply
    pp, h = seen[0]

    def per_bin():
        outs = [h]
        for b in pp["bins"]:
            p = resnet_serve._ca(adaptive_avg_pool_2d(h, b), pp[f"bin{b}"])
            outs.append(resize_bilinear(p, h.shape[-2:]))
        return torch.cat(outs, dim=1)

    heads = {"per bin": per_bin,
             "shared": lambda: resnet_serve._ppm_apply(pp, h)}
    ms = {k: [] for k in heads}
    with torch.inference_mode():
        if not torch.equal(heads["per bin"](), heads["shared"]()):
            raise AssertionError("the shared integral image changes the "
                                 "pyramid-pooling head")
        for mode in ("per bin", "shared", "shared", "per bin"):
            ms[mode].append(device_ms(heads[mode], reps=reps)[0])
    log(f"  pyramid-pooling head on {tuple(h.shape)} {h.dtype} (device ms, "
        f"{reps} calls a turn): one integral image a bin "
        f"{' / '.join(f'{v:.4f}' for v in ms['per bin'])}, one shared "
        f"{' / '.join(f'{v:.4f}' for v in ms['shared'])} (turns 1 and 4, 2 "
        f"and 3); equal bit for bit; on {power_line}")


def card_vs_cpu_readings(dev, name, attention, model, calib, images):
    """The same int8 tree on the card and on the CPU (plain versions), at
    64^2, b2 (U-Net: H-s2d, standard for SA and the fast cell, as
    ``make_engine`` packs it): {what: (max rel err, logit correlation,
    argmax agreement)} for the card's forward as it is ("as it is") and,
    for a U-Net, the card's forward with K6's plain version ("K6 plain").
    Every kernel but K6 is exact against its plain version (phase 2), so
    "K6 plain" differs from the CPU by the bf16 float ops alone (cuDNN vs
    CPU), and "as it is" by those and K6's tensor-core sums."""
    import functools

    x_small = images[:2, :64, :64]
    calib_small = [c[:1, :64, :64] for c in calib]
    if name == "unet-fast":
        from insarseg_torch.engines import engine_from_artifact, pack_engine

        art = pack_engine(name, attention, model, None, "int8",
                          calib_batches=calib_small, device=dev)
        card = engine_from_artifact(art, device=dev)
        cpu = engine_from_artifact(art, device="cpu")
    else:
        if name == "unet":
            from insarseg_torch.models.unet_int8 import (
                make_int8_predict_fn as make,
                pack_unet_int8,
                prepare_int8 as prepare,
            )
            pack = functools.partial(pack_unet_int8,
                                     s2d=attention != "spatial")
        else:
            from insarseg_torch.models.resnet_int8 import (
                make_resnet_int8_predict_fn as make,
                pack_resnet_int8 as pack,
                prepare_resnet_int8 as prepare,
            )
        tree = pack(model.state_dict(), calib_small, device=dev)
        card, cpu = make(prepare(tree, dev)), make(prepare(tree, "cpu"))
    c = cpu(x_small).float().numpy()

    def reading(g):
        return (float(np.abs(g - c).max() / np.abs(c).max()),
                float(np.corrcoef(g.ravel(), c.ravel())[0, 1]),
                float(np.mean(g.argmax(-1) == c.argmax(-1))))
    out = {"as it is": reading(card(x_small).float().cpu().numpy())}
    if name.startswith("unet"):
        with k6_plain():
            out["K6 plain"] = reading(card(x_small).float().cpu().numpy())
    return out


def card_vs_cpu(dev, name, attention, model, calib, images) -> None:
    """``card_vs_cpu_readings``, each forward held to its bars: the card's
    forward as it is (a U-Net's at ``CARD_VS_CPU_AS_IS``), and a U-Net's
    on K6's plain version at ``CARD_VS_CPU``."""
    readings = card_vs_cpu_readings(dev, name, attention, model, calib,
                                    images)
    for what, (rel, corr, agree) in readings.items():
        bars = CARD_VS_CPU_AS_IS.get((name, attention), CARD_VS_CPU) \
            if what == "as it is" else CARD_VS_CPU
        log(f"{name}-{attention} int8 engine, card vs CPU plain versions "
            f"(64^2, b2, {what}): max rel err {rel:.3g}, logit correlation "
            f"{corr:.6f}, argmax agreement {agree:.5f} (bars {bars[0]}, "
            f"{bars[1]})")
        if corr < bars[0] or agree < bars[1]:
            raise AssertionError(f"{name} int8 engine on the card ({what}) "
                                 "disagrees with the CPU plain path")


def unet_standard_layout(dev, model, calib, images, s2d_predict,
                         power_line):
    """U-Net-CA's int8 engine in the standard layout beside the H-s2d one
    (the JAX package's default, a TPU lane-filling device): its launches
    per forward with the counters from 0, its logit correlation with the
    H-s2d engine, both engines' tiles/s in turns (H-s2d, standard,
    standard, H-s2d; host clock over 5 forwards each) and the K1 time of
    one forward of each (CUDA events, per call)."""
    import torch
    from insarseg_torch import kernels as K
    from insarseg_torch.models import unet_int8

    tree = unet_int8.pack_unet_int8(model.state_dict(), calib, s2d=False,
                                    device=dev)
    std = unet_int8.make_int8_predict_fn(unet_int8.prepare_int8(tree, dev))
    K.reset_launches()
    log(f"U-Net-CA int8, standard layout, {HW}^2, b{BATCH}")
    y_std = std(images).float().cpu().numpy()
    per_forward = {k: n for k, n in K.LAUNCHES.items() if n}
    log(f"  launches in one int8 forward: {per_forward}")
    if per_forward != UNET_CA_STANDARD:
        raise AssertionError(f"standard layout: launches {per_forward} != "
                             f"{UNET_CA_STANDARD}")
    x_dev = torch.from_numpy(images).to(dev)
    check_no_sync(std, x_dev, "U-Net-CA, standard layout")
    found = sorted(k for k in profile_window(std, x_dev)[2]
                   for a in UNET_ABSENT if a in k)
    if found:
        raise AssertionError(f"standard layout: the int8 forward runs {found}")
    del x_dev
    y_s2d = s2d_predict(images).float().cpu().numpy()
    corr = float(np.corrcoef(y_std.ravel(), y_s2d.ravel())[0, 1])
    log(f"  standard vs H-s2d int8 logits: correlation {corr:.5f}")
    if not corr > 0.98:
        raise AssertionError(f"standard vs H-s2d correlation {corr}")
    rates = {"H-s2d": [], "standard": []}
    for label, fn in (("H-s2d", s2d_predict), ("standard", std),
                      ("standard", std), ("H-s2d", s2d_predict)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn(images)
        torch.cuda.synchronize()
        rates[label].append(5 * BATCH / (time.perf_counter() - t0))
    k1 = {}
    for label, fn in (("H-s2d", s2d_predict), ("standard", std)):
        calls = record_calls(unet_int8, ["conv3x3_i8"], fn, images)
        k1[label] = sum(device_ms(c["kernel"], reps=5)[0] for c in
                        kernel_cases(calls, label)["conv3x3_i8"])
    for label in rates:
        log(f"  {label}: {' / '.join(f'{r:.2f}' for r in rates[label])} "
            f"tiles/s (turns 1 and 4, or 2 and 3), K1 {k1[label]:.3f} ms per "
            f"forward, on {power_line}")


# ---------------------------------------------------------------------------
# 5. the training path: U-Net-CA, full width, f32
# ---------------------------------------------------------------------------

TRAIN_PRESET = "unet-channelattention"  # 128^2, b8, the reference script's
TRAIN_STEPS, VAL_STEPS = 4, 2  # batches an epoch
PEAK_F32 = 67e12  # f32 FLOP/s outside the tensor cores (TF32 off)
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s


def unet_flops(size: int, batch: int) -> float:
    """FLOPs of one U-Net-CA (base ``BASE``) forward, counted from the
    convolutions', transposed convolutions' and SE matmuls' shapes."""
    import torch
    from torch import nn
    from insarseg_torch.models.unet import UNet

    with torch.device("meta"):
        model = UNet(num_classes=2, base_features=BASE, use_se=True)
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, nn.ConvTranspose2d):
            k = mod.kernel_size[0] * mod.kernel_size[1]
            total[0] += 2 * inp[0].numel() * mod.out_channels * k
        elif isinstance(mod, nn.Conv2d):
            k = mod.kernel_size[0] * mod.kernel_size[1]
            total[0] += 2 * out.numel() * mod.in_channels * k
        elif isinstance(mod, nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features
    for m in model.modules():
        m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 1, 32, 32, device="meta"))
    return total[0] * (size / 32) ** 2 * batch


def _same_state(a, b, what) -> None:
    """Two state_dicts (or optimizer state_dicts) equal bit for bit."""
    import torch

    def walk(x, y, path):
        if isinstance(x, dict):
            if sorted(x, key=str) != sorted(y, key=str):
                raise AssertionError(f"{what}: keys differ at {path}")
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            if len(x) != len(y):
                raise AssertionError(f"{what}: lengths differ at {path}")
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}/{i}")
        elif isinstance(x, torch.Tensor):
            if not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"{what}: {path} differs")
        elif x != y:
            raise AssertionError(f"{what}: {path} {x!r} != {y!r}")
    walk(a, b, "")


def train_fit(dev) -> None:
    """``fit`` for 2 epochs of U-Net-CA at its preset shape on an in-memory
    loader of ``synthetic_batch`` data, with validation and a
    ``Checkpointer``; every loss finite and the last epoch's train loss
    below the first's; then the latest checkpoint restores step, weights
    and Adam state bit for bit, the best one loads on the CPU, and a
    resumed run continues the epoch count."""
    import dataclasses
    import tempfile

    import torch
    from insarseg_torch import kernels as K
    from insarseg_torch.config import get_preset
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.models.registry import build
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.train.checkpoint import Checkpointer
    from insarseg_torch.train.engine import create_state, fit

    cfg = get_preset(TRAIN_PRESET, num_epochs=2, log_every_steps=2)
    size, b = cfg.image_size, cfg.batch_size
    train = [synthetic_batch(b, size, seed=SEED + 10 + i)
             for i in range(TRAIN_STEPS)]
    val = [synthetic_batch(b, size, seed=SEED + 20 + i)
           for i in range(VAL_STEPS)]
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        model = UNet(num_classes=2, base_features=BASE, use_se=True)
        state = create_state(model, cfg.learning_rate, seed=cfg.seed,
                             device=dev)
        K.reset_launches()
        t0 = time.perf_counter()
        hist = fit(model, cfg, train, val, state=state, checkpointer=ck,
                   device=dev)
        torch.cuda.synchronize()
        launched = {k: n for k, n in K.LAUNCHES.items() if n}
        log(f"fit: {TRAIN_PRESET} (U-Net-CA base {BASE}, {size}^2 b{b}, "
            f"{TRAIN_STEPS} steps and {VAL_STEPS} validation batches an "
            f"epoch), 2 epochs in {time.perf_counter() - t0:.2f} s; "
            f"kernel launches {launched} (the train path runs stock "
            "PyTorch / cuDNN ops only)")
        log("history " + json.dumps(hist))
        losses = [h[k] for h in hist for k in ("train_loss", "val_loss")]
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"non-finite losses {losses}")
        if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
            raise AssertionError("the train loss did not fall: "
                                 f"{[h['train_loss'] for h in hist]}")
        if not (ck.has_latest() and ck.best_metric() >= 0.0):
            raise AssertionError("fit wrote no best / latest checkpoint")

        other = create_state(UNet(num_classes=2, base_features=BASE,
                                  use_se=True), cfg.learning_rate,
                             seed=cfg.seed + 1, device=dev)
        ck.restore_latest(other)
        if not other.step == state.step == 2 * TRAIN_STEPS:
            raise AssertionError(f"restored step {other.step}")
        _same_state(state.model.state_dict(), other.model.state_dict(),
                    "restored weights")
        _same_state(state.optimizer.state_dict(),
                    other.optimizer.state_dict(), "restored Adam state")
        cpu_model = build("unet", "channel")
        ck.restore_best(cpu_model, map_location="cpu")
        rest = fit(other.model, dataclasses.replace(cfg, num_epochs=3),
                   train, val, state=other, checkpointer=ck, resume=True,
                   device=dev)
        epochs = [h["epoch"] for h in rest]
        if epochs != [3] or other.step != 3 * TRAIN_STEPS:
            raise AssertionError(f"resume: epochs {epochs}, step "
                                 f"{other.step}")
    log(f"  resume from 'latest': step {state.step}, weights and Adam state "
        "equal bit for bit; the best weights load on the CPU; the resumed "
        "run trains epoch 3")


def _dtype(name: str):
    from insarseg_torch.config import COMPUTE_DTYPES

    return COMPUTE_DTYPES[name]


def syncs(fn) -> str:
    """'' if ``fn()`` synchronises nothing under
    ``set_sync_debug_mode("error")``, else the error it raised."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return ""
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def train_step_timing(dev, size, batch, power_line, steps: int,
                      dtype: str = "float32", remat: bool = False,
                      profile: bool = True) -> dict:
    """The U-Net-CA train step at ``size``^2 b``batch`` in ``dtype``, with
    or without ``remat``: one warm step on CUDA tensors under
    ``set_sync_debug_mode("error")`` (it must synchronise nothing; with
    remat the reading is printed), then CUDA-event ms of ``steps`` warm
    steps, 3 repeats (median and spread), the peak of
    ``max_memory_allocated`` over them (reset before), tiles/s, the bound
    (3 x the forward's FLOPs at the f32 or the dense bf16 peak), and with
    ``profile`` the device idle share and top operations of a 3-step
    profiler window; the host seconds of each part. Returns the median ms
    and the peak GiB."""
    import torch
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.train.engine import create_state, make_train_step

    marks = [("start", time.perf_counter())]
    model = UNet(num_classes=2, base_features=BASE, use_se=True, remat=remat)
    state = create_state(model, seed=SEED, device=dev)
    step = make_train_step(model, 2, compute_dtype=_dtype(dtype))
    data = synthetic_batch(batch, size, seed=SEED + 30)
    x = torch.from_numpy(data["image"]).to(dev)
    m = torch.from_numpy(data["mask"]).to(dev)
    marks.append(("init", time.perf_counter()))
    step(state, x, m)
    synced = syncs(lambda: step(state, x, m))
    if synced and not remat:
        raise AssertionError(f"a warm {dtype} train step synchronises: "
                             f"{synced}")
    marks.append(("warm", time.perf_counter()))
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for _ in range(3):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(steps):
            step(state, x, m)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1) / steps)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    marks.append(("timed", time.perf_counter()))
    med = float(np.median(ms))
    flops = unet_flops(size, batch)
    peak_rate = PEAK_BF16 if dtype == "bfloat16" else PEAK_F32
    bound_ms = 3 * flops / peak_rate * 1e3
    share = "not measured"
    top = []
    if profile:
        idle, top, _ = profile_window(lambda t: step(state, t, m), x)
        marks.append(("profiler", time.perf_counter()))
        if idle is not None:
            share = f"{100 * idle:.1f}%"
    parts = ", ".join(f"{b[0]} {b[1] - a[1]:.2f}"
                      for a, b in zip(marks, marks[1:]))
    what = "f32 (TF32 off)" if dtype == "float32" else "bf16"
    log(f"train step U-Net-CA base {BASE}, {size}^2 b{batch}, {what}"
        f"{', remat' if remat else ''}: {med:.3f} ms median of "
        f"{' / '.join(f'{v:.3f}' for v in ms)} ({steps} steps a repeat, "
        f"spread {max(ms) - min(ms):.3f}), {batch / med * 1e3:.2f} tiles/s, "
        f"peak memory {peak:.4f} GiB, bound {bound_ms:.3f} ms (3 x the "
        f"forward's {flops / 1e12:.4f} TFLOP at {peak_rate / 1e12:.0f} "
        f"TFLOP/s), device idle {share} under the profiler; warm step "
        f"{'synchronises: ' + synced if synced else 'synchronises nothing'}"
        f"; host s: {parts}; on {power_line}")
    for key, dms in top:
        log(f"    profiler, device ms per step: {dms:.4f} {key}")
    return {"ms": med, "peak_gib": peak}


# the bf16 step on the card against the CPU's (relative loss, steps 1 and
# 2; the share of pixels whose class differs in step 1): two bf16 graphs
# that round at other places
BF16_CARD_VS_CPU = (2e-3, 2e-3, 1e-2)


def train_card_vs_cpu(dev, dtype: str = "float32") -> None:
    """Two U-Net-CA (base ``BASE``) train steps at 64^2 b2 on the card and
    on the CPU from the same weights and batches. f32: step 1's loss
    within rtol 1e-4 and its counts equal, step 2's loss within rtol 5e-4
    (the f32 loss bar of the JAX package's training-parity test). bf16:
    the losses within ``BF16_CARD_VS_CPU`` and at most its share of step
    1's pixels counted correct on one side only."""
    import torch
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.train.engine import create_state, make_train_step

    rng = np.random.default_rng(SEED + 40)
    batches = [(torch.from_numpy(rng.standard_normal((2, 64, 64, 1))
                                 .astype(np.float32)),
                torch.from_numpy(rng.integers(0, 2, (2, 64, 64))))
               for _ in range(2)]
    outs = {}
    for where in ("cpu", dev):
        model = UNet(num_classes=2, base_features=BASE, use_se=True)
        state = create_state(model, seed=SEED, device=where)
        step = make_train_step(model, 2, compute_dtype=_dtype(dtype))
        outs[str(where)] = [{k: v.cpu() for k, v in
                             step(state, x.to(where), y.to(where)).items()}
                            for x, y in batches]
    cpu, card = outs["cpu"], outs[str(dev)]
    rel = [abs(float(card[i]["loss"]) - float(cpu[i]["loss"]))
           / abs(float(cpu[i]["loss"])) for i in range(2)]
    same = all(torch.equal(card[0][k], cpu[0][k])
               for k in ("tp", "fp", "fn", "correct", "valid"))
    moved = float((card[0]["correct"] - cpu[0]["correct"]).abs().sum()
                  / cpu[0]["valid"].sum())
    bars = (1e-4, 5e-4, 0.0) if dtype == "float32" else BF16_CARD_VS_CPU
    log(f"train step card vs CPU (U-Net-CA base {BASE}, 64^2 b2, {dtype}, "
        f"the same weights and batches): losses "
        f"{float(card[0]['loss']):.7f} / {float(cpu[0]['loss']):.7f} (rel "
        f"{rel[0]:.3g}, bar {bars[0]}), {float(card[1]['loss']):.7f} / "
        f"{float(cpu[1]['loss']):.7f} (rel {rel[1]:.3g}, bar {bars[1]}); "
        f"step 1 counts {'equal' if same else 'differ'}, correct pixels "
        f"moved {moved:.3g} (bar {bars[2]})")
    if not (rel[0] <= bars[0] and rel[1] <= bars[1] and moved <= bars[2]
            and (same or dtype != "float32")):
        raise AssertionError(f"the {dtype} train step on the card disagrees "
                             "with the CPU")


def train_bf16_checks(dev) -> None:
    """U-Net-CA (base ``BASE``) at its preset shape in bf16: 5 steps on one
    batch give finite losses, the last below the first; the parameters,
    their gradients and Adam's state stay f32."""
    import torch
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.train.engine import create_state, make_train_step

    model = UNet(num_classes=2, base_features=BASE, use_se=True)
    state = create_state(model, seed=SEED, device=dev)
    step = make_train_step(model, 2, compute_dtype=torch.bfloat16)
    data = synthetic_batch(BATCH, 128, seed=SEED + 31)
    x = torch.from_numpy(data["image"]).to(dev)
    m = torch.from_numpy(data["mask"]).to(dev)
    losses = [float(step(state, x, m)["loss"]) for _ in range(5)]
    dtypes = {p.dtype for p in model.parameters()} \
        | {p.grad.dtype for p in model.parameters() if p.grad is not None} \
        | {v.dtype for st in state.optimizer.state.values()
           for k, v in st.items() if k != "step"}
    log(f"bf16 train step U-Net-CA base {BASE}, 128^2 b{BATCH}, one batch 5 "
        f"times: losses {[round(v, 6) for v in losses]}; parameters, "
        f"gradients and Adam state {sorted(str(d) for d in dtypes)}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"bf16 losses {losses}")
    if dtypes != {torch.float32}:
        raise AssertionError(f"bf16 training state dtypes {dtypes}")


def fit_bf16(dev) -> None:
    """``fit`` of U-Net-CA for 2 epochs in bf16 on ``train_fit``'s data:
    seconds, finite losses, the train loss falling, f32 weights."""
    import torch
    from insarseg_torch.config import get_preset
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.train.engine import create_state, fit

    cfg = get_preset(TRAIN_PRESET, num_epochs=2, log_every_steps=100,
                     compute_dtype="bfloat16")
    size, b = cfg.image_size, cfg.batch_size
    train = [synthetic_batch(b, size, seed=SEED + 10 + i)
             for i in range(TRAIN_STEPS)]
    val = [synthetic_batch(b, size, seed=SEED + 20 + i)
           for i in range(VAL_STEPS)]
    model = UNet(num_classes=2, base_features=BASE, use_se=True)
    state = create_state(model, cfg.learning_rate, seed=cfg.seed, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = fit(model, cfg, train, val, state=state, verbose=False,
               device=dev)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    losses = [h[k] for h in hist for k in ("train_loss", "val_loss")]
    log(f"fit bf16: {TRAIN_PRESET} (U-Net-CA base {BASE}, {size}^2 b{b}, "
        f"{TRAIN_STEPS} steps and {VAL_STEPS} validation batches an epoch), "
        f"2 epochs in {sec:.3f} s (host clock, the first steps' cuDNN "
        f"set-up included); history {json.dumps(hist)}")
    if not np.all(np.isfinite(losses)) or \
            not hist[-1]["train_loss"] < hist[0]["train_loss"]:
        raise AssertionError(f"fit bf16: losses {losses}")
    if {t.dtype for t in model.state_dict().values()} \
            - {torch.float32, torch.int64}:
        raise AssertionError("fit bf16 left non-f32 weights")


def _max_diff(a, b) -> float:
    """The largest |a - b| over two state_dicts' float tensors."""
    import torch

    worst = 0.0
    for k, v in a.items():
        if torch.is_floating_point(v):
            worst = max(worst, float((v.double() - b[k].double()).abs()
                                     .max()))
        elif not torch.equal(v, b[k]):
            return float("inf")
    return worst


def remat_on_card(dev) -> None:
    """Remat against no remat on the card, under
    ``cudnn.deterministic``: U-Net-CA (base ``BASE``), 2 steps at 128^2 b8
    from one seeded init, in f32 and bf16, three runs each (no remat
    twice, remat once). The weights, BN statistics and Adam state after
    remat may differ from no remat by at most what the two runs without it
    differ by (0 when those agree bit for bit)."""
    import torch
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.train.engine import create_state, make_train_step

    batches = [synthetic_batch(BATCH, 128, seed=SEED + 60 + i)
               for i in range(2)]
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dtype in ("float32", "bfloat16"):
            runs = []
            for remat in (False, False, True):
                model = UNet(num_classes=2, base_features=BASE, use_se=True,
                             remat=remat)
                state = create_state(model, seed=SEED, device=dev)
                step = make_train_step(model, 2, compute_dtype=_dtype(dtype))
                for b in batches:
                    out = step(state, torch.from_numpy(b["image"]).to(dev),
                               torch.from_numpy(b["mask"]).to(dev))
                adam = {f"{i}/{k}": v for i, st in
                        state.optimizer.state.items() for k, v in st.items()}
                runs.append(({k: v.detach().cpu() for k, v in
                              model.state_dict().items()},
                             {k: v.detach().cpu() for k, v in adam.items()},
                             float(out["loss"])))
            base = _max_diff(runs[0][0], runs[1][0]), \
                _max_diff(runs[0][1], runs[1][1])
            got = _max_diff(runs[0][0], runs[2][0]), \
                _max_diff(runs[0][1], runs[2][1])
            log(f"remat on the card ({dtype}, cudnn.deterministic, 2 steps "
                f"at 128^2 b{BATCH}): no remat vs no remat, weights and "
                f"statistics {base[0]:.3g}, Adam state {base[1]:.3g}; remat "
                f"vs no remat {got[0]:.3g}, {got[1]:.3g}; last losses "
                f"{[r[2] for r in runs]}")
            if got[0] > base[0] or got[1] > base[1]:
                raise AssertionError(f"remat ({dtype}) differs from no remat "
                                     "by more than two steps without it")
    finally:
        torch.backends.cudnn.deterministic = saved


def train_path(dev, power_line: str, phase) -> None:
    import torch

    train_fit(dev)
    phase("training: fit, checkpoints, resume")
    # 5 steps a repeat at 128^2, 2 at 512^2 (a step there is ~310 ms and
    # its repeats agree within 0.1%)
    steps = {}
    for dtype in ("float32", "bfloat16"):
        for size, n in ((128, 5), (HW, 2)):
            steps[(dtype, size, False)] = train_step_timing(
                dev, size, BATCH, power_line, n, dtype)
            torch.cuda.empty_cache()
        steps[(dtype, HW, True)] = train_step_timing(
            dev, HW, BATCH, power_line, 2, dtype, remat=True, profile=False)
        torch.cuda.empty_cache()
    log(f"train step U-Net-CA base {BASE} (dtype, size, remat): ms and "
        "peak GiB "
        + json.dumps({f"{d} {s} {'remat' if r else 'plain'}": v
                      for (d, s, r), v in steps.items()}))
    phase("training: the train step timed (f32, bf16, remat), without "
          "syncs")
    train_card_vs_cpu(dev)
    train_card_vs_cpu(dev, "bfloat16")
    phase("training: card vs CPU (f32, bf16)")
    train_bf16_checks(dev)
    fit_bf16(dev)
    phase("training: bf16 steps and fit")
    remat_on_card(dev)
    phase("training: remat against no remat on the card")


# The CLI phase: the commands users run, on files, through
# ``insarseg_torch.cli.main`` on the card (no --device: cuda)
CLI_UNET = ["--preset", "unet-channelattention"]  # base 64, 128^2 b8
CLI_FCN = ["--preset", "pspnet-channelattention"]  # FCN-ResNet50-CA, 64^2 b128
# the kernels each predict of the phase launches: U-Net-CA's int8 engine
# (H-s2d) and FCN-CA's
CLI_UNET_KERNELS = ("int8_conv3x3_epilogue", "se_squeeze_i8", "se_excite_i8",
                    "maxpool2x2_i8", "maxpool_exit_s2d_i8", "up_concat_i8")
CLI_FCN_KERNELS = ("int8_conv_epilogue", "se_residual_i8", "se_squeeze_i8",
                   "stem_pool_i8")
CLI_AGREE = 0.9999  # batched against single-scene predict, on the card


def cli(argv, timings, checked, label=None, check=True):
    """One CLI command in this process (its own exit code must be 0), every
    kernel call in it held against its plain version (``checked_calls``,
    into ``checked``; none with ``check=False``); returns what it printed.
    Its wall seconds, checks included, and the checks' seconds go into
    ``timings``. Fails unless each kernel was checked at least as often as
    it launched."""
    import io
    from contextlib import redirect_stdout

    import torch
    from insarseg_torch import kernels as K
    from insarseg_torch.cli import main

    buf = io.StringIO()
    before = dict(K.LAUNCHES)
    mine = {}
    t0 = time.perf_counter()
    with redirect_stdout(buf), \
            (checked_calls(mine) if check else contextlib.nullcontext()):
        rc = main(argv)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    out = buf.getvalue()
    check_sec = sum(c["seconds"] for c in mine.values())
    timings.append((label or " ".join(argv[:3]), sec, check_sec))
    log(f"  [{sec:.2f} s, {check_sec:.2f} s of it checking "
        f"{sum(c['calls'] for c in mine.values())} kernel calls] "
        f"insarseg_torch.cli {' '.join(argv)}")
    for line in out.strip().splitlines()[-3:]:
        log("    " + line)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} exited with {rc}:\n{out}")
    if not check:
        return out
    for k, n in K.LAUNCHES.items():
        done = mine.get(k, {"calls": 0})["calls"]
        if n - before[k] > done:
            raise AssertionError(f"cli {argv[0]}: {k} launched "
                                 f"{n - before[k]} times, {done} checked")
    for k, c in mine.items():
        if k not in checked:
            checked[k] = dict(c)
            continue
        for f in ("calls", "differing", "elements", "seconds"):
            checked[k][f] += c[f]
        checked[k]["batches"] |= c["batches"]
        checked[k]["max_abs_err"] = max(checked[k]["max_abs_err"],
                                        c["max_abs_err"])
    return out


def write_scene(path, h, w, seed) -> None:
    """A seeded smooth grayscale scene file."""
    from PIL import Image

    x = smooth_batch(np.random.default_rng(seed), 1, h, w)[0, ..., 0]
    u8 = np.clip((x * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    Image.fromarray(u8, "L").save(path)


def cli_metrics(out):
    import ast

    res = ast.literal_eval(out.strip().splitlines()[-1])
    if not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"non-finite metrics {res}")
    return res


def cli_path(power_line: str) -> dict:
    """The ``cli`` phase: train / eval / predict / export-torch at full
    width on the card from a synthetic VOC tree and scene files, every
    kernel call held against its plain version. Returns the kernel
    launches of its int8 predicts (counters set to 0 just before each and
    read just after) and, per kernel, the calls checked."""
    import importlib.util
    import os
    import tempfile

    from insarseg_torch import kernels as K
    from insarseg_torch.data.synthetic import make_synthetic_voc

    if importlib.util.find_spec("PIL") is None:
        raise AssertionError("the cli phase reads and writes image files "
                             "and needs PIL, which this machine lacks")
    import PIL
    from PIL import Image

    log(f"cli phase (PIL {PIL.__version__}) on {power_line}")
    timings, launches, checked = [], {}, {}
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            make_synthetic_voc("voc_unet", n_train=16, n_val=8, size=128,
                               seed=SEED)
            make_synthetic_voc("voc_fcn", n_train=136, n_val=8, size=64,
                               seed=SEED + 1)
            make_synthetic_voc("voc_one", n_train=1, n_val=1, size=64,
                               seed=SEED + 2)
            write_scene("s1.png", 1024, 1024, SEED + 50)
            write_scene("s2.png", 1024, 1024, SEED + 51)
            write_scene("s3.png", 1536, 1024, SEED + 52)

            # U-Net-CA: train 2 epochs on the native loader, resume to 3
            unet = [*CLI_UNET, "--voc-root", "voc_unet", "--native",
                    "--model-save-path", "ck_unet/m", "--metrics-save-path",
                    "unet.json"]
            cli(["train", *unet, "--num-epochs", "2"], timings, checked)
            cli(["train", *unet, "--num-epochs", "3", "--resume"], timings,
                checked, "train --resume")
            hist = json.load(open("unet.json"))
            keys = {f"{p}_{k}" for p in ("train", "val")
                    for k in ("loss", "acc", "miou", "mpa", "mf1")}
            if [h["epoch"] for h in hist] != [1, 2, 3] or \
                    not all(keys <= set(h) for h in hist) or \
                    not all(np.isfinite(h[k]) for h in hist for k in keys):
                raise AssertionError(f"U-Net-CA history {hist}")
            if not {"best.pt", "latest.pt"} <= set(os.listdir("ck_unet/m")):
                raise AssertionError("no best / latest checkpoint")
            log(f"  U-Net-CA losses: train "
                f"{[round(h['train_loss'], 5) for h in hist]}, val "
                f"{[round(h['val_loss'], 5) for h in hist]}")

            # one epoch in bf16 and one with remat; the bf16 checkpoint
            # scored in bf16
            for flags, stem in ((["--compute-dtype", "bfloat16"], "bf16"),
                                (["--remat", "true"], "remat")):
                cli(["train", *CLI_UNET, "--voc-root", "voc_unet", *flags,
                     "--num-epochs", "1", "--model-save-path",
                     f"ck_{stem}/m", "--metrics-save-path", f"{stem}.json"],
                    timings, checked, f"train {' '.join(flags)}")
                h = json.load(open(f"{stem}.json"))[0]
                if not (np.isfinite(h["train_loss"])
                        and np.isfinite(h["val_loss"])):
                    raise AssertionError(f"train {flags}: {h}")
                log(f"  U-Net-CA {stem}: train loss {h['train_loss']:.5f}, "
                    f"val loss {h['val_loss']:.5f}")
            m_b16 = cli_metrics(cli(
                ["eval", *CLI_UNET, "--voc-root", "voc_unet", "--checkpoint",
                 "ck_bf16/m", "--compute-dtype", "bfloat16"], timings,
                checked, "eval module bf16"))
            log(f"  U-Net-CA bf16 checkpoint, bf16 eval: val mIoU "
                f"{m_b16['val_miou']:.5f}")

            # scored on the module and the int8 engine (calibrated on the
            # train split), the int8 engine saved as an artifact
            ev = [*CLI_UNET, "--voc-root", "voc_unet", "--checkpoint",
                  "ck_unet/m"]
            m_mod = cli_metrics(cli(["eval", *ev], timings, checked,
                                    "eval module"))
            m_i8 = cli_metrics(cli(["eval", *ev, "--engine", "int8",
                                    "--calib-split", "train",
                                    "--save-engine", "A"], timings, checked,
                                   "eval int8 --save-engine"))
            log(f"  U-Net-CA val mIoU: module {m_mod['val_miou']:.5f}, "
                f"int8 {m_i8['val_miou']:.5f}")

            # three scenes, two of one shape through the batched stitch
            pred = [*CLI_UNET, "--engine-artifact", "A.npz"]
            K.reset_launches()
            cli(["predict", *pred, "--input", "s1.png", "s2.png", "s3.png",
                 "--output", "multi"], timings, checked, "predict 3 scenes")
            launches["unet"] = {k: n for k, n in K.LAUNCHES.items() if n}
            log(f"  launches of the U-Net-CA predict: {launches['unet']}")
            for k in CLI_UNET_KERNELS:
                if not launches["unet"].get(k):
                    raise AssertionError(f"{k} never launched in predict")
            for s in ("s1", "s2", "s3"):
                cli(["predict", *pred, "--input", f"{s}.png", "--output",
                     f"{s}_one.png"], timings, checked, f"predict {s} alone")
                a = np.asarray(Image.open(f"multi/{s}_pred.png"))
                b = np.asarray(Image.open(f"{s}_one.png"))
                n_diff = int((a != b).sum())
                agree = 1 - n_diff / a.size
                log(f"  {s} {a.shape}: batched vs alone, {n_diff} of "
                    f"{a.size} pixels differ (agreement {agree:.6f}, bar "
                    f"{CLI_AGREE}); classes {np.unique(a).tolist()}")
                if a.shape != b.shape or agree < CLI_AGREE:
                    raise AssertionError(f"{s}: batched predict disagrees")

            # FCN-ResNet50-CA at its preset (64^2 b128): one epoch, then an
            # int8 predict calibrated on the scene; export-torch and the
            # exported file predict the same PNG
            fcn = [*CLI_FCN, "--voc-root", "voc_fcn", "--model-save-path",
                   "ck_fcn/m", "--metrics-save-path", "fcn.json"]
            cli(["train", *fcn, "--num-epochs", "1"], timings, checked,
                "train FCN-CA")
            fh = json.load(open("fcn.json"))
            if not (np.isfinite(fh[0]["train_loss"])
                    and np.isfinite(fh[0]["val_loss"])):
                raise AssertionError(f"FCN-CA history {fh}")
            log(f"  FCN-CA losses: train {fh[0]['train_loss']:.5f}, val "
                f"{fh[0]['val_loss']:.5f}")
            K.reset_launches()
            cli(["predict", *CLI_FCN, "--checkpoint", "ck_fcn/m",
                 "--engine", "int8", "--input", "s1.png", "--output",
                 "fcn_s1.png"], timings, checked, "predict FCN-CA int8")
            launches["fcn"] = {k: n for k, n in K.LAUNCHES.items() if n}
            log(f"  launches of the FCN-CA predict: {launches['fcn']}")
            for k in CLI_FCN_KERNELS:
                if not launches["fcn"].get(k):
                    raise AssertionError(f"{k} never launched in predict")
            cli(["export-torch", *CLI_FCN, "--checkpoint", "ck_fcn/m",
                 "--output", "fcn.pth"], timings, checked)
            cli(["predict", *CLI_FCN, "--torch-checkpoint", "fcn.pth",
                 "--engine", "int8", "--input", "s1.png", "--output",
                 "fcn_pth.png"], timings, checked,
                "predict --torch-checkpoint")
            a = np.asarray(Image.open("fcn_s1.png"))
            b = np.asarray(Image.open("fcn_pth.png"))
            if not np.array_equal(a, b):
                raise AssertionError("export-torch: the exported file "
                                     f"predicts {int((a != b).sum())} "
                                     "other pixels")
            log("  FCN-CA: export-torch -> --torch-checkpoint predicts the "
                "same PNG bit for bit")

            # the true PSPNet takes a train step at batch 1 (one value per
            # channel in its 1x1 bin)
            cli(["train", "--preset", "pspnet-true", "--batch-size", "1",
                 "--voc-root", "voc_one", "--num-epochs", "1",
                 "--model-save-path", "ck_psp/m", "--metrics-save-path",
                 "psp.json"], timings, checked, "train pspnet-true b1")
            ph = json.load(open("psp.json"))
            if not np.isfinite(ph[0]["train_loss"]):
                raise AssertionError(f"pspnet-true at batch 1: {ph}")
        finally:
            os.chdir(old)
    log("cli command seconds (checks included, checks): " + json.dumps(
        {k: [round(v, 3), round(c, 3)] for k, v, c in timings}))
    log("cli kernel calls checked against their plain versions: "
        + json.dumps(checked, default=sorted))
    for k in set(CLI_UNET_KERNELS) | set(CLI_FCN_KERNELS):
        if not checked.get(k, {}).get("calls"):
            raise AssertionError(f"{k}: no call checked in the cli phase")
    total = {}
    for per in launches.values():
        for k, n in per.items():
            total[k] = total.get(k, 0) + n
    return total, checked


# ---------------------------------------------------------------------------
# 7. the stream phase
# ---------------------------------------------------------------------------

STREAM_TILE, STREAM_OVERLAP = HW, HW // 8  # the CLI's defaults, 512 / 64
STREAM_AGREE = 0.99999  # argmax, stream against the in-memory path
STREAM_LOGIT_BAR = 1e-5  # x max|logit|, stream against the in-memory path
STREAM_PEAK_BAR = 0.02  # the peaks at H = 8192 and 16384, relative


def scene_file(path, h, w, seed, dev):
    """A seeded smooth (H, W) uint8 scene (``smooth_batch``'s coarse noise,
    bilinear upsampled on the card, mapped as ``write_scene`` maps it),
    written to a ``.npy`` file; returns its memory map."""
    import torch
    import torch.nn.functional as F

    coarse = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, 1, h // 8, w // 8)).astype(np.float32)).to(dev)
    x = F.interpolate(coarse, size=(h, w), mode="bilinear",
                      align_corners=False)[0, 0]
    u8 = ((x * 0.5 + 0.5) * 255).clamp_(0, 255).to(torch.uint8).cpu()
    del x
    mm = np.lib.format.open_memmap(path, "w+", np.uint8, (h, w))
    mm[:] = u8.numpy()
    mm.flush()
    del mm
    return np.load(path, mmap_mode="r")


def balanced_model(name, attention, dev):
    """``build_model``'s seeded weights with the classifier's class-1 bias
    lowered by the median logit margin (class 1 less class 0) of the
    module on a smooth 512^2 batch: random weights favour one class, and
    the stream's checks want both about evenly."""
    import torch

    model = build_model(name, attention).to(dev)
    x = torch.from_numpy(smooth_batch(np.random.default_rng(SEED + 5), 2,
                                      HW, HW)).permute(0, 3, 1, 2).to(dev)
    with torch.inference_mode():
        y = model(x)
        bias = [v for k, v in model.state_dict().items()
                if k.endswith("bias") and tuple(v.shape) == (2,)][-1]
        bias[1] -= (y[:, 1] - y[:, 0]).median()
    return model.cpu()


class StreamRuns:
    """The phase's streams: each one's kernel launches counted from 0 just
    before it and read just after, summed into ``launches``; ``batches``
    holds per kernel the engine batches of the streams that launched it,
    ``last`` those of the latest stream."""

    def __init__(self):
        self.launches = {}
        self.batches = {}
        self.last = set()

    def add(self, batches=()):
        from insarseg_torch import kernels as K

        for k, n in K.LAUNCHES.items():
            self.launches[k] = self.launches.get(k, 0) + n
            if n:
                self.batches.setdefault(k, set()).update(batches)

    def __call__(self, predict, scene, batch_size, emit="argmax",
                 writer=None):
        from insarseg_torch import kernels as K
        from insarseg_torch.data.serve import stream_scene_inference

        seen = set()

        def forward(x):
            seen.add(x.shape[0])
            return predict(x)

        h, w = scene.shape
        K.reset_launches()
        out = stream_scene_inference(
            forward, scene, (h, w), 2, tile=STREAM_TILE,
            overlap=STREAM_OVERLAP, batch_size=batch_size, writer=writer,
            emit=emit)
        self.add(seen)
        self.last = seen
        return out


def stream_at_scale(runs, predict, scene, batch_size, path, label,
                    power_line, traced=False):
    """One stream of ``scene`` into a uint8 ``.npy`` memory map (argmax on
    the card) at ``batch_size``: seconds, tiles/s, the peak of
    ``max_memory_allocated`` (reset before), and with ``traced`` the
    device idle share of a ``torch.profiler`` window over the whole
    stream. Both classes must come out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from insarseg_torch.data.stitch import plan_tiles

    h, w = scene.shape
    n_tiles = len(plan_tiles(h, w, STREAM_TILE, STREAM_OVERLAP))
    out = np.lib.format.open_memmap(path, "w+", np.uint8, (h, w))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    idle = None
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if traced else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        runs(predict, scene, batch_size, writer=out)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if traced:
        idle = device_idle_share(prof)
    counts = np.bincount(np.asarray(out).ravel(), minlength=2)
    del out
    log(f"  {label}: {h}x{w} uint8 memmap, {n_tiles} tiles, batch_size "
        f"{batch_size} (engine batch {sorted(runs.last)}): {sec:.3f} s, "
        f"{n_tiles / sec:.1f} tiles/s, peak allocated {peak / 2**30:.4f} "
        f"GiB ({peak} B)"
        + ("" if not traced else ", device idle share under the profiler "
           + ("not measured" if idle is None else f"{100 * idle:.2f}%"))
        + f"; classes {counts.tolist()}; on {power_line}")
    if len(counts) != 2 or not counts.all():
        raise AssertionError(f"{label}: the stream's classes are {counts}")
    return sec, peak


def checked_strip(runs, checked, predict, scene, batch_size, label):
    """The top rows of ``scene`` that ``batch_size`` puts in one call (its
    ``G`` row bands, full width) streamed with every kernel call held
    against its plain version (``checked_calls``): the engine batch that
    ``scene``'s own stream at ``batch_size`` runs, checked."""
    from insarseg_torch.data.serve import bands_per_call
    from insarseg_torch.data.stitch import tile_starts

    h, w = scene.shape
    stride = STREAM_TILE - STREAM_OVERLAP
    g = bands_per_call(len(tile_starts(h, STREAM_TILE, stride)),
                       len(tile_starts(w, STREAM_TILE, stride)), batch_size)
    rows = STREAM_TILE + (g - 1) * stride
    t0 = time.perf_counter()
    with checked_calls(checked):
        runs(predict, scene[:rows], batch_size)
    log(f"  {label}: {rows}x{w} strip at batch_size {batch_size} (engine "
        f"batch {sorted(runs.last)}), every kernel call checked against "
        f"its plain version, in {time.perf_counter() - t0:.1f} s")


def stream_agreement(runs, dev, label, predict, scene):
    """The stream (``emit="logits"`` and ``"argmax"``, batch_size 32) of a
    uint8 scene, normalized on the card, against
    ``sliding_window_inference_batched`` on the same engine with the
    host's ``normalize_scene`` of it: logits within ``STREAM_LOGIT_BAR``
    x max|logit|, argmax equal on ``STREAM_AGREE`` of the pixels."""
    import torch
    from insarseg_torch.cli import normalize_scene
    from insarseg_torch.config import Config
    from insarseg_torch.data.stitch import sliding_window_inference_batched

    h, w = scene.shape
    x = normalize_scene(np.asarray(scene), Config())
    with torch.inference_mode():
        ref = sliding_window_inference_batched(
            lambda t: predict(t).to(torch.float32), x[None],
            tile=STREAM_TILE, overlap=STREAM_OVERLAP, batch_size=32,
            device=dev)[0].cpu().numpy()
    logits = runs(predict, scene, 32, emit="logits")
    classes = runs(predict, scene, 32, emit="argmax")
    scale = float(np.abs(ref).max())
    err = float(np.abs(logits - ref).max())
    n_logits = int((logits != ref).sum())
    n_px = int((classes != ref.argmax(-1)).sum())
    agree = 1 - n_px / classes.size
    log(f"  {label} {h}x{w}: stream vs in-memory, logits max |delta| "
        f"{err:.3g} = {err / scale:.3g} x max|logit| ({scale:.4g}; bar "
        f"{STREAM_LOGIT_BAR}), {n_logits} of {ref.size} logits differ; "
        f"argmax {n_px} of {classes.size} pixels differ (agreement "
        f"{agree:.7f}, bar {STREAM_AGREE}); classes "
        f"{np.bincount(classes.ravel(), minlength=2).tolist()}")
    if not (logits.shape == ref.shape and err <= STREAM_LOGIT_BAR * scale
            and agree >= STREAM_AGREE):
        raise AssertionError(f"{label}: the stream disagrees with the "
                             "in-memory path")


def stream_path(dev, power_line: str):
    """The ``stream`` phase: ``data/serve.py::stream_scene_inference`` and
    ``predict --stream`` on the card, on seeded smooth uint8 scenes in
    ``.npy`` memory maps in a temporary directory. Every engine batch a
    stream of the phase runs is held against the plain versions in a
    checked stream at that batch. Returns the kernel launches of its
    streams (counters from 0 around each) and, per kernel, the calls
    checked against their plain versions."""
    import os
    import tempfile

    import torch
    from PIL import Image
    from insarseg_torch import kernels as K
    from insarseg_torch.cli import stream_calib
    from insarseg_torch.config import Config
    from insarseg_torch.engines import make_engine, pack_engine
    from insarseg_torch.engines_io import save_artifact

    log(f"stream phase on {power_line}")
    runs = StreamRuns()
    checked = {}
    t_start = time.perf_counter()
    engines = {}
    for name, attention in (("unet", "channel"), ("unet", "spatial"),
                            ("fcn", "channel")):
        rng = np.random.default_rng(SEED + 1)
        calib = [smooth_batch(rng, 4, HW, HW) for _ in range(2)]
        engines[(name, attention)] = make_engine(
            name, attention, balanced_model(name, attention, dev), None,
            "int8", calib_batches=calib, device=dev)
    unet = engines[("unet", "channel")]
    label = f"U-Net-CA base {BASE} int8"
    with tempfile.TemporaryDirectory() as d:
        # 1. at scale: U-Net-CA int8 (H-s2d), argmax into a memory map, at
        # batch_size 128 and 32 on scenes 16384 and 8192 wide
        big = scene_file(f"{d}/big.npy", 16384, 16384, SEED + 60, dev)
        half = scene_file(f"{d}/half.npy", 8192, 16384, SEED + 61, dev)
        narrow = half[:, :half.shape[1] // 2]
        log(f"  engines built and scenes written in "
            f"{time.perf_counter() - t_start:.1f} s")
        out = f"{d}/out.npy"
        stream_at_scale(runs, unet, half, 128, out, f"{label} (warm-up)",
                        power_line)
        _, peak_big = stream_at_scale(runs, unet, big, 128, out, label,
                                      power_line)
        _, peak_half = stream_at_scale(runs, unet, half, 128, out, label,
                                       power_line)
        stream_at_scale(runs, unet, big, 32, out, label, power_line)
        for bs in (128, 32, 32, 128):
            stream_at_scale(runs, unet, narrow, bs, out, label, power_line)
        stream_at_scale(runs, unet, big, 128, out, f"{label} (traced)",
                        power_line, traced=True)
        rel = abs(peak_big - peak_half) / max(peak_big, peak_half)
        log(f"  peak allocated at H 16384 and 8192: {peak_big} and "
            f"{peak_half} B, {100 * rel:.3f}% apart (bar "
            f"{100 * STREAM_PEAK_BAR}%)")
        if rel > STREAM_PEAK_BAR:
            raise AssertionError("the stream's device memory grows with H")
        # (the CLI's checked stream below runs 8192 wide at 128)
        for scene, bs in ((big, 128), (big, 32), (narrow, 32)):
            checked_strip(runs, checked, unet, scene, bs, label)
        del big, half, narrow
        for f in ("big.npy", "half.npy", "out.npy"):
            os.remove(f"{d}/{f}")

        # 2. against the in-memory path on the same engines; the three
        # launch every kernel. U-Net-CA's engine batch is checked on a
        # strip; the two others' streams run checked whole
        ragged = scene_file(f"{d}/a.npy", 4096, 6000, SEED + 62, dev)
        stream_agreement(runs, dev, label, unet, ragged)
        checked_strip(runs, checked, unet, ragged, 32, label)
        del ragged
        for key, lab in ((("unet", "spatial"), f"U-Net-SA base {BASE} int8"),
                         (("fcn", "channel"), "FCN-ResNet50-CA int8")):
            with checked_calls(checked):
                stream_agreement(runs, dev, lab, engines[key],
                                 scene_file(f"{d}/b.npy", 2048, 3000,
                                            SEED + 63, dev))
        del engines
        torch.cuda.empty_cache()

        # 3. the CLI: predict --stream of the .npy, every kernel call
        # checked, against the in-memory predict of the same scene as a
        # PNG, from one int8 artifact
        scene = scene_file(f"{d}/s.npy", 8192, 8192, SEED + 65, dev)
        Image.fromarray(np.asarray(scene), "L").save(f"{d}/s.png")
        art = pack_engine("unet", "channel",
                          balanced_model("unet", "channel", dev), None,
                          "int8",
                          calib_batches=stream_calib(
                              scene, STREAM_TILE, STREAM_OVERLAP, 4,
                              Config()), device=dev)
        save_artifact(f"{d}/A.npz", art)
        del art, unet
        timings = []
        pred = ["predict", *CLI_UNET, "--engine-artifact", f"{d}/A.npz"]
        K.reset_launches()
        cli([*pred, "--input", f"{d}/s.npy", "--stream", "--output",
             f"{d}/st.png"], timings, checked, "predict --stream")
        runs.add()
        cli([*pred, "--input", f"{d}/s.png", "--output", f"{d}/mem.png"],
            timings, checked, "predict (in memory)", check=False)
        a = np.asarray(Image.open(f"{d}/st.png"))
        b = np.asarray(Image.open(f"{d}/mem.png"))
        n_px = int((a != b).sum())
        agree = 1 - n_px / b.size
        log(f"  {scene.shape[0]}x{scene.shape[1]} predict --stream vs "
            f"in-memory predict: {n_px} of "
            f"{b.size} pixels differ (agreement {agree:.7f}, bar "
            f"{STREAM_AGREE}); classes {np.unique(a).tolist()}; seconds "
            "(the stream's with its checks) "
            + json.dumps({k: round(v, 3) for k, v, _ in timings}))
        if a.shape != scene.shape or agree < STREAM_AGREE:
            raise AssertionError("predict --stream disagrees with predict")
    log(f"  stream launches: {runs.launches}; engine batches "
        + json.dumps(runs.batches, default=sorted))
    log("  kernel calls checked against their plain versions: "
        + json.dumps(checked, default=sorted))
    for k in KERNELS:
        if not runs.launches.get(k):
            raise AssertionError(f"{k} never launched in the stream phase")
        missing = runs.batches.get(k, set()) - checked.get(
            k, {"batches": set()})["batches"]
        if missing:
            raise AssertionError(f"stream: {k} launched at engine batches "
                                 f"{sorted(missing)}, never checked there")
    torch.cuda.empty_cache()
    return runs.launches, checked


def run(dev, power_line: str, phase) -> list:
    """Phases 2-4 on ``dev``; returns the kernel table."""
    import torch
    from insarseg_torch.models import resnet_int8, unet_int8

    # 2a. kernels against their plain versions at fixed shapes
    check_fixed_shapes(dev)
    check_resnet_fixed_shapes(dev)
    phase("fixed-shape checks")

    images = smooth_batch(np.random.default_rng(SEED + 2), BATCH, HW, HW)
    scene = smooth_batch(np.random.default_rng(SEED + 3), 1, 2 * HW,
                         2 * HW)[0]
    cases = {wrapper: [] for wrapper, _, _ in KERNELS.values()}
    launches, float_counts = {}, {}
    for name, attention, label, corr_bar, want in PATHS:
        # 3a. the engines at full width (packing launches no kernel)
        model = build_model(name, attention)
        rng = np.random.default_rng(SEED + 1)
        calib = [smooth_batch(rng, 4, HW, HW) for _ in range(2)]
        engines = build_engines(dev, name, attention, model, calib)
        phase(f"{label}: weights, packing, calibration")

        # 2b. the tensors each kernel gets in one int8 forward (512^2, b8)
        is_unet = name.startswith("unet")
        module = unet_int8 if is_unet else resnet_int8
        wrappers = [KERNELS[k][0] for k in want]
        for n, c in kernel_cases(record_calls(
                module, wrappers, engines["int8"], images), label).items():
            cases[n] += c
        phase(f"{label}: recording the kernels' arguments")

        # 3b. the main path, counters from 0; a scene through U-Net-CA
        # and FCN-CA
        with_scene = (name, attention) in (("unet", "channel"),
                                           ("fcn", "channel"))
        launches[label] = run_path(
            engines, images, dev, corr_bar, want, label, power_line,
            scene=scene if with_scene else None)
        phase(f"{label}: main path")
        batch_invariance(engines["int8"], dev, label)
        float_counts[label] = float_batch_counts(engines, dev, label)
        x_dev = torch.from_numpy(images).to(dev)
        check_no_sync(engines["int8"], x_dev, label)
        forward_turns(engines["int8"], x_dev, label, power_line,
                      absent=UNET_ABSENT if is_unet else ())
        if name == "pspnet":
            ppm_turns(engines["int8"], x_dev, power_line)
            psp_batched_head_count(engines["int8"], dev, label)
        del x_dev
        phase(f"{label}: int8 forward batch-invariant, without syncs, in "
              "turns with them")
        if is_unet:
            k6_agreement(engines["int8"], images, label,
                         K6_AGREE[(name, attention)])
            phase(f"{label}: int8 against K6's plain version")
        card_vs_cpu(dev, name, attention, model, calib, images)
        phase(f"{label}: card vs CPU")
        if (name, attention) == ("unet", "channel"):
            unet_standard_layout(dev, model, calib, images, engines["int8"],
                                 power_line)
            phase(f"{label}: int8 in the standard layout")
        del engines, model
        torch.cuda.empty_cache()

    log(f"each kernel on the tensors of one int8 forward of each main path "
        f"({HW}^2 b{BATCH}):")
    table = []
    for kname, (wrapper, source, replaces) in KERNELS.items():
        row = kernel_row(kname, "insarseg_torch/csrc/" + source, replaces,
                         cases.pop(wrapper))
        row["launches"] = sum(n[kname] for n in launches.values())
        if row["launches"] == 0:
            raise AssertionError(f"kernel {kname} never launched on the main "
                                 "paths")
        table.append(row)
    torch.cuda.empty_cache()
    log("float engines, logits of 9 tiles among 18 that differ from alone "
        "(count, of, argmax agreement): " + json.dumps(float_counts))
    phase("kernel timing")

    # 4. the other ResNet cells, once each through int8 (512^2, b2)
    for name, attention in (("deeplabv3", "channel"),
                            ("deeplabv3", "spatial"), ("fcn", "none"),
                            ("fcn", "spatial"), ("pspnet", "none"),
                            ("pspnet", "spatial")):
        model = build_model(name, attention)
        rng = np.random.default_rng(SEED + 1)
        calib = [smooth_batch(rng, 2, HW, HW) for _ in range(2)]
        log(f"{name}-{attention}: int8 vs serve f32 ({HW}^2, b2)")
        serve_and_check(build_engines(dev, name, attention, model, calib,
                                      full=False), images[:2], dev, 0.97)
        del model
        torch.cuda.empty_cache()
    phase("the other ResNet cells")
    return table



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on "
              "one NVIDIA GPU", file=sys.stderr)
        return 2
    from insarseg_torch import kernels as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = t_phase = time.perf_counter()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    def phase(what):
        nonlocal t_phase
        now = time.perf_counter()
        log(f"[{now - t_phase:.1f} s] {what}")
        t_phase = now

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
    check_sass()
    power_line = nvidia_smi_line()
    log(f"card: {power_line}")
    phase("build")

    table = run(dev, power_line, phase)
    train_path(dev, power_line, phase)
    cli_launches, cli_checked = cli_path(power_line)
    for row in table:
        row["cli_launches"] = cli_launches.get(row["name"], 0)
        c = cli_checked.get(row["name"], {})
        row["cli_checked"] = c.get("calls", 0)
        row["cli_max_abs_err"] = c.get("max_abs_err")
    phase("cli: train, eval, predict, export-torch")
    stream_launches, stream_checked = stream_path(dev, power_line)
    for row in table:
        row["stream_launches"] = stream_launches.get(row["name"], 0)
        row["stream_checked"] = stream_checked.get(row["name"], {}).get(
            "calls", 0)
    phase("stream: scenes larger than memory, predict --stream")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}), flush=True)
    print(power_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
