#!/usr/bin/env python3
"""Smoke run of the insarseg_torch port on one NVIDIA GPU (an H100 SXM).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device (the mesh phase uses more where present) and
exits non-zero, printing no result, without one. It imports the port
only (no JAX, nothing of ``insarseg``) and:

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
   without remat show, 0 if they agree bit for bit); before all that,
   K8a-K9b (the DoubleConv train epilogue): their registers, spills,
   resident blocks and bytes in flight an SM (``bn_kernel_info``), their
   results against their plain versions at fixed shapes, and every call of
   a bf16 512^2 b8 step checked, then timed on its tensors (each call's
   line with dout's layout, whether ``_like`` copied it and the kernels
   the wrapper launched; the sums by level); the fixed shapes hold every
   mode (relu, none, residual) and f64 (``BN_MODE_SHAPES``); then the
   ResNet families' bf16 steps at 512^2 (``RESNET_TRAIN``: DeepLabV3 b8,
   FCN-CA and PSPNet-CA b2), each BatchNorm one launch of each kernel in
   its mode (``RESNET_MODES``), every call checked, DeepLabV3's kernel ms
   by mode from a profiler window beside their bounds, and its step in
   turns with the library route it replaced (``resnet_step_turns``:
   cuDNN's BatchNorm, ``tools/bn_ab.py::library_route``) at bf16 512^2 and
   f32 128^2 b8 (ms, peak, idle).
   ``python3 chip_smoke.py --only train`` builds the kernels and runs
   this phase alone;
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
8. runs the data mesh (``insarseg_torch/parallel/mesh.py``), the
   ``mesh`` phase (``chip_smoke.py::mesh_path``): serving over two
   replicas on one card (``make_mesh(devices=[cuda:0, cuda:0])``),
   U-Net-CA and FCN-ResNet50-CA at 512^2, global b16: the int8 logits
   bit-equal to one device, every kernel call of the mesh forwards
   checked against its plain version and counted, the module and serve
   engines within 1e-5 x max|logit| in f32 (their differing logits
   counted, and in bf16 with no bar); then ``parallel.launch`` on the
   card: world 1 on NCCL and world 2 on gloo (both ranks on one card),
   two SGD 0.1 f32 steps of U-Net-CA (base 64, 128^2, global b8) under
   ``cudnn.deterministic`` held to the same steps in one process, each
   from the mesh's parameters before it, at the JAX package's mesh bars
   (``MESH_BARS``: loss rtol 1e-5, counts equal, parameters 1e-4, BN
   statistics 1e-5), three bf16 steps on 2 ranks
   finite and falling, a 2-rank ``fit`` of 2 epochs with a
   ``Checkpointer`` and a resume to epoch 3 (rank 0's files, the ranks'
   histories and states equal); on a machine with more cards, also
   (``mesh_cards``): the train step on every card (NCCL; U-Net-CA bf16
   at 512^2, 8 tiles a card) timed with CUDA events against the same
   tiles a card on one card, the gradient all-reduce and the other
   collectives apart, the f32 steps held to one process's; the CLI's
   default ``train`` on every card against ``--mesh-data 1`` at two
   presets (``mesh_presets``, ms a step); U-Net-CA int8 over the cards
   at 128 tiles a card bit-equal to one card, that forward's every
   kernel call checked (its launches are the phase's), with tiles/s and
   each card's idle share; the 16384^2 stream over the cards against one
   card (seconds, equal class maps), each stream's engine batch a card
   checked on a strip first.
   ``python3 chip_smoke.py --only mesh`` builds the kernels and runs
   this phase alone;
9. runs the ``spatial`` mesh axis (the image H axis sharded,
   ``insarseg_torch/parallel/spatial.py``), the ``spatial`` phase
   (``chip_smoke.py::spatial_path``): ``parallel.launch`` world 2 on the
   card (gloo), data 1 x spatial 2, U-Net-CA and U-Net-SA (base 64,
   512^2, global b8: 256-row slabs), two SGD 0.1 f32 steps each under
   ``cudnn.deterministic`` held to one process's at ``MESH_BARS`` (a
   count may move by at most the pixels whose logits lie within
   ``TIE_BAR`` = 1e-5 x max|logit|: 2,097,152 pixels a step); the
   bf16 step's every K8a-K9b call held against its plain version, its
   launches a rank a step equal to the one-card step's; a 2-epoch
   ``fit`` (``mesh_spatial=2``) with a resume; then the forward over
   ``make_mesh(data=1, spatial=2, devices=[cuda:0, cuda:0])`` (one
   thread a slab) against one device, U-Net-CA, U-Net-SA and
   U-Net-fast-CA at 512^2 b8, f32 within 1e-5 x max|logit|, bf16
   counted; the ResNet families (``SPATIAL_RESNETS``: FCN-ResNet50-CA,
   DeepLabV3-ResNet50, PSPNet-ResNet50-CA, dropout off) take the same two
   f32 SGD steps on the two gloo ranks, held to one process's at
   ``MESH_BARS`` and ``TIE_BAR`` (a loss, count, parameter or statistic
   that misses its bar no further from the float64 steps' than
   ``FLOAT_NOISE`` x one process's f32 one; every K8a-K9b call of the
   ranks' and the one process's f32 and f64 steps checked, and each
   quantity's ``d_mesh / d_one`` printed), and their forward over the
   two slabs within 1e-4 x max|logit| in f32, bf16 counted; on a machine
   with more cards, also (``spatial_cards``) the NCCL bf16 step at data
   1 x spatial 2, 1 x 4 and 2 x 2 (U-Net-CA) and 1 x 2, 1 x 4
   (DeepLabV3-ResNet50, whose ASPP halos reach past a 16-row slab at 1 x
   4) timed against one card by CUDA events, rank 0's halo exchanges and
   all-reduces from a profiler window, the peak memory a card at 1024^2
   (U-Net-CA global b8; DeepLabV3 at the largest global batch that one
   card and spatial 2 and 4 all hold), and the CLI's ``train
   --mesh-spatial 2`` over the cards (``unet-channelattention`` and
   ``deeplabv3``). Slabs of any height (``parallel/spatial.py``'s row
   ranges): on the same gloo launch U-Net-CA and DeepLabV3-ResNet50 take
   two f32 SGD steps at 500^2 global b8 (250-row slabs) held to one
   process likewise, and U-Net-CA's bf16 step there has its every
   K8a-K9b call checked; the forward over ``make_mesh(data=1,
   spatial=4, devices=[cuda:0] * 4)`` against one device at b8 for
   U-Net-CA (500^2: 125-row slabs), U-Net-SA (496^2), U-Net-fast-CA
   (480^2), FCN-ResNet50-CA, DeepLabV3-ResNet50 and PSPNet-ResNet50-CA
   (500^2), f32 within the bars above, bf16 counted; the fixed-shape
   K8a-K9b checks hold slabs of 0, 1, 7 and 15 rows (``BN_SLAB_SHAPES``);
   with more cards U-Net-CA's NCCL bf16 step at 1 x 4 and 496^2 against
   one card and its peak a card at 992^2 against 1024^2.
   ``python3 chip_smoke.py --only spatial`` builds the kernels and runs
   this phase alone;
10. prints the kernel table as one JSON line (each row with
   ``cli_launches``, its launches in the cli phase's predicts, and
   ``cli_checked`` / ``cli_max_abs_err``, its calls checked in the cli
   phase and their largest difference from the plain version;
   ``stream_launches``, its launches in the stream phase's streams, each
   counted from 0, and ``stream_checked``; ``mesh_launches``, its
   launches in the mesh phase's int8 forwards; ``spatial_launches``, its
   launches a rank in the spatial bf16 step, and
   ``spatial_uneven_launches``, in the one at 500^2), the ``nvidia-smi`` name
   and power-limit line, and last ``{"ok": true, "device": {...}}``
   (with ``--only mesh`` / ``--only spatial``: that phase's launches as
   one JSON line in place of the kernel table).
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

def sass_text(lib=None) -> str:
    """The SASS of the kernels' library, or of the shared library ``lib``
    (``cuobjdump --dump-sass``)."""
    from pathlib import Path

    from insarseg_torch import kernels as K
    from insarseg_torch.kernels import _lib

    tool = Path(_lib._nvcc()).parent / "cuobjdump"
    lib = lib or Path(K.build_info["dir"]) / _lib.LIB_NAME
    return subprocess.run([str(tool), "--dump-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


def check_sass() -> None:
    """K1, K5a and K6 must run on the tensor cores: every conv kernel of
    the library has int8 tensor-core MMA instructions in its SASS (IGMMA,
    the ``wgmma`` form, or IMMA, the ``mma.sync`` one) and no IDP
    (``__dp4a``); every K6 kernel (``up_i8.cu``) has bf16 ``wgmma``
    instructions (HGMMA)."""
    import re

    counts, name, ops = {}, None, set()
    for line in sass_text().splitlines():
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
def spying(modules, names, on_call, keep=()):
    """While open, each call of a kernel wrapper of ``names`` that a module
    of ``modules`` holds runs as it is, then goes to ``on_call(name, args,
    out)`` with its arguments bound to the wrapper's parameter names; the
    arguments named in ``keep`` (buffers the wrapper updates in place) are
    cloned before the call and given as ``args["before"]``."""
    import inspect

    saved = [(m, n, getattr(m, n)) for m in modules for n in names
             if hasattr(m, n)]

    def spy(n, fn):
        sig = inspect.signature(fn)

        def wrapped(*args, **kwargs):
            bound_args = sig.bind(*args, **kwargs)
            bound_args.apply_defaults()
            a = dict(bound_args.arguments)
            before = {k: a[k].clone() for k in keep if k in a}
            out = fn(*args, **kwargs)
            on_call(n, dict(a, before=before) if keep else a, out)
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
    Every call of K8a-K9b (a train step's) is held too
    (``checked_bn_calls``). ``checked`` gathers per kernel name the
    calls, the engine batches
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

    with spying([unet_int8, resnet_int8], list(kernel_of), check), \
            checked_bn_calls(checked):
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
    by_path, bound_by_path = {}, {}
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
        bound_by_path[c["path"]] = bound_by_path.get(c["path"], 0.0) + bms
        log(f"  {name} [{c['path']}] {c['shape']}: {ms:.4f} ms device, "
            f"{hus:.1f} us host, {b2b:.4f} ms back to back, plain "
            f"{pms:.4f} ms, "
            f"library {'-' if lms is None else f'{lms:.4f}'} ms, "
            f"bound {bms:.4f} ms ({by})"
            + (f", {nd} of {n} codes differ" if nd else "")
            + (f"; {c['note']}" if c.get("note") else ""))
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
            "calls_timed": len(cases), "ms_by_path": by_path,
            "bound_ms_by_path": bound_by_path}


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
            f"kernel launches {launched} (the DoubleConv epilogue's "
            "K8a-K9b; the rest stock PyTorch / cuDNN ops)")
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


# ---------------------------------------------------------------------------
# 5b. the DoubleConv train epilogue's kernels (K8a / K8b / K9a / K9b)
# ---------------------------------------------------------------------------

# kernel name -> (its wrapper in insarseg_torch.kernels.bn_act, the JAX
# site it replaces); the source is csrc/bn_act.cu
BN_KERNELS = {
    "bn_stats": ("bn_stats", "insarseg/ops/layers.py:231"),
    "bn_apply_relu": ("bn_apply_relu", "insarseg/ops/layers.py:244"),
    "bn_relu_grad_stats": ("bn_relu_grad_stats",
                           "insarseg/ops/layers.py:231"),
    "bn_relu_grad_apply": ("bn_relu_grad_apply",
                           "insarseg/ops/layers.py:244"),
}
BN_OUTS = ("bn_apply_relu", "bn_relu_grad_apply")  # elementwise outputs
# The bars of K8a-K9b against their plain versions on the same inputs.
# K8a and K9a sum exact f64 terms in another order than torch's sum (block
# partials, then the slices in order), so each half of their f64 buffers
# is held within BN_SUM_BAR of its largest |value| (n u for 2^21 terms;
# readings on an H100 below 1e-15), and the running statistics K8b derives
# in f32 within BN_STAT_BAR; K8b and K9b compute each element as their
# plain versions do, so on the same buffers a bf16 element may differ by
# at most one bf16 ulp (judged no finer than at 2^-12 of the largest
# |value|) and at most BN_SHARE of the elements may differ at all (0
# measured of 1.3e9 on an H100); an f32 one within BN_F32_BAR
# of the largest |value|.
BN_SUM_BAR = 1e-10
BN_STAT_BAR = 1e-6
BN_F32_BAR = 1e-6
BN_SHARE = 1e-6
# f64 elements (the yardstick steps' BatchNorms): their terms round, so two
# sum orders move the f64 means by ulps and most elements by ulps; each
# output within BN_F64_BAR of its largest |value|, no share
BN_F64_BAR = 1e-12
# the largest reading of each bar in this run: name -> |delta| / bar scale
BN_WORST = {}
# fixed shapes: (N, C, H, W, dtype, channels-last)
BN_SHAPES = (
    (8, 64, 512, 512, "bfloat16", False), (8, 64, 512, 512, "bfloat16", True),
    (8, 1024, 32, 32, "bfloat16", False), (8, 1024, 32, 32, "bfloat16", True),
    (8, 64, 128, 128, "float32", False), (8, 64, 128, 128, "float32", True),
    (8, 1, 512, 512, "bfloat16", False), (8, 1, 256, 256, "float32", False),
    (4, 5, 1, 1, "bfloat16", False), (4, 5, 1, 1, "float32", True),
    (3, 48, 17, 19, "bfloat16", False), (3, 48, 17, 19, "bfloat16", True),
    (3, 48, 17, 19, "float32", True), (2, 3, 9, 9, "bfloat16", True),
    (2, 1024, 1, 1, "float32", False),
)
# the ResNet families' sites in the modes other than the DoubleConv's
# (N, C, H, W, dtype, channels-last, mode), bias-free as their convs are:
# layer1's bn3 + residual and downsample BN of a bf16 512^2 b8 step, layer4's
# (2048 channels at 64^2), a pooled 1x1 map at b8 and at b1 (variance 0),
# odd maps, and f64 (the yardstick steps) in each mode and layout
BN_MODE_SHAPES = (
    (8, 256, 128, 128, "bfloat16", True, "residual"),
    (8, 256, 128, 128, "bfloat16", True, "none"),
    (8, 2048, 64, 64, "bfloat16", True, "residual"),
    (8, 64, 256, 256, "bfloat16", True, "relu"),
    (8, 256, 1, 1, "bfloat16", False, "relu"),
    (1, 512, 1, 1, "float32", False, "relu"),
    (3, 48, 17, 19, "float32", False, "residual"),
    (3, 48, 17, 19, "bfloat16", True, "none"),
    (2, 64, 9, 9, "float64", False, "relu"),
    (2, 64, 9, 9, "float64", True, "residual"),
    (4, 5, 1, 1, "float64", False, "none"),
    (2, 256, 16, 16, "float64", False, "residual"),
    (2, 256, 16, 16, "float64", True, "none"),
)
# a slab's rows under a spatial mesh of any slab height: none, one, odd;
# each site's moments summed with a full 8-row rest of the batch, as the
# ranks' all-reduce sums them (``bn_steps``)
BN_SLAB_ROWS = (0, 1, 7, 15)
BN_SLAB_SHAPES = tuple((8, 64, rows, 124, dtype, cl) for rows in BN_SLAB_ROWS
                       for dtype, cl in (("bfloat16", True),
                                         ("float32", False)))


def bn_compare(name):
    """The comparison of kernel ``name``'s result with its plain version's:
    (max |delta|, differing elements, elements); raises past the bars."""
    import torch

    def halves(got, want):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {got.shape} {got.dtype} vs "
                                 f"{want.shape} {want.dtype}")
        c = want.shape[0] // 2
        err = 0.0
        for part in (slice(0, c), slice(c, 2 * c), slice(2 * c, None)):
            g, w = got[part].detach().double(), want[part].detach().double()
            if not w.numel():
                continue
            e = float((g - w).abs().max())
            ratio = e / max(float(w.abs().max()), 1e-30)
            BN_WORST[name] = max(BN_WORST.get(name, 0.0), ratio)
            if e > BN_SUM_BAR * float(w.abs().max()):
                raise AssertionError(
                    f"{name}: sums {e:.3g} apart, over {BN_SUM_BAR} x "
                    f"{float(w.abs().max()):.3g}")
            err = max(err, e)
        return err, int((got != want).sum()), got.numel()

    def elements(got, want):
        if isinstance(want, tuple):  # K9b's residual mode: (dt, dr)
            parts = [elements(g, w) for g, w in zip(got, want)]
            return (max(p[0] for p in parts), sum(p[1] for p in parts),
                    sum(p[2] for p in parts))
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {got.shape} {got.dtype} vs "
                                 f"{want.shape} {want.dtype}")
        g, w = got.detach().double(), want.detach().double()
        d = (g - w).abs()
        err = float(d.max()) if d.numel() else 0.0
        big = float(w.abs().max()) if w.numel() else 0.0
        nd = int((got != want).sum())
        if got.dtype == torch.float64:
            if err > BN_F64_BAR * big:
                raise AssertionError(f"{name}: f64 {err:.3g} apart, over "
                                     f"{BN_F64_BAR} x {big:.3g}")
            BN_WORST[name + " f64"] = max(BN_WORST.get(name + " f64", 0.0),
                                          err / max(big, 1e-300))
            return err, nd, got.numel()
        if got.numel():
            BN_WORST[name + " share"] = max(
                BN_WORST.get(name + " share", 0.0), nd / got.numel())
        if got.dtype == torch.float32:
            if err > BN_F32_BAR * big:
                raise AssertionError(f"{name}: f32 {err:.3g} apart, over "
                                     f"{BN_F32_BAR} x {big:.3g}")
        else:
            mag = w.abs().clamp_min(big * 2.0 ** -12)
            ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30)))
                             - 7)
            worst = float((d / ulp).max()) if d.numel() else 0.0
            if worst > 1.0:
                raise AssertionError(f"{name}: {worst:.3g} bf16 ulps apart")
        if got.numel() and nd > BN_SHARE * got.numel():
            raise AssertionError(f"{name}: {nd} of {got.numel()} elements "
                                 f"differ, over the share {BN_SHARE}")
        return err, nd, got.numel()

    return elements if name in BN_OUTS else halves


def bn_inputs(dev, n, c, h, w, dtype, channels_last, seed):
    """Seeded y, bias, gamma, beta, running mean / var, dout and a
    residual r (the per-channel vectors in acc: f64 for f64 y)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float64": torch.float64}[dtype]
    acc = torch.promote_types(dt, torch.float32)

    def draw(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                + shift).to(acc)

    def nchw(t):
        t = t.to(dt)
        return t.contiguous(memory_format=torch.channels_last) \
            if channels_last else t

    y = nchw(draw(n, c, h, w, scale=2.0, shift=0.5))
    dout = nchw(draw(n, c, h, w))
    a = {"y": y, "dout": dout, "bias": draw(c, scale=0.5),
         "gamma": draw(c, scale=0.2, shift=1.0),
         "beta": draw(c, scale=0.3), "running_mean": draw(c, scale=0.1),
         "running_var": draw(c, scale=0.1, shift=1.0).abs()}
    a["r"] = nchw(draw(n, c, h, w))  # the residual mode's identity
    return a


def bn_steps(a, eps=1e-5, momentum=0.1, rest=None, mode="relu"):
    """Argument sets of the four kernels on one site's inputs ``a`` in
    ``mode`` (the relu mode with the conv bias, the others bias-free as
    the ResNet convs are), each later one fed the kernels' own buffers and
    the residual mode's backward K8b's output (so a kernel and its plain
    version see the same inputs). ``rest``: another rank's y and dout of
    the site, whose sums the buffers add, as a mesh's all-reduce does."""
    from insarseg_torch.kernels import bn_act as B

    y, gamma, beta = a["y"], a["gamma"], a["beta"]
    bias = a["bias"] if mode == "relu" else None
    r = a["r"] if mode == "residual" else None
    stats = B.bn_stats(y, bias)
    if rest is not None:
        stats = stats + B.bn_stats(rest["y"], bias)
    apply = {"y": y, "bias": bias, "stats": stats, "gamma": gamma,
             "beta": beta, "running_mean": a["running_mean"],
             "running_var": a["running_var"], "eps": eps,
             "momentum": momentum, "mode": mode, "residual": r}

    def out_of(site):  # the site's output, the residual mode's mask
        if mode != "residual":
            return None
        return B.bn_apply_relu(**dict(
            apply, y=site["y"], residual=site["r"],
            running_mean=a["running_mean"].clone(),
            running_var=a["running_var"].clone()))

    grad = {"y": y, "bias": bias, "stats": stats, "gamma": gamma,
            "beta": beta, "eps": eps, "mode": mode, "out": out_of(a)}
    gstats = B.bn_relu_grad_stats(a["dout"], **grad)
    if rest is not None:
        gstats = gstats + B.bn_relu_grad_stats(
            rest["dout"], **dict(grad, y=rest["y"], out=out_of(rest)))
    return {
        "bn_stats": {"y": y, "bias": bias},
        "bn_apply_relu": apply,
        "bn_relu_grad_stats": dict(grad, dy=a["dout"]),
        "bn_relu_grad_apply": dict(grad, dy=a["dout"], gstats=gstats),
    }


IN_PLACE = ("running_mean", "running_var")


def bn_check_call(name, args, out=None):
    """Kernel ``name`` on ``args`` (run here unless ``out`` is given; then
    ``args`` must hold the in-place buffers as they were before it ran,
    under ``"before"``) against its plain version on copies of the same
    inputs: the result, and for K8b the running statistics it updated.
    Returns (max |delta|, differing, elements)."""
    from insarseg_torch.kernels import bn_act as B

    before = args.pop("before", None)
    if out is None:
        before = {k: args[k].clone() for k in IN_PLACE if k in args}
        out = getattr(B, name)(**args)
    before = before or {}
    plain_args = dict(args, **{k: v.clone() for k, v in before.items()})
    want = getattr(B, name + "_plain")(**plain_args)
    res = bn_compare(name)(out, want)
    for k in before:
        err = float((args[k] - plain_args[k]).abs().max())
        if err > BN_STAT_BAR * float(plain_args[k].abs().max()):
            raise AssertionError(f"{name}: {k} {err:.3g} apart")
    return res


def _same_result(first, second) -> bool:
    """Two results of a wrapper bit-equal (K9b's residual mode: a pair)."""
    import torch

    if isinstance(first, tuple):
        return all(torch.equal(a, b) for a, b in zip(first, second))
    return torch.equal(first, second)


def check_bn_fixed_shapes(dev, shapes=None) -> None:
    """K8a-K9b against their plain versions on the same inputs at fixed
    shapes (NCHW and channels-last, C 1 / 3 / 5 / 48 / 64 / 256 / 1024 /
    2048, 1x1 maps, an odd H*W, bf16, f32 and f64, each mode:
    ``BN_MODE_SHAPES``; the spatial phase's ``BN_SLAB_SHAPES``: a mesh's
    slabs of 0, 1, 7 and 15 rows, their moments summed with another
    rank's), each kernel run twice and bit-equal to itself; on a slab of
    no row each kernel launches and returns zero sums, a zero count and
    an empty output."""
    import torch
    from insarseg_torch import kernels as K
    from insarseg_torch.kernels import bn_act as B

    worst = {k: [0.0, 0, 0] for k in BN_KERNELS}
    for i, shape in enumerate(shapes or BN_SHAPES + BN_MODE_SHAPES):
        n, c, h, w, dtype, cl = shape[:6]
        mode = shape[6] if len(shape) > 6 else "relu"
        a = bn_inputs(dev, n, c, h, w, dtype, cl, SEED + 70 + i)
        rest = None
        if shape in BN_SLAB_SHAPES:
            rest = bn_inputs(dev, n, c, 8, w, dtype, cl, SEED + 170 + i)
        K.reset_launches()
        steps = bn_steps(a, rest=rest, mode=mode)
        if h == 0:
            empty = {"bn_stats": B.bn_stats(a["y"], a["bias"]),
                     "bn_apply_relu": B.bn_apply_relu(
                         **steps["bn_apply_relu"]),
                     "bn_relu_grad_apply": B.bn_relu_grad_apply(
                         **steps["bn_relu_grad_apply"])}
            torch.cuda.synchronize()
            if float(empty["bn_stats"].abs().max()) != 0 \
                    or empty["bn_apply_relu"].numel() \
                    or empty["bn_relu_grad_apply"].numel() \
                    or any(K.LAUNCHES[k] == 0 for k in BN_KERNELS):
                raise AssertionError(
                    f"bn_act on a slab of no row ({n}x{c}x0x{w} {dtype}): "
                    f"sums {empty['bn_stats'].abs().max()}, launches "
                    + json.dumps({k: K.LAUNCHES[k] for k in BN_KERNELS}))
        for name, args in steps.items():
            e, nd, ne = bn_check_call(name, dict(args))
            wk = worst[name]
            wk[0], wk[1], wk[2] = max(wk[0], e), wk[1] + nd, wk[2] + ne
            keep = {k: args[k].clone() for k in IN_PLACE if k in args}
            first = getattr(B, name)(**args)
            for k, v in keep.items():
                args[k].copy_(v)
            second = getattr(B, name)(**args)
            if not _same_result(first, second):
                raise AssertionError(f"{name} on {shape} differs between "
                                     "two runs")
        layout, vec, s = B.plan(a["y"])
        r = B.reduce_plan(a["y"], a["dout"])
        log(f"  bn_act {n}x{c}x{h}x{w} {dtype} "
            f"{'channels-last' if cl else 'NCHW'} {mode}: K8b / K9b plan "
            f"layout {layout} vec {vec} slices {s}; K8a / K9a vec {r.vec} "
            f"groups {r.groups} slices {r.slices} of {r.per}; kernels == "
            "plain within the bars, two runs bit-equal")
        del a, steps
    torch.cuda.synchronize()
    log("K8a-K9b against their plain versions at fixed shapes (max |delta|, "
        "differing, elements): " + json.dumps(worst) + "; largest readings "
        "(sums: |delta| / max|value|; outputs: the differing share; f64: "
        "|delta| / max|value|) " + json.dumps(BN_WORST))


@contextlib.contextmanager
def checked_bn_calls(checked, record=None):
    """While open, every call of K8a-K9b (through ``kernels/bn_act.py``, as
    ``bn_relu_train`` makes them) is held against its plain version on the
    same inputs (``bn_check_call``), into ``checked`` as ``checked_calls``
    gathers; with ``record``, each call's arguments are kept there by
    kernel name."""
    from insarseg_torch.kernels import bn_act as B

    def on_call(n, a, out):
        t0 = time.perf_counter()
        e, nd, ne = bn_check_call(n, dict(a), out)
        c = checked.setdefault(n, {
            "calls": 0, "batches": set(), "max_abs_err": 0.0,
            "differing": 0, "elements": 0, "seconds": 0.0})
        c["calls"] += 1
        c["batches"].add(a["y"].shape[0])
        c["max_abs_err"] = max(c["max_abs_err"], e)
        c["differing"] += nd
        c["elements"] += ne
        c["seconds"] += time.perf_counter() - t0
        if record is not None:
            a.pop("before")
            record.setdefault(n, []).append(a)

    with spying([B], BN_KERNELS, on_call, keep=IN_PLACE):
        yield


def bn_kernel_launches() -> int:
    """The kernels ``csrc/bn_act.cu``'s entry points have launched in this
    process (the library's own host counter)."""
    import ctypes

    from insarseg_torch.kernels import _lib

    count = ctypes.c_int()
    _lib.load_library().insarseg_bn_kernel_launches(ctypes.addressof(count))
    return count.value


def memory_format(t) -> str:
    import torch

    if t.is_contiguous():
        return "NCHW"
    if t.is_contiguous(memory_format=torch.channels_last):
        return "channels-last"
    return "strided"


def copied_by_like(dy, y) -> bool:
    """Whether ``kernels/bn_act.py`` copies ``dy`` into y's layout before
    a backward kernel reads it."""
    import torch
    from insarseg_torch.kernels import bn_act as B

    fmt = torch.channels_last if B.layout_of(y) else torch.contiguous_format
    return not dy.is_contiguous(memory_format=fmt)


def bn_cases(calls):
    """Timing cases of K8a-K9b on the arguments one train step gave them,
    with the library calls PyTorch's own batch norm runs the same work
    with: ``batch_norm_stats`` (mean, invstd) for K8a,
    ``batch_norm_elemt`` for K8b, ``batch_norm_backward_reduce`` for K9a
    and ``batch_norm_backward_elemt`` for K9b (each on the biased t; no
    ReLU)."""
    import torch
    from insarseg_torch.kernels import bn_act as B

    cases = {}
    for name, args in calls.items():
        cases[name] = []
        for a in args:
            a = {k: v for k, v in a.items() if k != "before"}
            y = a["y"]
            n, c, h, w = y.shape
            e = y.element_size()
            t = (y + a["bias"].to(y.dtype)[:, None, None])
            mean, invstd = torch.batch_norm_stats(t, 1e-5)
            count = torch.full((1,), n * h * w, dtype=torch.int32,
                               device=y.device)
            gamma, beta = a.get("gamma"), a.get("beta")
            reads = {"bn_stats": 1, "bn_apply_relu": 2,
                     "bn_relu_grad_stats": 2, "bn_relu_grad_apply": 3}[name]
            if name == "bn_stats":
                lib = lambda t=t: torch.batch_norm_stats(t, 1e-5)  # noqa
            elif name == "bn_apply_relu":
                lib = lambda t=t, m=mean, s=invstd, g=gamma, b=beta: \
                    torch.batch_norm_elemt(t, g, b, m, s, 1e-5)  # noqa
            else:
                dy = a["dy"]
                sdy, sdyx, _, _ = torch.batch_norm_backward_reduce(
                    dy, t, mean, invstd, gamma, True, True, True)
                if name == "bn_relu_grad_stats":
                    lib = lambda dy=dy, t=t, m=mean, s=invstd, g=gamma: \
                        torch.batch_norm_backward_reduce(
                            dy, t, m, s, g, True, True, True)  # noqa
                else:
                    lib = lambda dy=dy, t=t, m=mean, s=invstd, g=gamma, \
                        a1=sdy, a2=sdyx, k=count: \
                        torch.batch_norm_backward_elemt(
                            dy, t, m, s, g, a1, a2, k)  # noqa
            kern = getattr(B, name)
            plain = getattr(B, name + "_plain")

            def run(fn, a=a):
                b = dict(a)
                for k in IN_PLACE:  # the module's statistics stay as they are
                    if k in b:
                        b[k] = b[k].clone()
                return fn(**b)

            layout = "channels-last" if B.layout_of(y) else "NCHW"
            first = bn_kernel_launches()
            run(kern)
            note = (f"kernels launched a call "
                    f"{bn_kernel_launches() - first}")
            if "dy" in a:
                note = (f"dout {memory_format(a['dy'])} strides "
                        f"{tuple(a['dy'].stride())}, copied by _like: "
                        f"{'yes' if copied_by_like(a['dy'], y) else 'no'}; "
                        + note)
            cases[name].append({
                "shape": f"b{n} {c}x{h}x{w} {str(y.dtype)[6:]} {layout}",
                "kernel": lambda run=run, kern=kern: run(kern),
                "plain": lambda run=run, plain=plain: run(plain),
                "compare": bn_compare(name), "lib": lib,
                "path": f"train C{c} {h}x{w}", "note": note,
                "ops": 6.0 * y.numel(), "peak": PEAK_F32,
                "bytes": reads * y.numel() * e + 16 * c})
    return cases


def train_bn_kernels(dev, power_line) -> list:
    """One bf16 U-Net-CA (base ``BASE``) train step at 512^2 b8 with the
    launch counters set to 0 just before and read just after (the main
    path of K8a-K9b), every K8a-K9b call of it held against its plain
    version (``checked_bn_calls``); then each kernel timed on the tensors
    that step gave it (``kernel_row``: device ms, plain, library, bound).
    Returns the four kernel rows."""
    import torch
    from insarseg_torch import kernels as K
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.train.engine import create_state, make_train_step

    model = UNet(num_classes=2, base_features=BASE, use_se=True)
    state = create_state(model, seed=SEED, device=dev)
    step = make_train_step(model, 2, compute_dtype=torch.bfloat16)
    data = synthetic_batch(BATCH, HW, seed=SEED + 32)
    x = torch.from_numpy(data["image"]).to(dev)
    m = torch.from_numpy(data["mask"]).to(dev)
    step(state, x, m)
    torch.cuda.synchronize()
    checked, calls = {}, {}
    K.reset_launches()
    with checked_bn_calls(checked, calls):
        step(state, x, m)
    torch.cuda.synchronize()
    launches = {k: K.LAUNCHES[k] for k in BN_KERNELS}
    log(f"bf16 train step U-Net-CA base {BASE}, {HW}^2 b{BATCH}: K8a-K9b "
        f"launches {launches}; every call held against its plain version "
        + json.dumps(checked, default=sorted) + "; largest readings so far "
        + json.dumps(BN_WORST))
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {k} never launched on the train "
                                 "path")
        if checked.get(k, {}).get("calls") != n:
            raise AssertionError(f"{k}: {n} launches, "
                                 f"{checked.get(k, {}).get('calls')} checked")
    del state, step, model
    log(f"each K8a-K9b call of that step timed on its tensors, on "
        f"{power_line}:")
    rows = []
    for kname, (wrapper, replaces) in BN_KERNELS.items():
        row = kernel_row(kname, "insarseg_torch/csrc/bn_act.cu", replaces,
                         bn_cases({wrapper: calls[wrapper]})[wrapper])
        row["launches"] = row["train_launches"] = launches[kname]
        row["train_checked"] = checked[kname]["calls"]
        row["train_differing_share"] = (checked[kname]["differing"]
                                        / checked[kname]["elements"])
        rows.append(row)
    log("K8a-K9b by level of the step (device ms / bound ms, summed over "
        "the level's calls): " + json.dumps({
            r["name"]: {p: [ms, r["bound_ms_by_path"][p]]
                        for p, ms in r["ms_by_path"].items()}
            for r in rows}))
    del calls
    torch.cuda.empty_cache()
    log("library site a step (bias add, cuDNN F.batch_norm(training=True), "
        "F.relu), forward and backward: " + json.dumps(bn_library_site(dev)))
    return rows


def bn_library_site(dev) -> dict:
    """The epilogue as stock PyTorch runs it at the bf16 512^2 b8 step's 18
    BatchNorm sites: the bias add, ``F.batch_norm(training=True)`` (cuDNN)
    and ``F.relu`` forward, and their backward, device ms a step."""
    import torch
    import torch.nn.functional as F

    sites = []
    for level in range(5):
        c, hw = BASE * 2 ** level, HW // 2 ** level
        sites += [(c, hw)] * (2 if level == 4 else 4)
    fwd = bwd = 0.0
    for i, (c, hw) in enumerate(sites):
        y = torch.randn(BATCH, c, hw, hw, device=dev, dtype=torch.bfloat16)
        bias = torch.randn(c, device=dev)
        gamma = torch.ones(c, device=dev, requires_grad=True)
        beta = torch.zeros(c, device=dev, requires_grad=True)
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        y.requires_grad_(True)

        def forward():
            t = y + bias.to(y.dtype)[:, None, None]
            return F.relu(F.batch_norm(t, rm, rv, gamma, beta, True, 0.1,
                                       1e-5))

        out = forward()
        g = torch.randn_like(out)
        fwd += device_ms(forward, reps=3)[0]
        bwd += device_ms(lambda: torch.autograd.grad(
            forward(), (y, gamma, beta), g), reps=3)[0] \
            - device_ms(forward, reps=3)[0]
        del y, out, g
    return {"forward_ms": fwd, "backward_ms": bwd, "sites": len(sites)}


# The ResNet families' train steps on K8a-K9b, one call a BatchNorm in the
# mode of what follows it (kernels/bn_act.py::MODES): (label, model,
# attention, batch) at 512^2, bf16, and each cell's calls by mode.
# DeepLabV3-ResNet50: 60 BatchNorms (the stem, bn1 and bn2 of 16
# bottlenecks and 7 head BNs with their ReLU; bn3 with the residual add;
# 4 downsample BNs); the CA cells put bn3 before the SE block (the none
# mode) and FCN-CA's head has one BN, PSPNet-CA's five (the 1x1 bin among
# them)
RESNET_TRAIN = (("DeepLabV3-ResNet50", "deeplabv3", "none", BATCH),
                ("FCN-ResNet50-CA", "fcn", "channel", 2),
                ("PSPNet-ResNet50-CA", "pspnet", "channel", 2))
RESNET_MODES = {"deeplabv3": {"relu": 40, "none": 4, "residual": 16},
                "fcn": {"relu": 34, "none": 20},
                "pspnet": {"relu": 38, "none": 20}}
# passes over the (N, C, H, W) operand each kernel makes by mode (reads
# and writes: the residual mode reads r or the saved output, and K9b
# writes dr)
BN_PASSES = {"bn_stats": {"relu": 1, "none": 1, "residual": 1},
             "bn_apply_relu": {"relu": 2, "none": 2, "residual": 3},
             "bn_relu_grad_stats": {"relu": 2, "none": 2, "residual": 3},
             "bn_relu_grad_apply": {"relu": 3, "none": 3, "residual": 5}}
# the kernels' ops in their device names (csrc/bn_act.cu), the mode their
# template's second argument
BN_OPS = {"StatsOp": "bn_stats", "ApplyOp": "bn_apply_relu",
          "GradStatsOp": "bn_relu_grad_stats",
          "GradApplyOp": "bn_relu_grad_apply"}
BN_MODE_NAMES = ("relu", "none", "residual")
# the DeepLabV3 step timed in turns with the library route: (dtype, size)
RESNET_TURNS = (("bfloat16", HW), ("float32", 128))


def resnet_train_step(dev, name, attention, size, batch, dtype="bfloat16"):
    """(state, step, image, mask) of a ResNet cell's train step on the
    card: ``build_model``'s seeded weights, Adam, ``compute_dtype``
    ``dtype``, a synthetic batch."""
    import torch
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.train.engine import create_state, make_train_step

    model = build_model(name, attention).train()
    state = create_state(model, device=dev)
    step = make_train_step(model, 2, compute_dtype=_dtype(dtype))
    data = synthetic_batch(batch, size, seed=SEED + 34)
    return (state, step, torch.from_numpy(data["image"]).to(dev),
            torch.from_numpy(data["mask"]).to(dev))


def bn_device_ms(prof, steps: int) -> dict:
    """K8a-K9b's device ms a step in a profiler window of ``steps`` steps,
    by kernel and mode (K8a's moments take no mode: ``all``)."""
    import re

    out = {}
    for e in prof.key_averages():
        m = re.search(r"\b(GradStatsOp|StatsOp|GradApplyOp|ApplyOp)"
                      r"<[^,<>]+, (\d)>", e.key)
        if m is None:
            continue
        k = BN_OPS[m.group(1)]
        mode = "all" if k == "bn_stats" else BN_MODE_NAMES[int(m.group(2))]
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        out.setdefault(k, {}).setdefault(mode, 0.0)
        out[k][mode] += us / steps / 1e3
    return out


def train_resnet_bn(dev, power_line) -> dict:
    """The ResNet families' bf16 train steps at 512^2 (``RESNET_TRAIN``),
    each with the launch counters set to 0 just before and read just
    after, every K8a-K9b call held against its plain version
    (``checked_bn_calls``): each kernel launched once a BatchNorm, its
    calls checked, the calls by mode ``RESNET_MODES``'. For each, the
    bound of each kernel by mode from the calls' shapes; for DeepLabV3 the
    kernels' device ms by mode from a profiler window of the step. Returns
    per cell its launches, calls by mode, bounds and (DeepLabV3) ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from insarseg_torch import kernels as K

    out = {}
    for label, name, attention, batch in RESNET_TRAIN:
        state, step, x, m = resnet_train_step(dev, name, attention, HW,
                                              batch)
        step(state, x, m)
        torch.cuda.synchronize()
        checked, calls = {}, {}
        K.reset_launches()
        with checked_bn_calls(checked, calls):
            step(state, x, m)
        torch.cuda.synchronize()
        launches = {k: K.LAUNCHES[k] for k in BN_KERNELS}
        modes = {}
        for a in calls["bn_apply_relu"]:
            modes[a["mode"]] = modes.get(a["mode"], 0) + 1
        want = RESNET_MODES[name]
        log(f"bf16 train step {label}, {HW}^2 b{batch}: K8a-K9b launches "
            f"{launches}, K8b's calls by mode {modes} (expected {want}); "
            "every call held against its plain version "
            + json.dumps(checked, default=sorted))
        if modes != want:
            raise AssertionError(f"{label}: calls by mode {modes}, "
                                 f"expected {want}")
        for k, n in launches.items():
            if n != sum(want.values()):
                raise AssertionError(f"{label}: {k} launched {n} times for "
                                     f"{sum(want.values())} BatchNorms")
            if checked.get(k, {}).get("calls") != n:
                raise AssertionError(f"{label}: {k}: {n} launches, "
                                     f"{checked.get(k, {}).get('calls')} "
                                     "checked")
        bounds = {}
        for k in BN_KERNELS:
            for i, a in enumerate(calls[k]):
                mode = calls["bn_apply_relu"][i]["mode"] \
                    if k == "bn_stats" else a["mode"]
                y = a["y"]
                nbytes = (BN_PASSES[k][mode] * y.numel() * y.element_size()
                          + 16 * y.shape[1])
                bms, _ = bound(6.0 * y.numel(), nbytes, PEAK_F32)
                mode = "all" if k == "bn_stats" else mode
                bounds.setdefault(k, {}).setdefault(mode, 0.0)
                bounds[k][mode] += bms
        del calls
        cell = {"launches": launches, "modes": modes, "bound_ms": bounds,
                "checked": {k: c["calls"] for k, c in checked.items()},
                "max_abs_err": {k: c["max_abs_err"]
                                for k, c in checked.items()}}
        if name == "deeplabv3":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    step(state, x, m)
                torch.cuda.synchronize()
            cell["ms"] = bn_device_ms(prof, 2)
            cell["idle"] = device_idle_share(prof)
            log(f"  {label} bf16 step under the profiler (2 steps): K8a-K9b "
                "device ms a step by mode " + json.dumps(cell["ms"])
                + " against their bounds " + json.dumps(bounds)
                + f"; device idle {cell['idle']}; on {power_line}")
        out[label] = cell
        del state, step, x, m
        torch.cuda.empty_cache()
    return out


def resnet_step_turns(dev, power_line) -> dict:
    """The DeepLabV3-ResNet50 train step (``RESNET_TURNS``: bf16 at 512^2
    and f32 at 128^2, b``BATCH``) through K8a-K9b and through the library
    route they replaced (``tools/bn_ab.py::library_route``: cuDNN's
    ``F.batch_norm`` with separate ReLU and add passes), in turns (kernels,
    library, library, kernels; 5 steps a turn after a warm step a route):
    ms a step (CUDA events, the best turn of each route), the peak
    ``max_memory_allocated`` of each, and the kernel route's device idle
    share over a 2-step profiler window."""
    import torch
    from tools.bn_ab import library_route

    res = {}
    for dtype, size in RESNET_TURNS:
        state, step, x, m = resnet_train_step(dev, "deeplabv3", "none", size,
                                              BATCH, dtype)
        routes = {"kernels": contextlib.nullcontext, "library": library_route}
        for route in routes.values():
            with route():
                step(state, x, m)
        ms = {r: [] for r in routes}
        peak = {r: 0.0 for r in routes}
        for r in ("kernels", "library", "library", "kernels"):
            with routes[r]():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                for _ in range(5):
                    step(state, x, m)
                e1.record()
                torch.cuda.synchronize()
            ms[r].append(e0.elapsed_time(e1) / 5)
            peak[r] = max(peak[r], torch.cuda.max_memory_allocated(dev)
                          / 2 ** 30)
        idle, top, _ = profile_window(lambda t: step(state, t, m), x, reps=2)
        key = f"{dtype} {size}^2 b{BATCH}"
        res[key] = {"ms": {r: min(v) for r, v in ms.items()},
                    "turns": ms, "peak_gib": peak, "idle": idle}
        log(f"DeepLabV3-ResNet50 train step {key} (Adam, TF32 off), K8a-K9b "
            f"against the library route in turns: ms a step "
            + json.dumps(ms) + f", peak GiB {json.dumps(peak)}, device idle "
            f"(kernel route, 2-step profiler window) {idle}; on "
            f"{power_line}")
        for k, dms in top:
            log(f"    profiler, device ms a step: {dms:.4f} {k}")
        del state, step, x, m
        torch.cuda.empty_cache()
    return res


# insarseg_bn_kernel_info's kernels, by index
BN_INFO = ("K8a bf16 channels-last", "K9a bf16 channels-last",
           "K8a f32 NCHW", "K9a f32 NCHW", "K8a bf16 NCHW", "K9a bf16 NCHW",
           "K8a f32 channels-last", "K9a f32 channels-last",
           "K8b bf16 channels-last", "K9b bf16 channels-last",
           "K8b f32 NCHW", "K9b f32 NCHW")


def bn_kernel_info() -> dict:
    """K8a-K9b's resources on this card, from the CUDA runtime: registers
    and local-memory (spill) bytes a thread, static shared bytes and
    threads a block, resident blocks an SM, and the bytes of device memory
    in flight an SM when every resident thread has its loads of one trip
    out."""
    import ctypes

    from insarseg_torch.kernels import _lib

    lib = _lib.load_library()
    info = {}
    for k, label in enumerate(BN_INFO):
        out = (ctypes.c_int * 6)()
        if lib.insarseg_bn_kernel_info(k, out) != 0:
            continue
        regs, local, smem, blocks, threads, flight = out
        info[label] = {"registers": regs, "spill_bytes": local,
                       "shared_bytes": smem, "threads": threads,
                       "blocks_per_sm": blocks,
                       "bytes_in_flight_per_sm": blocks * threads * flight}
    log("K8a-K9b resources (CUDA runtime): " + json.dumps(info))
    log("K8a-K9b conversions and f64 operations in the SASS, by kernel: "
        + json.dumps(bn_sass_counts()))
    return info


# the SASS opcodes of K8a / K9a's arithmetic: f32 -> f64 (and back),
# f32 -> bf16, f64 adds and products, and branches
BN_OPCODES = ("F2F.F64.F32", "F2F.F32.F64", "F2FP.BF16", "DADD", "DMUL",
              "DFMA", "BSSY", "BRA")


def bn_sass_counts(sass=None) -> dict:
    """Per K8a-K9b kernel of the library (or of the SASS ``sass``), the
    static count of each of ``BN_OPCODES``."""
    import re

    counts, name = {}, None
    for line in (sass or sass_text()).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "bn_act" in m.group(1) else None
            if name:
                counts[name] = dict.fromkeys(BN_OPCODES, 0)
        elif name is not None:
            for op in BN_OPCODES:
                counts[name][op] += bool(re.search(
                    r"\b" + re.escape(op) + r"\b", line))
    return counts


def train_path(dev, power_line: str, phase) -> list:
    """Phase 5; returns the rows of K8a-K9b."""
    import torch

    bn_kernel_info()
    check_bn_fixed_shapes(dev)
    phase("training: K8a-K9b against their plain versions at fixed shapes")
    rows = train_bn_kernels(dev, power_line)
    phase("training: K8a-K9b through a bf16 512^2 step, checked and timed")
    cells = train_resnet_bn(dev, power_line)
    turns = resnet_step_turns(dev, power_line)
    for row in rows:
        k = row["name"]
        row["resnet_launches"] = {c: v["launches"][k]
                                  for c, v in cells.items()}
        row["launches"] += sum(row["resnet_launches"].values())
        deeplab = cells[RESNET_TRAIN[0][0]]
        row["resnet_ms_by_mode"] = deeplab["ms"].get(k, {})
        row["resnet_bound_ms_by_mode"] = deeplab["bound_ms"][k]
    rows[0]["resnet_step"] = turns
    phase("training: the ResNet families' BatchNorms on K8a-K9b, checked; "
          "the DeepLabV3 step against the library route")
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
    return rows


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


# ---------------------------------------------------------------------------
# 8. the mesh phase: the data mesh of ``insarseg_torch/parallel/mesh.py``
# ---------------------------------------------------------------------------

MESH_BATCH = 16  # the serving check's global batch: 8 tiles a replica
MESH_TRAIN = (128, 8)  # U-Net-CA's train checks: 128^2, global b8
MESH_LR = 0.1  # SGD: the update is linear in the summed gradient
# the JAX package's own mesh bars (tests/test_parallel.py:67-79, one step
# from equal parameters): the loss's rtol, the parameters' and the BN
# statistics' atol; that step's counts equal
MESH_BARS = (1e-5, 1e-4, 1e-5)
# a ResNet's f32 SGD step reproduces its parameters to about 1e-3 of the
# step only (one process against itself at another thread count on the
# CPU, tests/test_torch_spatial_resnet_fit.py), and DeepLabV3's pooled
# BatchNorm (a batch variance ~1e-3 of its mean squared) moves its
# forward by ~1e-4 for an ulp of the image mean: where a mesh's step
# misses a bar of MESH_BARS / TIE_BAR, that quantity must lie no further
# from the float64 step's than this many times one process's f32 one does
# (``mesh_hold``). On two H100s the ratio read up to 1.93 (DeepLabV3's BN
# statistics: the mesh's 3.36e-5 against one process's 1.74e-5 and
# 2.18e-5 on another card), where a fault moves a step by orders more;
# with every BatchNorm of both on K8a-K9b's fixed-order f64 sums it reads
# 0.91-1.30 where a bar is missed (DeepLabV3's parameters and statistics,
# PSPNet-CA's statistics; FCN-CA misses none), the convs' own f32 noise:
# 2, above those readings, where it was 4 while cuDNN's BatchNorm served
# one process and the mesh another's sums
FLOAT_NOISE = 2.0
MESH_FLOAT_BAR = 1e-5  # x max|logit|: f32 module / serve, mesh vs one device
# x max|logit|: a pixel whose two logits lie this close is a near tie,
# which the spatial steps' counts may flip (``mesh_hold``): at 512^2 b8,
# 2,097,152 pixels, f32 sums in another order flipped one of U-Net-SA's
TIE_BAR = 1e-5
MESH_CARD_TILES = 128  # tiles a card: the serving timing's engine batch
MESH_STEP_TILES = 8  # tiles a card: the multi-card train step's batch
# the CLI's default train (every card) at two presets, each (preset, image
# size, batch, steps an epoch): U-Net-CA at 128^2 b8 (2 tiles a card on
# four) and FCN-ResNet50-CA at 64^2 b128; 3 epochs, the first a warm-up
MESH_PRESETS = (("unet-channelattention", 128, 8, 10),
                ("pspnet-channelattention", 64, 128, 4))
MESH_PRESET_EPOCHS = 3


def mesh_serving(dev, checked) -> dict:
    """Two replicas on one card (``make_mesh(devices=[cuda:0, cuda:0])``)
    against the one-device engines, U-Net-CA (base ``BASE``, H-s2d) and
    FCN-ResNet50-CA at ``HW``^2, global b``MESH_BATCH``: the int8 logits
    bit-equal (the int8 engines are batch-invariant), the mesh forward's
    every kernel call held against its plain version (``checked_calls``),
    its launches counted from 0; the module and serve engines' f32 logits
    within ``MESH_FLOAT_BAR`` x max|logit|, and in bf16 the differing
    logits counted (no bar: cuDNN picks its kernels by the batch).
    Returns the int8 mesh forwards' launches."""
    import torch
    from insarseg_torch import kernels as K
    from insarseg_torch.engines import (
        engine_from_artifact,
        make_engine,
        pack_engine,
    )
    from insarseg_torch.parallel import make_mesh

    mesh = make_mesh(devices=[dev, dev])
    rng = np.random.default_rng(SEED + 70)
    x = torch.from_numpy(smooth_batch(rng, MESH_BATCH, HW, HW)).to(dev)
    launches = {}
    for name, attention, label in (
            ("unet", "channel", f"U-Net-CA base {BASE}"),
            ("fcn", "channel", "FCN-ResNet50-CA")):
        model = build_model(name, attention)
        calib = [smooth_batch(rng, 4, HW, HW) for _ in range(2)]
        art = pack_engine(name, attention, model, None, "int8",
                          calib_batches=calib, device=dev)
        one = engine_from_artifact(art, device=dev)(x)
        two = engine_from_artifact(art, mesh=mesh)
        K.reset_launches()
        with checked_calls(checked):
            got = two(x)
        torch.cuda.synchronize()
        ran = {k: n for k, n in K.LAUNCHES.items() if n}
        for k, n in ran.items():
            launches[k] = launches.get(k, 0) + n
        same = torch.equal(one, got)
        log(f"  {label} int8, {HW}^2 b{MESH_BATCH} over two replicas on one "
            f"card vs one device: {'bit-equal' if same else 'DIFFERENT'}; "
            f"launches {ran}")
        if not same:
            raise AssertionError(f"{label}: the int8 mesh differs from one "
                                 "device")
        for engine, dtype in (("module", None), ("module", torch.bfloat16),
                              ("serve", None), ("serve", torch.bfloat16)):
            a = make_engine(name, attention, model, None, engine, device=dev,
                            input_dtype=dtype)(x).float()
            b = make_engine(name, attention, model, None, engine, mesh=mesh,
                            input_dtype=dtype)(x).float()
            scale = float(a.abs().max())
            err = float((a - b).abs().max())
            n_diff = int((a != b).sum())
            agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            what = f"{engine} {'bf16' if dtype else 'f32'}"
            log(f"  {label} {what}: mesh vs one device {n_diff} of "
                f"{a.numel()} logits differ, max {err:.3g} ({err / scale:.3g}"
                f" x max|logit|{'' if dtype else f', bar {MESH_FLOAT_BAR}'}),"
                f" argmax agreement {agree:.6f}")
            if dtype is None and err > MESH_FLOAT_BAR * scale:
                raise AssertionError(f"{label} {what}: the mesh differs from "
                                     "one device")
        del model, art, two, one, got
        torch.cuda.empty_cache()
    return launches


def _deterministic():
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _cpu_tree(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_tree(v) for v in tree)
    return tree


def mesh_sgd_rank(batches, base, device, lr: float = MESH_LR, starts=None,
                  spatial: int = 1, attention: str = "channel",
                  ties: bool = False, resnet=None, dtype=None):
    """One rank (or, without a group, one process) of U-Net-CA (with
    ``attention`` "spatial", U-Net-SA; ``base`` features, the seeded init)
    on ``device`` taking one SGD step on each global batch in turn, in f32
    under ``cudnn.deterministic``, its H axis over ``spatial`` ranks: each
    step's outputs and the state_dict after each step. ``resnet`` (a
    (model, attention) cell of the ResNet families) trains that cell in
    place of the U-Net: ``build_model``'s seeded weights, dropout off (each
    rank draws its own mask), every BatchNorm the JAX package's moment
    rule in one process as under a group (``sync_batchnorm``); ``dtype``
    ``torch.float64``: the model and its steps in float64. Given
    ``starts``, step k first loads ``starts[k]`` (a state_dict; ``None``
    keeps the state it has). With ``ties`` each step's outputs also hold
    ``"ties"``: the pixels of its forward whose two logits lie within
    ``TIE_BAR`` x max|logit| of each other (``mesh_hold``)."""
    import torch
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.parallel import sync_batchnorm
    from insarseg_torch.train.engine import create_state, make_train_step

    _deterministic()
    if resnet is None:
        model = UNet(num_classes=2, base_features=base,
                     use_se=attention == "channel",
                     use_sa=attention == "spatial")
        state = create_state(model, seed=SEED, device=device)
        head = model.outc
    else:
        model = sync_batchnorm(build_model(*resnet).train())
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        state = create_state(model, device=device)
        head = model
    if dtype is not None:
        model.to(dtype)
    state.optimizer = torch.optim.SGD(model.parameters(), lr=lr)
    step = make_train_step(model, 2, spatial=spatial, compute_dtype=dtype)
    seen = []
    if ties:
        def near(mod, inp, out):
            out = out.detach()
            margin = (out[:, 1] - out[:, 0]).abs()
            seen.append(int((margin <= TIE_BAR * float(out.abs().max()))
                            .sum()))

        head.register_forward_hook(near)
    outs, states = [], []
    for k, b in enumerate(batches):
        if starts is not None and starts[k] is not None:
            model.load_state_dict(starts[k])
        outs.append(_cpu_tree(step(state, torch.from_numpy(b["image"]),
                                   torch.from_numpy(b["mask"]))))
        if ties:
            outs[-1]["ties"] = seen.pop()
        states.append(_cpu_tree(model.state_dict()))
    return outs, states


def mesh_bf16_rank(batch, base, device, steps: int = 3):
    """``steps`` bf16 Adam steps of U-Net-CA on one global batch: the
    losses."""
    import torch
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.train.engine import create_state, make_train_step

    model = UNet(num_classes=2, base_features=base, use_se=True)
    state = create_state(model, seed=SEED, device=device)
    step = make_train_step(model, 2, compute_dtype=torch.bfloat16)
    x, m = torch.from_numpy(batch["image"]), torch.from_numpy(batch["mask"])
    return [float(step(state, x, m)["loss"]) for _ in range(steps)]


def mesh_fit_rank(train, val, directory, base, device, spatial: int = 1):
    """``fit`` of U-Net-CA for 2 epochs at ``TRAIN_PRESET``'s settings
    (``mesh_spatial`` ``spatial``) on ``train`` / ``val`` with a
    ``Checkpointer`` in ``directory``, then a resume to epoch 3: the two
    histories, the steps and the state after the resume."""
    import dataclasses

    from insarseg_torch.config import get_preset
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.parallel import rank
    from insarseg_torch.train.checkpoint import Checkpointer
    from insarseg_torch.train.engine import create_state, fit

    cfg = get_preset(TRAIN_PRESET, num_epochs=2, log_every_steps=2,
                     mesh_spatial=spatial)
    out = {"rank": rank()}
    for epochs, resume in ((2, False), (3, True)):
        model = UNet(num_classes=2, base_features=base, use_se=True)
        state = create_state(model, cfg.learning_rate, seed=cfg.seed,
                             device=device)
        hist = fit(model, dataclasses.replace(cfg, num_epochs=epochs), train,
                   val, state=state, checkpointer=Checkpointer(directory),
                   resume=resume, verbose=False, device=device)
        out[epochs] = (hist, state.step)
    out["state"] = _cpu_tree(model.state_dict())
    return out


def mesh_gloo_rank(batches, fit_data, directory, base, device):
    """The two-rank checks in one process a rank: the f32 SGD steps, the
    bf16 steps and the ``fit`` with its resume."""
    return {"sgd": mesh_sgd_rank(batches, base, device),
            "bf16": mesh_bf16_rank(batches[0], base, device),
            "fit": mesh_fit_rank(*fit_data, directory, base, device)}


def mesh_hold(got, batches, device, label, attention: str = "channel",
              want=None, net=None, exact=None) -> None:
    """A mesh's SGD steps (``mesh_sgd_rank``) against one process's at
    ``MESH_BARS``, each step one step from equal parameters: step k of
    the one process on ``device`` starts from the mesh's state after step
    k-1 (the first from the seeded init). Every step's loss and counts
    (equal), the parameters and the BN statistics after it. ``want``: the
    one process's steps, already run from those states. ``exact``: the
    same one-process steps in float64 from the same states: where the
    loss, the counts, the parameters or the BN statistics miss their bar,
    they pass if they lie no further from the float64 steps' than
    ``FLOAT_NOISE`` times the one process's f32 ones do (a step that f32
    reproduces only to about 1e-3 of itself, as a ResNet-50's, is no
    fault of the mesh's). Returns which plain bars were met (``bars``) and,
    with ``exact``, each quantity's ``d_mesh / d_one`` (``ratios``)."""
    import torch

    g_outs, g_sds = got
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    w_outs, w_sds = want or mesh_sgd_rank(batches, BASE, device,
                                          starts=[None] + g_sds[:-1],
                                          attention=attention)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    loss_rel = max(abs(float(g["loss"]) - float(w["loss"]))
                   / abs(float(w["loss"])) for g, w in zip(g_outs, w_outs))
    keys = ("tp", "fp", "fn", "correct", "valid")
    moved = [{k: (g[k] - w[k]).tolist() for k in keys
              if not torch.equal(g[k], w[k])} for g, w in zip(g_outs, w_outs)]
    # where the one process's steps counted their near ties, a count may
    # move by at most as many pixels: a pixel whose logits lie within
    # TIE_BAR x max|logit| flips with the float sums' order
    if all("ties" in w for w in w_outs):
        ties = [w["ties"] for w in w_outs]
        over = [{k: v for k, v in m.items() if k == "valid" or
                 float(np.abs(v).max()) > t} for m, t in zip(moved, ties)]
    else:
        ties, over = None, moved
    stats = ("running_mean", "running_var")
    p_err = max(float((g_sd[k] - w_sd[k]).abs().max())
                for g_sd, w_sd in zip(g_sds, w_sds) for k in w_sd
                if w_sd[k].is_floating_point() and not k.endswith(stats))
    s_err = max(float((g_sd[k] - w_sd[k]).abs().max())
                for g_sd, w_sd in zip(g_sds, w_sds) for k in w_sd
                if k.endswith(stats))
    tracked = all(torch.equal(g_sd[k], w_sd[k])
                  for g_sd, w_sd in zip(g_sds, w_sds) for k in w_sd
                  if k.endswith("num_batches_tracked"))
    ok = {"loss": loss_rel <= MESH_BARS[0], "counts": not any(over),
          "parameters": p_err <= MESH_BARS[1],
          "BN statistics": s_err <= MESH_BARS[2]}
    held = {"bars": dict(ok), "ratios": {}}
    noise = ""
    if exact is not None:
        x_outs, x_sds = exact

        def off(sds, is_stat):
            return max(float((sd[k].double() - x_sd[k]).abs().max())
                       for sd, x_sd in zip(sds, x_sds) for k in x_sd
                       if x_sd[k].is_floating_point()
                       and k.endswith(stats) == is_stat)

        def dist(outs, sds):
            return {"loss": max(abs(float(o["loss"]) - float(x["loss"]))
                                / abs(float(x["loss"]))
                                for o, x in zip(outs, x_outs)),
                    "counts": max(float((o[k].double() - x[k].double())
                                        .abs().max())
                                  for o, x in zip(outs, x_outs)
                                  for k in keys),
                    "parameters": off(sds, False),
                    "BN statistics": off(sds, True)}

        d_mesh, d_one = dist(g_outs, g_sds), dist(w_outs, w_sds)
        held["ratios"] = {k: d_mesh[k] / d_one[k] if d_one[k] else
                          (0.0 if d_mesh[k] == 0 else float("inf"))
                          for k in d_mesh}
        for k, good in ok.items():
            ok[k] = good or d_mesh[k] <= FLOAT_NOISE * d_one[k]
        noise = ("; from the f64 steps, the mesh's / one process's f32: "
                 + ", ".join(f"{k} {d_mesh[k]:.3g} / {d_one[k]:.3g} "
                             f"(d_mesh / d_one {held['ratios'][k]:.3g})"
                             for k in d_mesh)
                 + f" (where a bar is missed: at most {FLOAT_NOISE} x one "
                 "process's); every plain bar met: "
                 + ("yes" if all(held["bars"].values()) else
                    "no, " + ", ".join(k for k, v in held["bars"].items()
                                       if not v)))
    b, size = batches[0]["image"].shape[:2]
    net = net or ("U-Net-CA" if attention == "channel" else "U-Net-SA") \
        + f" base {BASE}"
    log(f"  {label} vs one process ({net}, "
        f"{size}^2 global b{b}, {len(w_outs)} SGD "
        f"{MESH_LR} f32 steps, each from the mesh's parameters, "
        f"cudnn.deterministic, TF32 off): loss rel {loss_rel:.3g} (bar "
        f"{MESH_BARS[0]}), counts "
        f"{'equal' if not any(moved) else 'moved ' + json.dumps(moved)}"
        + ("" if ties is None else
           f" (bar: at most the near ties a step, {ties} pixels within "
           f"{TIE_BAR} x max|logit|)")
        + f", parameters {p_err:.3g} (bar {MESH_BARS[1]}), BN statistics "
        f"{s_err:.3g} (bar {MESH_BARS[2]}){noise}")
    if not (all(ok.values()) and tracked):
        raise AssertionError(f"{label}: the mesh's steps differ from one "
                             "process's")
    return held


def mesh_training(dev) -> None:
    """``launch`` on one card: world 1 on NCCL and world 2 on gloo (both
    ranks on ``cuda:0``), each held to the same SGD steps without a group
    (``mesh_hold``); the 2-rank bf16 steps finite and falling; a 2-rank
    ``fit`` with a ``Checkpointer`` and a resume (finite, the ranks'
    histories and states equal, rank 0's files)."""
    import os
    import tempfile

    import torch
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.parallel import launch
    from insarseg_torch.parallel.mesh import default_backend

    size, b = MESH_TRAIN
    batches = [synthetic_batch(b, size, seed=SEED + 80 + i) for i in range(2)]
    # 2 steps and 1 validation batch an epoch: gloo moves the gradients
    # through host memory
    fit_data = ([synthetic_batch(b, size, seed=SEED + 10 + i)
                 for i in range(2)],
                [synthetic_batch(b, size, seed=SEED + 20)])
    backend = default_backend([dev])
    t0 = time.perf_counter()
    (alone,) = launch(mesh_sgd_rank, 1, [dev], args=(batches, BASE, dev))
    log(f"  launch world 1 ({backend}): {time.perf_counter() - t0:.1f} s")
    mesh_hold(alone, batches, dev, f"world 1 on {backend}")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ranks = launch(mesh_gloo_rank, 2, [dev, dev],
                       args=(batches, fit_data, d, BASE, dev))
        log(f"  launch world 2 (gloo, both ranks on one card): "
            f"{time.perf_counter() - t0:.1f} s")
        files = sorted(os.listdir(d))
    for r in ranks:
        mesh_hold(r["sgd"], batches, dev,
                  f"world 2 on gloo, rank {r['fit']['rank']}")
    losses = [r["bf16"] for r in ranks]
    log(f"  world 2 bf16 Adam steps on one global batch: losses {losses}")
    if losses[0] != losses[1] or not (np.all(np.isfinite(losses[0]))
                                      and losses[0][-1] < losses[0][0]):
        raise AssertionError(f"2-rank bf16 losses {losses}")
    fits = [r["fit"] for r in ranks]
    hist2, step2 = fits[0][2]
    hist3, step3 = fits[0][3]
    log(f"  world 2 fit: 2 epochs (step {step2}), resumed to epoch "
        f"{[h['epoch'] for h in hist3]} (step {step3}); files {files}; "
        "history " + json.dumps(hist2 + hist3))
    losses = [h[k] for h in hist2 + hist3 for k in ("train_loss", "val_loss")]
    if not (np.all(np.isfinite(losses)) and step2 == 4 and step3 == 6
            and [h["epoch"] for h in hist3]
            == [3] and files == ["best.pt", "best_miou.json", "latest.pt"]):
        raise AssertionError("the 2-rank fit or its resume went wrong")
    if fits[1][2] != fits[0][2] or fits[1][3] != fits[0][3]:
        raise AssertionError("the ranks' fit histories differ")
    _same_state(fits[0]["state"], fits[1]["state"], "the ranks' states")


def mesh_step_rank(dtype_name, per_card, steps, reps, hold_batches,
                   synced=True):
    """One rank of the multi-card step (or, without a group, one card's):
    the f32 SGD steps of ``mesh_sgd_rank`` on ``hold_batches``, then
    U-Net-CA's train step in ``dtype_name`` at ``HW``^2 with ``per_card``
    tiles a rank, its BatchNorms the mesh's (``sync_batchnorm``; without a
    group the same layers with nothing to sum) or, without ``synced``,
    ``nn.BatchNorm2d``'s, timed with CUDA events (``reps`` repeats of
    ``steps`` warm steps), the gradient all-reduce alone timed the same
    way, and on rank 0 a 3-step profiler window: the NCCL kernels' device
    ms a step (the longest of a step is the gradient all-reduce, the rest
    the BN moments, the loss's count and the scores), the device idle
    share and the top operations' device ms a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.parallel import (
        all_reduce_grads,
        rank,
        sync_batchnorm,
        world,
    )
    from insarseg_torch.train.engine import create_state, make_train_step

    held = mesh_sgd_rank(hold_batches, BASE, "cuda") if hold_batches \
        else None
    torch.backends.cudnn.deterministic = False
    dev = torch.device("cuda", torch.cuda.current_device())
    model = UNet(num_classes=2, base_features=BASE, use_se=True)
    if synced:
        sync_batchnorm(model)
    state = create_state(model, seed=SEED)
    step = make_train_step(model, 2, compute_dtype=_dtype(dtype_name))
    data = synthetic_batch(per_card * world(), HW, seed=SEED + 90)
    x = torch.from_numpy(data["image"]).to(dev)
    m = torch.from_numpy(data["mask"]).to(dev)
    for _ in range(2):
        step(state, x, m)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(steps):
            step(state, x, m)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / steps)
    grad_ms = None
    if world() > 1:
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(steps):
            all_reduce_grads(model.parameters())
        b.record()
        torch.cuda.synchronize()
        grad_ms = a.elapsed_time(b) / steps
    out = {"held": held, "ms": times, "grad_allreduce_ms": grad_ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if rank() == 0:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step(state, x, m)
            torch.cuda.synchronize()
        nccl = [e.time_range.end - e.time_range.start for e in prof.events()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and "nccl" in e.name.lower()]
        nccl.sort(reverse=True)
        out["nccl_kernels_a_step"] = len(nccl) / 3
        out["nccl_grad_ms"] = sum(nccl[:3]) / 3 / 1e3
        out["nccl_other_ms"] = sum(nccl[3:]) / 3 / 1e3
        out["idle"] = device_idle_share(prof)

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))

        top = sorted(prof.key_averages(), key=dev_us, reverse=True)[:8]
        out["top"] = [(e.key[:60], round(dev_us(e) / 3 / 1e3, 3))
                      for e in top]
    else:
        for _ in range(3):
            step(state, x, m)
        torch.cuda.synchronize()
    return out


def preset_rank(root, presets, mesh_data, device="cuda"):
    """``python -m insarseg_torch.cli train`` of each of ``presets`` (as
    ``MESH_PRESETS``) on its VOC tree under ``root`` as a user runs it
    (the default loader), in this process: one device with ``mesh_data``
    "1", one rank of the caller's group with "-1". Returns each preset's
    training seconds an epoch, from the loader's ``set_epoch`` to the end
    of the epoch's train-metrics read (which waits for the card)."""
    from insarseg_torch import cli
    from insarseg_torch.data.voc import BatchLoader
    from insarseg_torch.train import engine

    stamps = []
    set_epoch, result = BatchLoader.set_epoch, engine._Averager.result

    def timed_set_epoch(self, epoch):
        stamps.append(time.perf_counter())
        return set_epoch(self, epoch)

    def timed_result(self, prefix):
        out = result(self, prefix)
        if prefix == "train":
            stamps[-1] = time.perf_counter() - stamps[-1]
        return out

    BatchLoader.set_epoch = timed_set_epoch
    engine._Averager.result = timed_result
    out = {}
    try:
        for preset, size, b, _ in presets:
            stamps.clear()
            if cli.main(["train", "--preset", preset, "--voc-root",
                         f"{root}/{preset}", "--image-size", str(size),
                         "--batch-size", str(b), "--num-epochs",
                         str(MESH_PRESET_EPOCHS), "--model-save-path",
                         f"{root}/{preset}-{mesh_data}/m",
                         "--metrics-save-path",
                         f"{root}/{preset}-{mesh_data}.json",
                         "--mesh-data", mesh_data, "--device", device]):
                raise AssertionError(f"train --preset {preset} failed")
            out[preset] = list(stamps)
    finally:
        BatchLoader.set_epoch, engine._Averager.result = set_epoch, result
    return out


def mesh_presets(n, power_line, presets=MESH_PRESETS, devices=None) -> None:
    """The CLI's default ``train`` on every card (``devices``: the first
    ``n`` cards) against ``--mesh-data 1`` at ``presets``: ms a step and
    tiles/s after the warm-up epoch."""
    import tempfile

    from insarseg_torch.data.synthetic import make_synthetic_voc
    from insarseg_torch.parallel import launch

    device = "cuda" if devices is None else str(devices[0])
    with tempfile.TemporaryDirectory() as root:
        for i, (preset, size, b, steps) in enumerate(presets):
            make_synthetic_voc(f"{root}/{preset}", n_train=b * steps,
                               n_val=b, size=size, seed=SEED + 30 + i)
        one = preset_rank(root, presets, "1", device)
        t0 = time.perf_counter()
        ranks = launch(preset_rank, n, devices,
                       args=(root, presets, "-1", device))
        log(f"  launch world {n} of the preset trains: "
            f"{time.perf_counter() - t0:.1f} s")
    for preset, size, b, steps in presets:
        if len(one[preset]) != MESH_PRESET_EPOCHS:
            raise AssertionError(f"{preset}: epochs timed {one[preset]}")
        ms1 = float(np.median(one[preset][1:])) / steps * 1e3
        msn = float(np.median(ranks[0][preset][1:])) / steps * 1e3
        log(f"  train --preset {preset} ({size}^2 b{b}, {steps} steps an "
            f"epoch), seconds an epoch: one card {one[preset]}, {n} cards "
            f"(rank 0) {ranks[0][preset]}; after the warm-up {ms1:.3f} ms "
            f"a step ({b / ms1 * 1e3:.1f} tiles/s) on one card against "
            f"{msn:.3f} ms ({b / msn * 1e3:.1f} tiles/s) on {n}, x"
            f"{ms1 / msn:.3f}; on {power_line}")


def idle_by_device(prof) -> dict:
    """``device_idle_share`` of each device of a profiler window."""
    spans = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            spans.setdefault(getattr(e, "device_index", 0), []).append(
                (e.time_range.start, e.time_range.end))
    out = {}
    for d, s in sorted(spans.items()):
        s.sort()
        busy, cs, ce = 0.0, s[0][0], s[0][1]
        for a, b in s[1:]:
            if a > ce:
                busy += ce - cs
                cs, ce = a, b
            else:
                ce = max(ce, b)
        busy += ce - cs
        out[d] = 1.0 - busy / (s[-1][1] - s[0][0])
    return out


def mesh_cards(power_line, checked) -> dict:
    """On every card of the machine (more than one): the 4-card NCCL train
    step (U-Net-CA bf16 at ``HW``^2, ``MESH_STEP_TILES`` tiles a card)
    timed against the same tiles-a-card step on one card, the gradient
    all-reduce and the other collectives apart, and the f32 SGD steps held
    to one process's (``mesh_hold``); the CLI's default train on every
    card against one (``mesh_presets``); U-Net-CA int8 over the cards at
    ``MESH_CARD_TILES`` tiles a card, bit-equal to one card, tiles/s
    against one card and each card's idle share; the 16384^2 stream over
    the cards against one card (seconds, the same class map). Returns the
    launches of the one int8 forward at the timed engine batch, every
    kernel call of which is held against its plain version; the streams'
    engine batches a card are checked on a strip first (``checked_strip``),
    and a stream that launches a kernel at a batch no checked call ran
    fails the phase."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    from insarseg_torch import kernels as K
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.engines import engine_from_artifact, pack_engine
    from insarseg_torch.parallel import launch, make_mesh, rows_of
    from insarseg_torch.parallel.mesh import default_backend

    mesh = make_mesh()
    n = mesh.size
    first = mesh.devices[0]
    backend = default_backend(mesh.devices)
    size, b = MESH_TRAIN
    hold = [synthetic_batch(b, size, seed=SEED + 80 + i) for i in range(2)]
    one = mesh_step_rank("bfloat16", MESH_STEP_TILES, 5, 3, None,
                         synced=False)
    one_synced = mesh_step_rank("bfloat16", MESH_STEP_TILES, 5, 3, None)
    t0 = time.perf_counter()
    ranks = launch(mesh_step_rank, n, args=("bfloat16", MESH_STEP_TILES, 5,
                                            3, hold))
    log(f"  launch world {n} ({backend}): {time.perf_counter() - t0:.1f} s")
    for i, r in enumerate(ranks):
        mesh_hold(r["held"], hold, first, f"world {n} on {backend}, rank {i}")
    r0 = ranks[0]
    ms1, msn = float(np.median(one["ms"])), float(np.median(r0["ms"]))
    ms1s = float(np.median(one_synced["ms"]))
    log(f"  U-Net-CA bf16 train step, {HW}^2, {MESH_STEP_TILES} tiles a "
        f"card: one card {ms1:.3f} ms ({one['ms']}; top {one['top']}), "
        f"one card with the mesh's BatchNorms {ms1s:.3f} ms "
        f"({one_synced['ms']}; top {one_synced['top']}), {n} cards "
        f"{msn:.3f} ms ({r0['ms']}, global b{MESH_STEP_TILES * n}; top "
        f"{r0['top']}); {MESH_STEP_TILES / ms1 * 1e3:.1f} vs "
        f"{MESH_STEP_TILES * n / msn * 1e3:.1f} tiles/s, scaling "
        f"{ms1 / msn:.4f} ({ms1s / msn:.4f} against the same layers on one "
        "card); the gradient all-reduce alone "
        f"{r0['grad_allreduce_ms']:.3f} ms; in a profiler window "
        f"{r0['nccl_kernels_a_step']:.1f} NCCL kernels a step, the longest "
        f"(the gradients) {r0['nccl_grad_ms']:.3f} ms, the others "
        f"{r0['nccl_other_ms']:.3f} ms; rank 0 idle share "
        + ("not measured" if r0["idle"] is None
           else f"{100 * r0['idle']:.2f}%")
        + f"; peak {r0['peak_gib']:.3f} GiB a card; on {power_line}")
    mesh_presets(n, power_line)

    rng = np.random.default_rng(SEED + 1)
    calib = [smooth_batch(rng, 4, HW, HW) for _ in range(2)]
    art = pack_engine("unet", "channel",
                      balanced_model("unet", "channel", first), None, "int8",
                      calib_batches=calib, device=first)
    alone = engine_from_artifact(art, device=first)
    cards = engine_from_artifact(art, mesh=mesh)
    xs = torch.from_numpy(smooth_batch(np.random.default_rng(SEED + 71),
                                       MESH_CARD_TILES * n, HW, HW)).to(first)
    ref = torch.cat([alone(c) for c in xs.split(MESH_CARD_TILES)])
    torch.cuda.synchronize(first)
    # the forward whose launches the row reports: the timed engine batch,
    # MESH_CARD_TILES a card, every kernel call checked
    calls = {k: c["calls"] for k, c in checked.items()}
    K.reset_launches()
    t0 = time.perf_counter()
    with checked_calls(checked):
        got = cards(xs)
    for d in mesh.devices:
        torch.cuda.synchronize(d)
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    mesh_checked(launches, {k: {"calls": c["calls"] - calls.get(k, 0)}
                            for k, c in checked.items()})
    log(f"  U-Net-CA int8 over {n} cards at {MESH_CARD_TILES} tiles a card, "
        f"every kernel call checked against its plain version in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    same = torch.equal(ref, got)
    del ref, got

    def rate(fn, x, reps=3):
        fn(x)
        for d in mesh.devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(x)
        for d in mesh.devices:
            torch.cuda.synchronize(d)
        return reps * x.shape[0] / (time.perf_counter() - t0)

    r1 = rate(alone, xs[:MESH_CARD_TILES])
    rn = rate(cards, xs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cards(xs)
        for d in mesh.devices:
            torch.cuda.synchronize(d)
    idle = idle_by_device(prof)
    log(f"  U-Net-CA int8 over {n} cards, {MESH_CARD_TILES * n} tiles "
        f"({MESH_CARD_TILES} a card): {'bit-equal' if same else 'DIFFERENT'}"
        f" to one card; {rn:.1f} tiles/s against one card's {r1:.1f} "
        f"(b{MESH_CARD_TILES}), x{rn / r1:.3f}; idle share by card "
        + json.dumps({d: round(100 * v, 2) for d, v in idle.items()})
        + f" %; on {power_line}")
    if not same:
        raise AssertionError("the int8 engine over the cards differs from "
                             "one card")
    del xs
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        big = scene_file(f"{d}/big.npy", 16384, 16384, SEED + 60, first)
        maps = {}
        for label, fn, k in (("one card", alone, 1),
                             (f"{n} cards", cards, n)):
            bs = MESH_CARD_TILES * k
            # the stream's engine batch checked on its first rows
            checked_strip(StreamRuns(), checked, fn, big, bs,
                          f"16384^2 on {label}")
            runs, path = StreamRuns(), f"{d}/{bs}.npy"
            for _ in range(2):
                stream_at_scale(runs, fn, big, bs, path,
                                f"16384^2 on {label}", power_line)
            maps[label] = np.load(path, mmap_mode="r")
            for kname, batches in runs.batches.items():
                shards = {len(range(b)[rows_of(b, r, k)])
                          for b in batches for r in range(k)}
                missing = shards - checked[kname]["batches"]
                if missing:
                    raise AssertionError(
                        f"16384^2 on {label}: {kname} launched at engine "
                        f"batches {sorted(missing)} a card, never checked "
                        "there")
        same = np.array_equal(*maps.values())
        log(f"  the 16384^2 class maps on one card and on {n}: "
            f"{'equal' if same else 'DIFFERENT'}")
        del maps, big
        if not same:
            raise AssertionError("the stream over the cards differs")
        for f in os.listdir(d):
            os.remove(f"{d}/{f}")
    return launches


def mesh_checked(launches, checked) -> None:
    """Every kernel launch the phase counted was held against its plain
    version: the launches equal the checked calls, kernel by kernel."""
    for k, n in launches.items():
        if checked.get(k, {}).get("calls", 0) != n:
            raise AssertionError(f"{k}: {n} mesh launches, "
                                 f"{checked.get(k, {}).get('calls', 0)} "
                                 "checked")


def mesh_path(dev, power_line: str, phase) -> dict:
    """The ``mesh`` phase: serving over two replicas on one card, the
    training launches on one card, and on a machine with more cards the
    multi-card runs. Returns the launches of its int8 mesh forwards and
    the calls checked against their plain versions."""
    import torch

    log(f"mesh phase on {power_line}, {torch.cuda.device_count()} card(s)")
    checked = {}
    t0 = time.perf_counter()
    launches = mesh_serving(dev, checked)
    mesh_checked(launches, checked)
    phase("mesh: serving over two replicas on one card")
    mesh_training(dev)
    phase("mesh: launch on one card (NCCL world 1, gloo world 2, fit)")
    if torch.cuda.device_count() > 1:
        for k, v in mesh_cards(power_line, checked).items():
            launches[k] = launches.get(k, 0) + v
        phase("mesh: every card")
    log(f"  mesh launches {launches}; kernel calls checked against their "
        "plain versions " + json.dumps(checked, default=sorted)
        + f"; the phase took {time.perf_counter() - t0:.1f} s")
    return launches


SPATIAL_TRAIN = (512, 8)  # the spatial steps' tiles and global batch
SPATIAL_BIG = 1024  # the peak-memory reading's tiles, global b8
# (data, spatial) of the multi-card steps, timed against one card
SPATIAL_MESHES = ((1, 2), (1, 4), (2, 2))
SPATIAL_RESNET_MESHES = ((1, 2), (1, 4))  # DeepLabV3's, timed likewise
# of one card's memory: the largest global batch whose peak it holds
# (``largest_batch``)
SPATIAL_BIG_SHARE = 0.8
SPATIAL_STEPS, SPATIAL_REPS = 5, 3  # warm steps a timing, timings
SPATIAL_FLOAT_BAR = 1e-5  # x max|logit|: the f32 H-sharded forward
# x max|logit|: the ResNet families' f32 H-sharded forward (the port's
# ResNet bar, tests/test_torch_resnet.py)
SPATIAL_RESNET_BAR = 1e-4
# the ResNet cells of the spatial phase: (label, model, attention)
SPATIAL_RESNETS = (("FCN-ResNet50-CA", "fcn", "channel"),
                   ("DeepLabV3-ResNet50", "deeplabv3", "none"),
                   ("PSPNet-ResNet50-CA", "pspnet", "channel"))
HALO_MARK = "spatial halo exchange"  # the profiler range of an exchange
# slabs of any height (``parallel/spatial.py``'s row ranges): the uneven
# steps' tiles (global b8 over 1 x 2: 250-row slabs, 125 / 62.5 / 31.25 /
# 15.6 rows a slab down the U-Net's levels) and their cells; the uneven
# forward over 4 slabs on one card, each cell at its own size: (label,
# model, attention, size)
UNEVEN_TRAIN = 500
UNEVEN_RESNETS = (("DeepLabV3-ResNet50", "deeplabv3", "none"),)
UNEVEN_SLABS = 4
UNEVEN_FORWARD = (("U-Net-CA", "unet", "channel", 500),
                  ("U-Net-SA", "unet", "spatial", 496),
                  ("U-Net-fast-CA", "unet-fast", "channel", 480),
                  ("FCN-ResNet50-CA", "fcn", "channel", 500),
                  ("DeepLabV3-ResNet50", "deeplabv3", "none", 500),
                  ("PSPNet-ResNet50-CA", "pspnet", "channel", 500))
# the four-card uneven readings: U-Net-CA's bf16 step at 1 x 4 (124-row
# slabs) and its peak a card at 992^2 (248-row slabs) against 1024^2
UNEVEN_CARDS = (496, 992)


def checked_steps(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the launch counters from 0 and every
    K8a-K9b call held against its plain version (``checked_bn_calls``):
    its result and, per kernel, [launches, checked calls]."""
    import torch
    from insarseg_torch import kernels as K

    checked = {}
    K.reset_launches()
    with checked_bn_calls(checked):
        got = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return got, {k: [K.LAUNCHES[k], checked.get(k, {}).get("calls", 0)]
                 for k in BN_KERNELS}


def all_checked(label, counts) -> None:
    """Every K8a-K9b kernel launched and each launch checked."""
    log(f"  {label}: K8a-K9b [launches, checked calls] "
        + json.dumps(counts))
    for k, (n, c) in counts.items():
        if n == 0 or n != c:
            raise AssertionError(f"{label}: {k} launched {n} times, "
                                 f"{c} calls checked")


def spatial_bf16_rank(batch, base, device, spatial: int):
    """One rank of U-Net-CA's bf16 train step with its H axis over
    ``spatial`` ranks (or, without a group, the one-card step): a warm
    step, then one step with the launch counters from 0 and every K8a-K9b
    call held against its plain version (``checked_bn_calls``). Returns
    the launches, the checked calls and the two losses."""
    import torch
    from insarseg_torch import kernels as K
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.train.engine import create_state, make_train_step

    model = UNet(num_classes=2, base_features=base, use_se=True)
    state = create_state(model, seed=SEED, device=device)
    step = make_train_step(model, 2, compute_dtype=torch.bfloat16,
                           spatial=spatial)
    x, m = torch.from_numpy(batch["image"]), torch.from_numpy(batch["mask"])
    losses = [float(step(state, x, m)["loss"])]
    torch.cuda.synchronize()
    checked = {}
    K.reset_launches()
    with checked_bn_calls(checked):
        losses.append(float(step(state, x, m)["loss"]))
    torch.cuda.synchronize()
    return {"launches": {k: K.LAUNCHES[k] for k in BN_KERNELS},
            "checked": {k: {"calls": c["calls"],
                            "max_abs_err": c["max_abs_err"]}
                        for k, c in checked.items()},
            "losses": losses}


def spatial_gloo_rank(batches, fit_data, directory, base, device,
                      uneven=None):
    """The one-card spatial checks in one process a rank (world 2, 1 x 2):
    U-Net-CA's and U-Net-SA's f32 SGD steps, the checked bf16 step and
    ``fit`` with its resume; the ResNet cells' f32 SGD steps
    (``SPATIAL_RESNETS``); on the ``uneven`` batches (``UNEVEN_TRAIN``^2)
    U-Net-CA's and ``UNEVEN_RESNETS``' f32 SGD steps and the checked bf16
    step."""
    import torch

    out = {}
    if uneven is not None:
        out["uneven ca"] = mesh_sgd_rank(uneven, base, device, spatial=2)
        out["uneven bf16"] = spatial_bf16_rank(uneven[0], base, device, 2)
        for label, name, attention in UNEVEN_RESNETS:
            torch.cuda.empty_cache()
            out["uneven " + label] = checked_steps(
                mesh_sgd_rank, uneven, base, device, spatial=2,
                resnet=(name, attention))
        torch.cuda.empty_cache()
    out.update({"ca": mesh_sgd_rank(batches, base, device, spatial=2),
                "sa": mesh_sgd_rank(batches, base, device, spatial=2,
                                    attention="spatial"),
                "bf16": spatial_bf16_rank(batches[0], base, device, 2),
                "fit": mesh_fit_rank(*fit_data, directory, base, device,
                                     spatial=2)})
    for label, name, attention in SPATIAL_RESNETS:
        torch.cuda.empty_cache()
        out[label] = checked_steps(mesh_sgd_rank, batches, base, device,
                                   spatial=2, resnet=(name, attention))
    return out


def spatial_training(dev) -> dict:
    """``launch`` world 2 on ``cuda:0`` (gloo), data 1 x spatial 2:
    U-Net-CA and U-Net-SA (base ``BASE``) and the ResNet cells of
    ``SPATIAL_RESNETS`` (dropout off), ``SPATIAL_TRAIN``, f32, TF32 off,
    held to one process's SGD steps at ``MESH_BARS`` (``mesh_hold``;
    each count may move by at most the one process's near-tie pixels,
    ``TIE_BAR``); the bf16 step's every K8a-K9b call held against its
    plain version, its launches a rank equal to the one-card step's; a
    2-epoch ``fit`` with a resume (finite, the ranks equal). At slabs of
    any height (``UNEVEN_TRAIN``^2: 250-row slabs) U-Net-CA's and
    ``UNEVEN_RESNETS``' f32 steps held likewise and the bf16 step checked
    likewise. Returns the two bf16 steps' launches a rank (512^2,
    500^2)."""
    import os
    import tempfile

    import torch
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.parallel import launch

    size, b = SPATIAL_TRAIN
    batches = [synthetic_batch(b, size, seed=SEED + 100 + i)
               for i in range(2)]
    uneven = [synthetic_batch(b, UNEVEN_TRAIN, seed=SEED + 130 + i)
              for i in range(2)]
    fit_data = ([synthetic_batch(MESH_TRAIN[1], MESH_TRAIN[0],
                                 seed=SEED + 10 + i) for i in range(2)],
                [synthetic_batch(MESH_TRAIN[1], MESH_TRAIN[0],
                                 seed=SEED + 20)])
    one = spatial_bf16_rank(batches[0], BASE, dev, 1)
    one_uneven = spatial_bf16_rank(uneven[0], BASE, dev, 1)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ranks = launch(spatial_gloo_rank, 2, [dev, dev],
                       args=(batches, fit_data, d, BASE, dev, uneven))
        log(f"  launch world 2 (gloo, data 1 x spatial 2 on one card): "
            f"{time.perf_counter() - t0:.1f} s")
        files = sorted(os.listdir(d))
    for attention, key in (("channel", "ca"), ("spatial", "sa")):
        _same_state(ranks[0][key][1][-1], ranks[1][key][1][-1],
                    f"the ranks' {key} states")
        want = mesh_sgd_rank(batches, BASE, dev, attention=attention,
                             starts=[None] + ranks[0][key][1][:-1],
                             ties=True)
        for r in ranks:
            mesh_hold(r[key], batches, dev,
                      f"spatial 2 on gloo, rank {r['fit']['rank']}",
                      attention, want)
    cells = [(label, name, attention, batches, label)
             for label, name, attention in SPATIAL_RESNETS]
    cells += [(label, name, attention, uneven, "uneven " + label)
              for label, name, attention in UNEVEN_RESNETS]
    holds = {}
    for label, name, attention, data, key in cells:
        torch.cuda.empty_cache()
        for i, r in enumerate(ranks):
            r[key], counts = r[key]
            all_checked(f"spatial 2 rank {i} {key} f32 steps", counts)
        _same_state(ranks[0][key][1][-1], ranks[1][key][1][-1],
                    f"the ranks' {key} states")
        starts = [None] + ranks[0][key][1][:-1]
        want, counts = checked_steps(mesh_sgd_rank, data, BASE, dev,
                                     resnet=(name, attention),
                                     starts=starts, ties=True)
        all_checked(f"one process {key} f32 steps", counts)
        torch.cuda.empty_cache()
        exact, counts = checked_steps(mesh_sgd_rank, data, BASE, dev,
                                      resnet=(name, attention),
                                      starts=starts, dtype=torch.float64)
        all_checked(f"one process {key} f64 steps", counts)
        for r in ranks:
            holds[f"{key} rank {r['fit']['rank']}"] = mesh_hold(
                r[key], data, dev,
                f"spatial 2 on gloo, rank {r['fit']['rank']}",
                want=want, net=f"{label}, dropout off", exact=exact)
    log("  the ResNet holds: d_mesh / d_one by quantity "
        + json.dumps({k: h["ratios"] for k, h in holds.items()})
        + "; every plain bar of MESH_BARS / TIE_BAR met without FLOAT_NOISE: "
        + ("yes" if all(all(h["bars"].values()) for h in holds.values())
           else "no " + json.dumps({k: h["bars"] for k, h in holds.items()})))
    # U-Net-CA at slabs of any height: 250-row slabs, 15 and 16 rows a
    # slab at the bottleneck
    _same_state(ranks[0]["uneven ca"][1][-1], ranks[1]["uneven ca"][1][-1],
                "the ranks' uneven ca states")
    want = mesh_sgd_rank(uneven, BASE, dev,
                         starts=[None] + ranks[0]["uneven ca"][1][:-1],
                         ties=True)
    for r in ranks:
        mesh_hold(r["uneven ca"], uneven, dev,
                  f"spatial 2 on gloo (uneven slabs), rank "
                  f"{r['fit']['rank']}", want=want)
    launches = {}
    for key, tiles, ref in (("bf16", size, one),
                            ("uneven bf16", UNEVEN_TRAIN, one_uneven)):
        for i, r in enumerate(ranks):
            bf = r[key]
            log(f"  rank {i} {key} step (U-Net-CA base {BASE}, {tiles}^2 "
                f"global b{b}, {tiles // 2}-row slabs): losses "
                f"{bf['losses']}; K8a-K9b launches {bf['launches']} against "
                f"one card's {ref['launches']}; checked against their plain "
                "versions " + json.dumps(bf["checked"]))
            for k, n in bf["launches"].items():
                if n != ref["launches"][k] or n == 0:
                    raise AssertionError(f"{k}: {n} launches a rank a step, "
                                         f"one card {ref['launches'][k]}")
                if bf["checked"].get(k, {}).get("calls") != n:
                    raise AssertionError(f"{k}: {n} launches, "
                                         f"{bf['checked'].get(k)} checked")
            if not np.all(np.isfinite(bf["losses"])):
                raise AssertionError(f"bf16 spatial losses {bf['losses']}")
            launches[key] = bf["launches"]
    fits = [r["fit"] for r in ranks]
    hist2, step2 = fits[0][2]
    hist3, step3 = fits[0][3]
    log(f"  spatial 2 fit: 2 epochs (step {step2}), resumed to epoch "
        f"{[h['epoch'] for h in hist3]} (step {step3}); files {files}; "
        "history " + json.dumps(hist2 + hist3))
    losses = [h[k] for h in hist2 + hist3 for k in ("train_loss", "val_loss")]
    if not (np.all(np.isfinite(losses)) and step2 == 4 and step3 == 6
            and [h["epoch"] for h in hist3] == [3]
            and files == ["best.pt", "best_miou.json", "latest.pt"]):
        raise AssertionError("the spatial fit or its resume went wrong")
    if fits[1][2] != fits[0][2] or fits[1][3] != fits[0][3]:
        raise AssertionError("the ranks' fit histories differ")
    _same_state(fits[0]["state"], fits[1]["state"], "the ranks' states")
    return launches["bf16"], launches["uneven bf16"]


def spatial_forward(dev) -> None:
    """``make_predict_fn`` over ``make_mesh(data=1, spatial=2, devices=
    [cuda:0, cuda:0])`` (one thread a slab) against one device at
    ``HW``^2 b``BATCH``: U-Net-CA, U-Net-SA (base ``BASE``) and
    U-Net-fast-CA (level 1 = 128) in f32 within ``SPATIAL_FLOAT_BAR`` x
    max|logit|, the ResNet cells of ``SPATIAL_RESNETS`` within
    ``SPATIAL_RESNET_BAR``; in bf16 the differing logits counted (no
    bar)."""
    import torch
    from insarseg_torch.parallel import make_mesh, make_predict_fn

    mesh = make_mesh(data=1, spatial=2, devices=[dev, dev])
    x = torch.from_numpy(smooth_batch(np.random.default_rng(SEED + 110),
                                      BATCH, HW, HW)).to(dev)
    for label, name, attention in (
            (f"U-Net-CA base {BASE}", "unet", "channel"),
            (f"U-Net-SA base {BASE}", "unet", "spatial"),
            ("U-Net-fast-CA", "unet-fast", "channel")) + SPATIAL_RESNETS:
        bar = SPATIAL_FLOAT_BAR if name.startswith("unet") \
            else SPATIAL_RESNET_BAR
        model = build_model(name, attention)
        for dtype in (None, torch.bfloat16):
            a = make_predict_fn(model, input_dtype=dtype, device=dev)(x)
            t0 = time.perf_counter()
            b = make_predict_fn(model, input_dtype=dtype, mesh=mesh)(x)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            a, b = a.float(), b.float()
            scale, err = float(a.abs().max()), float((a - b).abs().max())
            agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            what = "bf16" if dtype else "f32"
            log(f"  {label} {what} {HW}^2 b{BATCH}, H over two slabs on one "
                f"card vs one device: {int((a != b).sum())} of {a.numel()} "
                f"logits differ, max {err:.3g} ({err / scale:.3g} x "
                f"max|logit|{'' if dtype else f', bar {bar}'})"
                f", argmax agreement {agree:.6f}; first call {secs:.2f} s")
            if dtype is None and err > bar * scale:
                raise AssertionError(f"{label}: the H-sharded forward "
                                     "differs from one device")
        del model
        torch.cuda.empty_cache()


def spatial_uneven_forward(dev, power_line: str) -> None:
    """``make_predict_fn`` over ``make_mesh(data=1, spatial=UNEVEN_SLABS,
    devices=[cuda:0] * UNEVEN_SLABS)`` (one thread a slab) against one
    device at b``BATCH``, each cell of ``UNEVEN_FORWARD`` at its own size
    (slabs of 125, 124 and 120 rows: the U-Nets' levels and the ResNets'
    strides leave uneven slabs, U-Net-CA resizes at its odd levels): f32
    within ``SPATIAL_FLOAT_BAR`` (the U-Nets) or ``SPATIAL_RESNET_BAR``
    (the ResNets) x max|logit|, bf16 counted, each forward's seconds."""
    import torch
    from insarseg_torch.parallel import make_mesh, make_predict_fn

    mesh = make_mesh(data=1, spatial=UNEVEN_SLABS,
                     devices=[dev] * UNEVEN_SLABS)
    for label, name, attention, size in UNEVEN_FORWARD:
        x = torch.from_numpy(smooth_batch(np.random.default_rng(SEED + 140),
                                          BATCH, size, size)).to(dev)
        bar = SPATIAL_FLOAT_BAR if name.startswith("unet") \
            else SPATIAL_RESNET_BAR
        model = build_model(name, attention)
        for dtype in (None, torch.bfloat16):
            a = make_predict_fn(model, input_dtype=dtype, device=dev)(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = make_predict_fn(model, input_dtype=dtype, mesh=mesh)(x)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            a, b = a.float(), b.float()
            scale, err = float(a.abs().max()), float((a - b).abs().max())
            agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            what = "bf16" if dtype else "f32"
            log(f"  {label} {what} {size}^2 b{BATCH}, H over {UNEVEN_SLABS} "
                f"slabs of {size // UNEVEN_SLABS} rows on one card vs one "
                f"device: {int((a != b).sum())} of {a.numel()} logits "
                f"differ, max {err:.3g} ({err / scale:.3g} x max|logit|"
                f"{'' if dtype else f', bar {bar}'}), argmax agreement "
                f"{agree:.6f}; {secs:.2f} s (first call; on {power_line})")
            if dtype is None and err > bar * scale:
                raise AssertionError(f"{label}: the forward over uneven "
                                     "slabs differs from one device")
        del model, x
        torch.cuda.empty_cache()


def spatial_step_rank(size, batch, spatial, steps, reps, trace, cell=None):
    """One rank of U-Net-CA's bf16 train step (base ``BASE``; ``cell``, a
    ResNet family's (model, attention), that cell with ``build_model``'s
    weights; global b ``batch`` at ``size``^2) with its H axis over
    ``spatial`` ranks (or, without a group, the one-card step): ms a step
    by CUDA events (``reps`` timings of ``steps`` warm steps) and the
    peak memory; with ``trace``, a 3-step profiler window on rank 0: the
    NCCL kernels' device ms a step in all, the device time under the
    halo exchanges (each ``GroupComm.gather``: a halo's forward or
    backward, or a whole map, and a whole map's backward sum of rows,
    marked by a ``record_function`` here: the range's host event alone,
    whose device time is that of the kernels launched inside it) and the
    bytes of their all-reduce buffers, and the device idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.parallel import rank
    from insarseg_torch.train.engine import create_state, make_train_step

    torch.backends.cudnn.deterministic = False
    dev = torch.device("cuda", torch.cuda.current_device())
    if cell is None:
        model = UNet(num_classes=2, base_features=BASE, use_se=True)
        state = create_state(model, seed=SEED, device=dev)
    else:
        model = build_model(*cell).train()
        state = create_state(model, device=dev)
    step = make_train_step(model, 2, compute_dtype=torch.bfloat16,
                           spatial=spatial)
    data = synthetic_batch(batch, size, seed=SEED + 120)
    x = torch.from_numpy(data["image"]).to(dev)
    m = torch.from_numpy(data["mask"]).to(dev)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, x, m)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(steps):
            step(state, x, m)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / steps)
    out = {"ms": times, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if trace and rank() == 0:
        from insarseg_torch.parallel.spatial import GroupComm

        real = {k: getattr(GroupComm, k) for k in ("gather", "sum")}
        moved = []  # each exchange's all-reduce buffer, bytes

        def marked(name):
            def call(comm, t, *a):
                # a gather is a halo (forward or backward) or a whole map;
                # a sum of rows is a whole map's backward
                # (``spatial._Gather``); the pools' sums hold no rows
                if name == "gather":
                    n, c, h, w = t.shape
                    rows = max(a[0]) if a and a[0] else h
                    moved.append(comm.size * n * c * rows * w
                                 * t.element_size())
                elif t.dim() == 4 and t.shape[2] > 1:
                    moved.append(t.numel() * t.element_size())
                else:
                    return real[name](comm, t, *a)
                with torch.profiler.record_function(HALO_MARK):
                    return real[name](comm, t, *a)
            return call

        for k in real:
            setattr(GroupComm, k, marked(k))
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step(state, x, m)
                torch.cuda.synchronize()
        finally:
            for k, fn in real.items():
                setattr(GroupComm, k, fn)
        events = prof.events()
        nccl = [(e.name, e.time_range.end - e.time_range.start)
                for e in events
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and "nccl" in e.name.lower()]
        # the range's host event (the profiler also draws it on the
        # device's timeline); its device time is that of the kernels
        # launched inside it: the buffer's fill and copies and the
        # all-reduce
        halo = [getattr(e, "device_time_total", None) for e in events
                if e.name == HALO_MARK
                and str(getattr(e, "device_type", "")).endswith("CPU")]
        out["halo_ms"] = sum(halo) / 3 / 1e3 if halo and None not in halo \
            else None
        out["halo_calls"] = len(halo) / 3
        out["halo_mb"] = (sum(moved) / 3 / 1e6, max(moved, default=0) / 1e6)
        out["nccl_ms"] = sum(t for _, t in nccl) / 3 / 1e3
        out["nccl_names"] = sorted({n[:48] for n, _ in nccl})
        out["idle"] = device_idle_share(prof)
    elif trace:
        for _ in range(3):
            step(state, x, m)
        torch.cuda.synchronize()
    return out


def spatial_cli(root, devices_flag, preset=TRAIN_PRESET):
    """``python -m insarseg_torch.cli train --mesh-spatial 2`` of
    ``preset`` (U-Net-CA's ``TRAIN_PRESET``, 2 epochs) on the VOC tree
    under ``root``, as a user runs it: the history."""
    from insarseg_torch import cli

    hist = f"{root}/spatial_{preset}.json"
    if cli.main(["train", "--preset", preset, "--voc-root", f"{root}/voc",
                 "--num-epochs", "2", "--model-save-path",
                 f"{root}/m_{preset}/best.ckpt", "--metrics-save-path", hist,
                 "--mesh-spatial", "2", *devices_flag]):
        raise AssertionError(f"train --preset {preset} --mesh-spatial 2 "
                             "failed")
    with open(hist) as f:
        return json.load(f)


def spatial_timings(label, cell, meshes, power_line, size=HW) -> None:
    """``label``'s bf16 step (``spatial_step_rank``'s ``cell``) at
    ``size``^2 global b``BATCH`` over each (data, spatial) of ``meshes``
    that fits the cards, timed against one card with CUDA events, with
    rank 0's halo and all-reduce device ms from a profiler window."""
    import torch
    from insarseg_torch.parallel import launch

    n = torch.cuda.device_count()
    one = spatial_step_rank(size, BATCH, 1, SPATIAL_STEPS, SPATIAL_REPS,
                            True, cell)
    torch.cuda.empty_cache()  # rank 0 shares this process's card
    ms1 = float(np.median(one["ms"]))
    log(f"  {label} bf16 step {size}^2 b{BATCH} on one card: {ms1:.3f} ms "
        f"({one['ms']}), peak {one['peak_gib']:.3f} GiB; on {power_line}")
    for data, spatial in meshes:
        w = data * spatial
        if w > n:
            continue
        t0 = time.perf_counter()
        ranks = launch(spatial_step_rank, w, args=(
            size, BATCH, spatial, SPATIAL_STEPS, SPATIAL_REPS, True, cell))
        r0 = ranks[0]
        msw = float(np.median(r0["ms"]))
        idle, halo = r0.get("idle"), r0["halo_ms"]
        log(f"  {label} data {data} x spatial {spatial} (NCCL, {w} cards, "
            f"launch {time.perf_counter() - t0:.1f} s): {msw:.3f} ms a step "
            f"({r0['ms']}) against one card's {ms1:.3f}, x{ms1 / msw:.3f}; "
            "halo exchanges (the range's host side) "
            + ("not measured" if halo is None else
               f"{halo:.3f} ms of device time a step "
               f"({100 * halo / msw:.2f}% of the step)")
            + f" over {r0['halo_calls']:.0f} exchanges, whose buffers hold "
            f"{r0['halo_mb'][0]:.1f} MB a step, the largest "
            f"{r0['halo_mb'][1]:.1f} MB; NCCL kernels "
            f"{r0['nccl_ms']:.3f} ms in all ({r0['nccl_names']}); rank 0 "
            "idle share "
            + ("not measured" if idle is None else f"{100 * idle:.2f}%")
            + "; peak GiB a card "
            + json.dumps([round(r["peak_gib"], 3) for r in ranks])
            + f"; on {power_line}")
        del ranks


def spatial_peaks(label, cell, batch, spatials, size=SPATIAL_BIG) -> dict:
    """The peak ``max_memory_allocated`` a card of ``label``'s bf16 step at
    ``size``^2 global b``batch``, on one card and over data 1 x each of
    ``spatials`` that fits the cards."""
    import torch
    from insarseg_torch.parallel import launch

    peaks = {"1 card": spatial_step_rank(size, batch, 1, 1, 1, False,
                                         cell)["peak_gib"]}
    torch.cuda.empty_cache()
    for spatial in spatials:
        if spatial <= torch.cuda.device_count():
            ranks = launch(spatial_step_rank, spatial, args=(
                size, batch, spatial, 1, 1, False, cell))
            peaks[f"1 x {spatial}"] = max(r["peak_gib"] for r in ranks)
    log(f"  {label} bf16 step {size}^2 global b{batch}: peak "
        f"max_memory_allocated GiB a card {json.dumps(peaks)}")
    return peaks


def peaks_rank(size, batches, spatial, cell) -> list:
    """The peak memory of one bf16 step at ``size``^2 and each global
    batch of ``batches`` in turn (``spatial_step_rank``), in one process
    (a rank, or one card)."""
    return [spatial_step_rank(size, b, spatial, 1, 1, False, cell)["peak_gib"]
            for b in batches]


def largest_batch(label, cell, spatials) -> int:
    """The largest global batch at ``SPATIAL_BIG``^2 whose bf16 step
    ``SPATIAL_BIG_SHARE`` of a card holds on one card and over data 1 x
    each of ``spatials`` that fits the cards, by each one's peaks at b1
    and b2 (the peak grows linearly in the batch): the smallest of their
    largest batches, each logged."""
    import torch
    from insarseg_torch.parallel import launch

    peaks = {"1 card": peaks_rank(SPATIAL_BIG, (1, 2), 1, cell)}
    torch.cuda.empty_cache()
    for spatial in spatials:
        if spatial <= torch.cuda.device_count():
            ranks = launch(peaks_rank, spatial, args=(SPATIAL_BIG, (1, 2),
                                                      spatial, cell))
            peaks[f"1 x {spatial}"] = [max(r[i] for r in ranks)
                                       for i in range(2)]
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    largest = {k: 1 + int((SPATIAL_BIG_SHARE * total - p1) // (p2 - p1))
               for k, (p1, p2) in peaks.items()}
    log(f"  {label} bf16 step {SPATIAL_BIG}^2: peak GiB a card at b1 and b2 "
        + json.dumps({k: [round(p, 3) for p in v] for k, v in peaks.items()})
        + f" of {total:.1f}: the largest batch in {SPATIAL_BIG_SHARE} of a "
        "card " + json.dumps(largest))
    return min(largest.values())


def spatial_cards(power_line) -> None:
    """On every card (more than one): U-Net-CA's bf16 step over
    ``SPATIAL_MESHES`` and DeepLabV3-ResNet50's over
    ``SPATIAL_RESNET_MESHES`` (``spatial_timings``); the peak memory a
    card at ``SPATIAL_BIG``^2, U-Net-CA's at global b``BATCH`` and
    DeepLabV3's at the largest global batch that one card and spatial 2
    and 4 all hold (``largest_batch``), on one card and at spatial 2 and
    4; the CLI's
    ``train --mesh-spatial 2`` over the cards at U-Net-CA's preset and at
    ``deeplabv3``'s."""
    import tempfile

    import torch
    from insarseg_torch.data.synthetic import make_synthetic_voc

    n = torch.cuda.device_count()
    deeplab = ("deeplabv3", "none")
    spatial_timings("U-Net-CA", None, SPATIAL_MESHES, power_line)
    spatial_timings("DeepLabV3-ResNet50", deeplab, SPATIAL_RESNET_MESHES,
                    power_line)
    spatial_peaks("U-Net-CA", None, BATCH,
                  sorted({s for _, s in SPATIAL_MESHES}))
    # slabs of any height: 124-row slabs timed, 248-row slabs' peak
    spatial_timings("U-Net-CA (uneven slabs)", None, ((1, 4),), power_line,
                    size=UNEVEN_CARDS[0])
    spatial_peaks("U-Net-CA (uneven slabs)", None, BATCH, (4,),
                  size=UNEVEN_CARDS[1])
    spatial_peaks("DeepLabV3-ResNet50", deeplab,
                  largest_batch("DeepLabV3-ResNet50", deeplab, (2, 4)),
                  (2, 4))
    log(f"  (peaks on {power_line})")
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_voc(f"{root}/voc", n_train=32, n_val=8, size=128,
                           seed=SEED + 40)
        for preset in (TRAIN_PRESET, "deeplabv3"):
            t0 = time.perf_counter()
            hist = spatial_cli(root, ["--mesh-data", "-1"], preset)
            log(f"  train --preset {preset} --mesh-spatial 2 --mesh-data "
                f"-1 ({n} cards: data {n // 2} x spatial 2), 2 epochs: "
                f"{time.perf_counter() - t0:.1f} s; history "
                + json.dumps(hist))
            if not all(np.isfinite(h["train_loss"]) for h in hist):
                raise AssertionError(f"train --preset {preset} "
                                     f"--mesh-spatial 2: {hist}")


def spatial_path(dev, power_line: str, phase) -> dict:
    """The ``spatial`` phase (the H axis sharded): the one-card launches
    and the in-process forward, and on a machine with more cards the
    multi-card runs. Returns the K8a-K9b launches a rank of the spatial
    bf16 steps at ``SPATIAL_TRAIN`` and at ``UNEVEN_TRAIN`` (slabs of any
    height)."""
    import torch

    log(f"spatial phase on {power_line}, {torch.cuda.device_count()} "
        "card(s)")
    t0 = time.perf_counter()
    check_bn_fixed_shapes(dev, BN_SLAB_SHAPES)
    phase("spatial: K8a-K9b on slabs of 0, 1, 7 and 15 rows")
    launches, uneven = spatial_training(dev)
    phase("spatial: launch world 2 on one card (f32 steps, bf16 steps, fit; "
          "even and uneven slabs)")
    spatial_forward(dev)
    phase("spatial: the H-sharded forward over two slabs on one card")
    spatial_uneven_forward(dev, power_line)
    phase(f"spatial: the forward over {UNEVEN_SLABS} uneven slabs on one "
          "card")
    if torch.cuda.device_count() > 1:
        spatial_cards(power_line)
        phase("spatial: every card")
    log(f"  spatial launches a rank a step {launches}, at uneven slabs "
        f"{uneven}; the phase took {time.perf_counter() - t0:.1f} s")
    return launches, uneven


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



def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Smoke run of the port on "
                                     "the card (every phase by default).")
    parser.add_argument("--only", choices=["mesh", "spatial", "train"],
                        default=None,
                        help="build the kernels and run this phase alone")
    only = parser.parse_args(argv).only
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

    def finish(result) -> int:
        """The run's result line, the card's line and the contract's last
        line."""
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(result), flush=True)
        print(power_line, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if only == "mesh":
        mesh_launches = mesh_path(dev, power_line, phase)
        return finish({"mesh_launches": mesh_launches})
    if only == "spatial":
        launches, uneven = spatial_path(dev, power_line, phase)
        return finish({"spatial_launches": launches,
                       "spatial_uneven_launches": uneven})
    if only == "train":
        table = train_path(dev, power_line, phase)
        return finish({"kernels": table})

    table = run(dev, power_line, phase)
    for row in table:
        row["train_launches"] = 0
    table += train_path(dev, power_line, phase)
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
    mesh_launches = mesh_path(dev, power_line, phase)
    for row in table:
        row["mesh_launches"] = mesh_launches.get(row["name"], 0)
    spatial_launches, uneven = spatial_path(dev, power_line, phase)
    for row in table:
        row["spatial_launches"] = spatial_launches.get(row["name"], 0)
        row["spatial_uneven_launches"] = uneven.get(row["name"], 0)
    return finish({"kernels": table})


if __name__ == "__main__":
    sys.exit(main())
