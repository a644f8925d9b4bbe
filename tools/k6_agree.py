#!/usr/bin/env python3
"""What K6's tensor-core sums do to the U-Net int8 forwards end to end, over
several seeds, on one NVIDIA GPU:

    PYTHONPATH=. python3 tools/k6_agree.py [SEED ...]   (default 0 1 2 3 4)

K6 (``up_concat_i8``) sums on the tensor cores in their own order, so a few
of its codes differ by one from its plain version (the counted bar,
``kernels.assert_up_codes_close``). For each seed and each U-Net main path
of ``chip_smoke.py`` (U-Net-CA in H-s2d, U-Net-SA, U-Net-fast-CA at 512^2
tiles, batch 8; weights, calibration and images made from the seed as
``chip_smoke.py`` makes them from its own) it prints:

- how many of K6's codes differ in one forward (each call's kernel output
  against its plain version on the same inputs);
- the argmax agreement of the forward as it is with the same forward on
  K6's plain version, and where the argmax flips, the margins (top logit
  less the second, of the K6-plain forward) of the flipped pixels against
  those of all pixels;
- a second witness, independent of the kernel: the K6-plain forward with
  +-1 added to as many of K6's codes, at random places in each call, as
  the kernel changed in that call, against the K6-plain forward;
- ``chip_smoke.card_vs_cpu_readings``: the card's forward (as it is, and
  on K6's plain version) against the CPU's plain path at 64^2, b2.

Last, the smallest reading of each over the seeds, and the card's
``nvidia-smi`` line. Needs a CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

import chip_smoke as cs
from insarseg_torch import kernels as K
from insarseg_torch.models import unet_int8

PATHS = (("unet", "channel", "U-Net-CA"), ("unet", "spatial", "U-Net-SA"),
         ("unet-fast", "channel", "U-Net-fast-CA"))


@contextlib.contextmanager
def k6_counted(counts):
    """The forward as it is; each K6 call also runs the plain version on
    the same inputs and appends (differing codes, codes) to ``counts``."""
    saved = unet_int8.up_concat_i8

    def counted(y, w, bias, skip, cat_s, s2d=False):
        got = K.up_concat_i8(y, w, bias, skip, cat_s, s2d)
        want = K.up_concat_i8_plain(y, w, bias, skip, cat_s, s2d)
        cs_ = skip.shape[-1]
        counts.append((int((got[..., cs_:] != want[..., cs_:]).sum()),
                       got[..., cs_:].numel()))
        return got
    unet_int8.up_concat_i8 = counted
    try:
        yield
    finally:
        unet_int8.up_concat_i8 = saved


@contextlib.contextmanager
def k6_injected(counts, seed):
    """K6's plain version with +-1 (random sign, clipped to +-127) added to
    ``counts[i][0]`` of the ConvT's codes, at random places, in call i."""
    saved = unet_int8.up_concat_i8
    rng = np.random.default_rng(seed)
    calls = iter(counts)

    def injected(y, w, bias, skip, cat_s, s2d=False):
        out = K.up_concat_i8_plain(y, w, bias, skip, cat_s, s2d)
        n_flip, _ = next(calls)
        cs_ = skip.shape[-1]
        z = out[..., cs_:].contiguous()
        flat = z.view(-1)
        idx = torch.from_numpy(rng.integers(0, flat.numel(), n_flip))
        sign = torch.from_numpy(rng.choice(np.array([-1, 1], np.int16),
                                           n_flip))
        idx, sign = idx.to(out.device), sign.to(out.device)
        flat[idx] = (flat[idx].to(torch.int16) + sign).clamp(
            -127, 127).to(torch.int8)
        out[..., cs_:] = z
        return out
    unet_int8.up_concat_i8 = injected
    try:
        yield
    finally:
        unet_int8.up_concat_i8 = saved


def main(argv) -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seeds = [int(a) for a in argv] or [0, 1, 2, 3, 4]
    dev = torch.device("cuda")
    K.load_library()
    power_line = cs.nvidia_smi_line()
    worst = {}
    for seed in seeds:
        images = cs.smooth_batch(np.random.default_rng(seed + 2), cs.BATCH,
                                 cs.HW, cs.HW)
        for name, attention, label in PATHS:
            model = cs.build_model(name, attention, seed=seed)
            rng = np.random.default_rng(seed + 1)
            calib = [cs.smooth_batch(rng, 4, cs.HW, cs.HW) for _ in range(2)]
            predict = cs.build_engines(dev, name, attention, model, calib,
                                       full=False)["int8"]
            counts = []
            with k6_counted(counts):
                y = predict(images).float().cpu().numpy()
            with cs.k6_plain():
                y_plain = predict(images).float().cpu().numpy()
            with k6_injected(counts, seed + 9):
                y_inj = predict(images).float().cpu().numpy()
            agree = float(np.mean(y.argmax(-1) == y_plain.argmax(-1)))
            agree_inj = float(np.mean(y_inj.argmax(-1)
                                      == y_plain.argmax(-1)))
            flips = cs.flip_margins(y, y_plain)
            card = cs.card_vs_cpu_readings(dev, name, attention, model,
                                           calib, images)
            n_diff = sum(c[0] for c in counts)
            n_all = sum(c[1] for c in counts)
            print(f"seed {seed} {label}: K6 codes differing "
                  f"{n_diff} of {n_all} ({[c[0] for c in counts]} a call); "
                  f"argmax vs K6 plain {agree:.6f} ({flips}); "
                  f"+-1 at as many random codes {agree_inj:.6f}; card vs CPU"
                  + "".join(f", {k}: corr {v[1]:.6f} argmax {v[2]:.5f}"
                            for k, v in card.items()), flush=True)
            w = worst.setdefault(label, {})
            for key, v in (("vs K6 plain", agree), ("injected", agree_inj),
                           *((f"CPU {k} corr", r[1]) for k, r in
                             card.items()),
                           *((f"CPU {k} argmax", r[2]) for k, r in
                             card.items())):
                w[key] = min(w.get(key, 1.0), v)
            del predict, model
            torch.cuda.empty_cache()
    for label, w in worst.items():
        print(f"smallest over seeds {seeds}, {label}: "
              + ", ".join(f"{k} {v:.6f}" for k, v in w.items()), flush=True)
    print(f"card: {power_line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
