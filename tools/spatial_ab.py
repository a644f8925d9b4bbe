#!/usr/bin/env python3
"""Where the time of the H-sharded U-Net-CA train step goes, on every card
of one machine (NVIDIA GPUs, NCCL):

    PYTHONPATH=. python3 tools/spatial_ab.py [--meshes 1x2 1x4 2x2] \
        [--size 512] [--batch 8] [--turns 2]

For each (data x spatial) mesh it launches one process a card
(``parallel.launch``) and times U-Net-CA's bf16 train step (base 64, the
global batch ``--batch`` at ``--size``^2) with CUDA events, 5 warm steps
a timing, under three forms of the spatial transport in turns (every
rank switches in the same order):

- ``slot``: ``parallel/spatial.py::GroupComm`` as it is (each halo's
  gather of the slabs' edge rows one all-reduce of a zeroed buffer with
  a slot a rank);
- ``no-halo``: the halo gathers skipped (zeros come back: the values are
  wrong; the time of the step without them);
- ``no-comm``: the halo gathers and the SE sums skipped (wrong values
  too).

(A ``batch_isend_irecv`` form with the two neighbours, which this tool
timed against the slot form before the halo reached past them, is gone:
a halo now reads any slab its rows lie on.) Beside each timing it reads
the host seconds a step spent inside the gathers and the sums
(``time.perf_counter`` around each call) and the
step's host seconds (the loop's wall clock over the steps, the device
synchronized at the end), and for ``slot`` on rank 0 a 3-step profiler
window: the device idle share and the operations with the most host
time. One card's step (no group) is timed first. Prints one JSON line a
mesh and the card's ``nvidia-smi`` line. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from chip_smoke import BASE, SEED, device_idle_share, nvidia_smi_line

FORMS = ("slot", "no-halo", "no-comm")
STEPS, REPS = 5, 3


def _no_gather(comm, t, heights=None):
    n, c, h, w = t.shape
    return [t.new_zeros((n, c, k, w)) for k in heights or [h] * comm.size]


def rank_main(size, batch, spatial, turns):
    """One rank: the step under each form in turns, with host timers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.parallel import rank
    from insarseg_torch.parallel.spatial import GroupComm
    from insarseg_torch.train.engine import create_state, make_train_step

    dev = torch.device("cuda", torch.cuda.current_device())
    model = UNet(num_classes=2, base_features=BASE, use_se=True)
    state = create_state(model, seed=SEED, device=dev)
    step = make_train_step(model, 2, compute_dtype=torch.bfloat16,
                           spatial=spatial)
    data = synthetic_batch(batch, size, seed=SEED + 120)
    x = torch.from_numpy(data["image"]).to(dev)
    m = torch.from_numpy(data["mask"]).to(dev)
    slot_gather, real_sum = GroupComm.gather, GroupComm.sum
    host = {"gather": 0.0, "sum": 0.0}

    def timed(name, fn):
        def call(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                host[name] += time.perf_counter() - t0
        return call

    forms = {"slot": (slot_gather, real_sum),
             "no-halo": (_no_gather, real_sum),
             "no-comm": (_no_gather, lambda comm, t: t.clone())}
    out = {f: {"ms": [], "host_ms": [], "gather_ms": [], "sum_ms": []}
           for f in FORMS}
    for _ in range(turns):
        for f in FORMS:
            GroupComm.gather = timed("gather", forms[f][0])
            GroupComm.sum = timed("sum", forms[f][1])
            for _ in range(2):
                step(state, x, m)
            torch.cuda.synchronize()
            for _ in range(REPS):
                host["gather"] = host["sum"] = 0.0
                a, b = torch.cuda.Event(enable_timing=True), \
                    torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                a.record()
                for _ in range(STEPS):
                    step(state, x, m)
                b.record()
                torch.cuda.synchronize()
                r = out[f]
                r["host_ms"].append((time.perf_counter() - t0) / STEPS * 1e3)
                r["ms"].append(a.elapsed_time(b) / STEPS)
                r["gather_ms"].append(host["gather"] / STEPS * 1e3)
                r["sum_ms"].append(host["sum"] / STEPS * 1e3)
    GroupComm.gather = timed("gather", slot_gather)
    GroupComm.sum = timed("sum", real_sum)
    if rank() == 0:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step(state, x, m)
            torch.cuda.synchronize()
        top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:12]
        out["idle"] = device_idle_share(prof)
        out["top_host_ms"] = [(e.key[:48], round(e.self_cpu_time_total
                                                 / 3 / 1e3, 3), e.count // 3)
                              for e in top]
    else:
        for _ in range(3):
            step(state, x, m)
        torch.cuda.synchronize()
    GroupComm.gather, GroupComm.sum = slot_gather, real_sum
    return out


def one_card(size, batch):
    """One card's step (no group): CUDA-event ms and host ms."""
    import torch
    from insarseg_torch.data.synthetic import synthetic_batch
    from insarseg_torch.models.unet import UNet
    from insarseg_torch.train.engine import create_state, make_train_step

    dev = torch.device("cuda", 0)
    model = UNet(num_classes=2, base_features=BASE, use_se=True)
    state = create_state(model, seed=SEED, device=dev)
    step = make_train_step(model, 2, compute_dtype=torch.bfloat16)
    data = synthetic_batch(batch, size, seed=SEED + 120)
    x = torch.from_numpy(data["image"]).to(dev)
    m = torch.from_numpy(data["mask"]).to(dev)
    for _ in range(2):
        step(state, x, m)
    torch.cuda.synchronize()
    ms, host = [], []
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(STEPS):
            step(state, x, m)
        b.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) / STEPS * 1e3)
        ms.append(a.elapsed_time(b) / STEPS)
    return {"ms": ms, "host_ms": host}


def main(argv=None) -> int:
    import torch
    from insarseg_torch.parallel import launch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--meshes", nargs="+", default=["1x2", "1x4", "2x2"])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spatial_ab: needs CUDA devices")
    line = nvidia_smi_line()
    n = torch.cuda.device_count()
    one = one_card(args.size, args.batch)
    torch.cuda.empty_cache()
    print(json.dumps({"mesh": "one card", "size": args.size,
                      "batch": args.batch, **one}), flush=True)
    for spec in args.meshes:
        data, spatial = (int(v) for v in spec.split("x"))
        if data * spatial > n:
            continue
        ranks = launch(rank_main, data * spatial,
                       args=(args.size, args.batch, spatial, args.turns))
        r0 = ranks[0]
        summary = {f: {k: float(np.median(v)) for k, v in r0[f].items()}
                   for f in FORMS}
        print(json.dumps({"mesh": spec, "size": args.size,
                          "batch": args.batch, "median": summary,
                          "rank0": {f: r0[f] for f in FORMS},
                          "idle": r0["idle"],
                          "top_host_ms": r0["top_host_ms"]}), flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
