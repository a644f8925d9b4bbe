#!/usr/bin/env python3
"""The U-Net-CA (base 64) train step of another checkout against this
one's, in turns on one NVIDIA GPU:

    PYTHONPATH=. python3 tools/step_ab.py OTHER_TREE [--sizes 512 128] \
        [--dtypes bfloat16 float32] [--remat] [--attention spatial]

With ``--attention spatial`` the step is U-Net-SA's (base 64, the same
seeded init and synthetic batch), timed in the turn itself by the same
rule as ``chip_smoke.train_step_timing`` (a warm step, then the median of
3 repeats of CUDA-event ms over 2 steps at 512^2 or 5 at smaller sizes),
so that a tree whose ``chip_smoke`` times U-Net-CA alone takes part.

OTHER_TREE is a checkout of another commit (``git archive <commit> |
tar -x -C _tree/parent``). Each turn is a fresh process that imports the
tree's own ``insarseg_torch`` and ``chip_smoke`` (its kernels built into
the tree) and times the step with ``chip_smoke.train_step_timing`` (CUDA
events, the median of 3 repeats of 2 warm steps at 512^2 or 5 at smaller
sizes, b8, TF32 off, no profiler window) for each dtype and size, in the
order other, this, this, other. It prints each turn's ms, the two trees'
means and the card's ``nvidia-smi`` line. Needs a CUDA device and nvcc;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import nvidia_smi_line

RUN = """
import json, sys, torch
sys.path.insert(0, {tree!r})
import chip_smoke as cs
from insarseg_torch import kernels as K
K.load_library()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
out = {{}}
for dtype in {dtypes!r}:
    for size in {sizes!r}:
        r = cs.train_step_timing(torch.device("cuda"), size, 8, "",
                                 2 if size >= 512 else 5, dtype,
                                 remat={remat!r}, profile=False)
        out[f"{{dtype}} {{size}}"] = r["ms"]
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
"""


RUN_SA = """
import json, sys, numpy as np, torch
sys.path.insert(0, {tree!r})
from insarseg_torch import kernels as K
from insarseg_torch.config import COMPUTE_DTYPES
from insarseg_torch.data.synthetic import synthetic_batch
from insarseg_torch.models.unet import UNet
from insarseg_torch.train.engine import create_state, make_train_step
K.load_library()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
out = {{}}
for dtype in {dtypes!r}:
    for size in {sizes!r}:
        model = UNet(num_classes=2, base_features=64, use_sa=True,
                     remat={remat!r})
        state = create_state(model, seed=0, device=dev)
        step = make_train_step(model, 2, compute_dtype=COMPUTE_DTYPES[dtype])
        data = synthetic_batch(8, size, seed=30)
        x = torch.from_numpy(data["image"]).to(dev)
        m = torch.from_numpy(data["mask"]).to(dev)
        step(state, x, m)
        n = 2 if size >= 512 else 5
        ms = []
        for _ in range(3):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(n):
                step(state, x, m)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1) / n)
        out[f"{{dtype}} {{size}}"] = float(np.median(ms))
        del state, step, model
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
"""


def turn(tree: Path, sizes, dtypes, remat, attention="channel") -> dict:
    code = (RUN_SA if attention == "spatial" else RUN).format(
        tree=str(tree), sizes=list(sizes), dtypes=list(dtypes), remat=remat)
    r = subprocess.run([sys.executable, "-c", code], cwd=tree,
                       capture_output=True, text=True, timeout=900)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    if r.returncode or not lines:
        raise RuntimeError(f"{tree}: exit {r.returncode}\n"
                           f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other")
    parser.add_argument("--sizes", type=int, nargs="*", default=[512, 128])
    parser.add_argument("--dtypes", nargs="*",
                        default=["bfloat16", "float32"])
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--attention", choices=["channel", "spatial"],
                        default="channel",
                        help="U-Net-CA's step (channel) or U-Net-SA's")
    args = parser.parse_args(argv)
    here = Path(__file__).resolve().parent.parent
    trees = {"other": Path(args.other).resolve(), "this": here}
    got = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        ms = turn(trees[name], args.sizes, args.dtypes, args.remat,
                  args.attention)
        got[name].append(ms)
        print(f"{name} ({trees[name]}): " + json.dumps(ms), flush=True)
    for key in got["this"][0]:
        o = [t[key] for t in got["other"]]
        t = [t[key] for t in got["this"]]
        cell = "U-Net-SA" if args.attention == "spatial" else "U-Net-CA"
        print(f"{cell} train step {key}{' remat' if args.remat else ''}: "
              f"other "
              f"{sum(o) / 2:.3f} ms ({o[0]:.3f} / {o[1]:.3f}), this "
              f"{sum(t) / 2:.3f} ms ({t[0]:.3f} / {t[1]:.3f})", flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
