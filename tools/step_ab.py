#!/usr/bin/env python3
"""The U-Net-CA (base 64) train step of another checkout against this
one's, in turns on one NVIDIA GPU:

    PYTHONPATH=. python3 tools/step_ab.py OTHER_TREE [--sizes 512 128] \
        [--dtypes bfloat16 float32] [--remat]

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


def turn(tree: Path, sizes, dtypes, remat) -> dict:
    code = RUN.format(tree=str(tree), sizes=list(sizes), dtypes=list(dtypes),
                      remat=remat)
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
    args = parser.parse_args(argv)
    here = Path(__file__).resolve().parent.parent
    trees = {"other": Path(args.other).resolve(), "this": here}
    got = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        ms = turn(trees[name], args.sizes, args.dtypes, args.remat)
        got[name].append(ms)
        print(f"{name} ({trees[name]}): " + json.dumps(ms), flush=True)
    for key in got["this"][0]:
        o = [t[key] for t in got["other"]]
        t = [t[key] for t in got["this"]]
        print(f"train step {key}{' remat' if args.remat else ''}: other "
              f"{sum(o) / 2:.3f} ms ({o[0]:.3f} / {o[1]:.3f}), this "
              f"{sum(t) / 2:.3f} ms ({t[0]:.3f} / {t[1]:.3f})", flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
