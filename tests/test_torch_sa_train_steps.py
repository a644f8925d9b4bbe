"""The -SA heads' train steps against the JAX package's, in float64: FCN-SA
and DeepLabV3-SA (``SpatialAttentionConv`` in train mode through
``kernels/sa_train.py::sa_tail``, K12a-K13b's plain versions on the CPU),
at 32^2 batch 2, dropout off on both sides, from the JAX tree filled with
numpy draws and crossed with ``segmentation_variables_to_torch``, with
``tests/test_torch_train_resnet.py``'s runner (one subprocess a cell,
``JAX_ENABLE_X64``, both on one thread) and bars (``F64_BARS``: every
step's loss within 1e-8 and every running statistic within 1e-7 of the
JAX step's, after the first step and after the last). FCN-SA takes 3
Adam steps, DeepLabV3-SA 2: at its third its loss reads 1.29e-8 and its
statistics 5.3e-7 from JAX's (after the second 9.2e-10 and 1.5e-8).
Adam's first step moves each weight by lr g / (|g| + eps): an element
whose gradient lies near eps (1e-8) moves by up to lr on 1e-12 of
difference in it, and the third step's forward reads those moves.
DeepLabV3-SA's first-step gradients agree with JAX's to 8e-11 of each
tensor's largest (the backbone's stem and layer1 convs: 1.9e-10 of 3.2),
as DeepLabV3's, which meets the bars at 3 steps, do to 2e-11 (SGD steps
at lr 1 read on both packages). U-Net-SA's step is held by
``tests/test_torch_train.py::test_train_steps_match_jax``. Its own file
so that ``--dist loadfile`` gives it a worker of its own."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# family -> (model, attention, batch, steps), at 32^2
FAMILIES = {
    "deeplabv3-sa": ("deeplabv3", "spatial", 2, 2),
    "fcn-sa": ("fcn", "spatial", 2, 3),
}


@pytest.fixture(scope="module")
def x64_runs():
    """This file's ``__main__`` once per family, the processes at once,
    each on one thread."""
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    procs = {fam: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), fam], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for fam in FAMILIES}
    out = {}
    for fam, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        assert p.returncode == 0 and lines, stderr[-4000:]
        out.update(json.loads(lines[-1][len("RESULT "):]))
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sa_train_steps_match_jax_in_float64(x64_runs, family):
    from tests.test_torch_train_resnet import F64_BARS

    res = x64_runs[family]
    jl, tl = np.asarray(res["jax"]), np.asarray(res["torch"])
    assert np.isfinite(tl).all()
    assert np.abs(jl - tl).max() < F64_BARS[0], (family, jl, tl)
    assert res["stat_diff_1"] < F64_BARS[1], (family, res["stat_diff_1"])
    assert res["stat_diff"] < F64_BARS[1], (family, res["stat_diff"])
    assert jl[-1] != jl[0], "did not train"


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from tests import test_torch_train_resnet as TR

    TR.FAMILIES.update(FAMILIES)
    TR._run_families(sys.argv[1:])
