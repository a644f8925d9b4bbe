"""DeepLabV3-CA's train step against the JAX package's, in float64: the
CBAM channel gate in train mode through ``kernels/se_train.py::
cbam_train`` (K10a-K11b's plain versions in their cbam mode on the CPU),
at 32^2 batch 2, 3 Adam steps, dropout off on both sides, from the JAX
tree filled with numpy draws and crossed with
``segmentation_variables_to_torch``, with
``tests/test_torch_train_resnet.py``'s runner (one subprocess,
``JAX_ENABLE_X64``, on one thread) and bars (``F64_BARS``: every step's
loss within 1e-8 and every running statistic within 1e-7 of the JAX
step's, after the first step and after the last). The gate's input is
``relu(head_bn(head_conv(.)))``, so planes that the ReLU zeroes whole
tie their max at every position. Its own file so that ``--dist
loadfile`` gives it a worker of its own."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# family -> (model, attention, batch, steps), at 32^2
FAMILIES = {"deeplabv3-ca": ("deeplabv3", "channel", 2, 3)}


@pytest.fixture(scope="module")
def x64_runs():
    """This file's ``__main__`` once per family, each on one thread."""
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
def test_cbam_train_steps_match_jax_in_float64(x64_runs, family):
    from tests.test_torch_train_resnet import F64_BARS

    res = x64_runs[family]
    jl, tl = np.asarray(res["jax"]), np.asarray(res["torch"])
    assert len(jl) == FAMILIES[family][3] and np.isfinite(tl).all()
    assert np.abs(jl - tl).max() < F64_BARS[0], (family, jl, tl)
    assert res["stat_diff_1"] < F64_BARS[1], (family, res["stat_diff_1"])
    assert res["stat_diff"] < F64_BARS[1], (family, res["stat_diff"])
    assert jl[-1] != jl[0], "did not train"


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from tests import test_torch_train_resnet as TR

    TR.FAMILIES.update(FAMILIES)
    TR._run_families(sys.argv[1:])
