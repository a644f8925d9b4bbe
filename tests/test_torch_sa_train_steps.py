"""The -SA heads' train steps against the JAX package's, in float64: FCN-SA
and DeepLabV3-SA (``SpatialAttentionConv`` in train mode through
``kernels/sa_train.py::sa_tail``, K12a-K13b's plain versions on the CPU),
at 32^2 batch 2, dropout off on both sides, from the JAX tree filled with
numpy draws and crossed with ``segmentation_variables_to_torch``, with
``tests/test_torch_train_resnet.py``'s runner (one subprocess a cell,
``JAX_ENABLE_X64``, both on one thread) and bars (``F64_BARS``: every
step's loss within 1e-8 and every running statistic within 1e-7 of the
JAX step's, after the first step and after the last). FCN-SA takes 3
Adam steps; DeepLabV3-SA 2 at the packages' default Adam eps (1e-8), and
3 at an eps of 1e-4 that both packages share (the JAX ``TrainState``'s
``optax.adam`` and the port's optimizer's ``param_groups``, as the
runner's fifth field sets them): at eps 1e-8 its third step reads loss
1.29e-8 and statistics 5.3e-7 from JAX's (after the second 9.2e-10 and
1.5e-8); at 1e-5, 5.7e-9 and 6.3e-8; at 1e-4, 1.0e-10 and 3.7e-9.
Adam's first step moves each weight by lr g / (|g| + eps): an element
whose gradient lies near eps moves by about lr / eps times a difference
in it. ``tests/sa_adam_probe.py`` shows that the distance comes from
such elements and not from the SA path: after the first step the two
packages' updates differ by up to 3.75e-9 at elements whose gradient is
below 1e3 eps (3 of ``backbone.layer1.0.conv2``'s, 206 of
``layer3.1.conv1``'s, among 111 parameters with such elements) and by
at most 3.6e-14 elsewhere; setting those elements (values and both Adam
moments) to the JAX step's after step 1 cuts the step-3 distance to
2.1e-12 (loss) and 3.4e-11 (statistics), while setting every other
element, or the SA head's conv alone, leaves it at 1.29e-8 and 5.3e-7.
The SA head's first-step gradient lies 5.2e-13 of its largest from
JAX's. U-Net-SA's step is held by
``tests/test_torch_train.py::test_train_steps_match_jax``. Its own file
so that ``--dist loadfile`` gives it a worker of its own."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# family -> (model, attention, batch, steps[, Adam eps]), at 32^2
FAMILIES = {
    "deeplabv3-sa": ("deeplabv3", "spatial", 2, 2),
    "deeplabv3-sa-eps1e-4": ("deeplabv3", "spatial", 2, 3, 1e-4),
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
