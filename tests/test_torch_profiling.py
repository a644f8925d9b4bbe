"""The port's ``utils/profiling.py`` against the JAX package's: the same
recorded step times give the same ``StepTimer`` mean, p50 and summary
(warmup skipped), and ``tiles_per_sec`` with ``n_chips`` given the same
rate; ``sync`` returns at once on a CPU tensor; ``trace`` writes a trace
into its directory on the CPU."""

import os

import pytest
import torch

from insarseg.utils import profiling as JP
from insarseg_torch.utils import profiling as TP

TIMES = [0.5, 0.0125, 0.0101, 0.0187, 0.0099, 0.0142]


def _clock(monkeypatch, module):
    """``module``'s clock replaced by one that reads out ``TIMES`` as step
    lengths: each ``start`` / ``stop`` pair is one step."""
    ticks = []
    for dt in TIMES:
        base = len(ticks) * 10.0
        ticks += [base, base + dt]
    it = iter(ticks)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))


def _timed(monkeypatch, module, warmup):
    _clock(monkeypatch, module)
    timer = module.StepTimer(warmup=warmup)
    for _ in TIMES:
        timer.start()
        timer.stop()
    return timer


@pytest.mark.parametrize("warmup", [0, 1, 2])
def test_step_timer_matches_jax(monkeypatch, warmup):
    ours = _timed(monkeypatch, TP, warmup)
    ref = _timed(monkeypatch, JP, warmup)
    assert ours.mean == ref.mean and ours.p50 == ref.p50
    assert ours.summary() == ref.summary()
    assert f"steps={len(TIMES) - warmup}" in ours.summary()
    for n_chips in (1, 4):
        for tile in (128, 512):
            assert TP.tiles_per_sec(ours, 8, tile, n_chips=n_chips) == \
                JP.tiles_per_sec(ref, 8, tile, n_chips=n_chips)


def test_step_timer_without_steps():
    timer = TP.StepTimer(warmup=3)
    timer.start()
    timer.stop(torch.zeros(2))
    assert timer.summary() == JP.StepTimer().summary() == "no timed steps"
    assert timer.mean != timer.mean  # nan


def test_tiles_per_sec_counts_the_cards(monkeypatch):
    timer = _timed(monkeypatch, TP, 1)
    monkeypatch.setattr(TP.torch.cuda, "device_count", lambda: 4)
    assert TP.tiles_per_sec(timer, 8, 512) == \
        TP.tiles_per_sec(timer, 8, 512, n_chips=4)
    monkeypatch.setattr(TP.torch.cuda, "device_count", lambda: 0)
    assert TP.tiles_per_sec(timer, 8, 512) == 8 / timer.mean


def test_trace_writes_a_directory_on_the_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    with TP.trace(str(log_dir)):
        y = torch.ones(64, 64) @ torch.ones(64, 64)
        TP.sync(y)
    files = os.listdir(log_dir)
    assert files and all(f.endswith(".json") for f in files)
    assert os.path.getsize(log_dir / files[0]) > 0
