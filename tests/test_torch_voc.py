"""The port's data path (``insarseg_torch/data/voc.py``,
``data/native_loader.py`` with its own ``csrc/tileops.cpp``,
``data/synthetic.py::make_synthetic_voc``) against the JAX package's
``insarseg/data``, on one synthetic VOC tree:

- ``make_synthetic_voc`` writes the JAX package's bytes from the same
  seed;
- ``VOCSegDataset`` gives the JAX package's arrays, equal, for both mask
  contracts, with and without ``raw_u8``; ``BatchLoader`` the same batches
  for two shuffled epochs, with the padded tail (zeros, ``ignore_index``
  masks, ``n_valid``), with ``drop_last`` and with worker threads;
- the native loader equals the JAX package's native loader (the same C
  arithmetic); its images are within 1e-6 of the Python path's (C
  computes ``x * a + b``, numpy ``(x / 255 - mean) / std``: 4.8e-7 apart
  at most at mean 0.3, std 0.2, two f32 ulps of the values' range), its
  masks and ``raw_u8`` bytes equal; ``normalize_batch_host`` and
  ``stitch_accumulate_host`` equal the JAX package's; the library is built
  into ``insarseg_torch/_build/`` from ``insarseg_torch/csrc/``, and a
  failed build raises instead of falling back;
- ``PrefetchLoader`` yields its loader's batches, hands a worker's error
  to the consumer and ends its thread on an early close.
"""

import filecmp
import os

import numpy as np
import pytest

from insarseg.data import native_loader as JN
from insarseg.data import voc as JV
from insarseg.data.synthetic import make_synthetic_voc as jax_make_voc
from insarseg_torch.data import native_loader as TN
from insarseg_torch.data import voc as TV
from insarseg_torch.data.synthetic import make_synthetic_voc

SIZE = 24  # resized from the 40^2 files: bilinear and nearest both work


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc") / "voc")
    make_synthetic_voc(root, n_train=7, n_val=3, size=40, seed=4)
    return root


def test_make_synthetic_voc_writes_the_jax_files(voc, tmp_path):
    theirs = jax_make_voc(str(tmp_path / "jax"), n_train=7, n_val=3,
                          size=40, seed=4)
    files = []
    for d, _, names in os.walk(theirs):
        files += [os.path.relpath(os.path.join(d, n), theirs) for n in names]
    assert len(files) == 2 * 10 + 2
    for rel in files:
        assert filecmp.cmp(os.path.join(voc, rel), os.path.join(theirs, rel),
                           shallow=False), rel


def _kw(contract, raw_u8):
    return dict(mask_contract=contract, normalize_mean=0.3,
                normalize_std=0.2, ignore_index=255, raw_u8=raw_u8)


def _assert_items_equal(a, b):
    assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("contract", ["legacy", "index"])
@pytest.mark.parametrize("raw_u8", [False, True])
@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_matches_jax(voc, contract, raw_u8, split):
    ours = TV.VOCSegDataset(voc, SIZE, split, **_kw(contract, raw_u8))
    theirs = JV.VOCSegDataset(voc, SIZE, split, **_kw(contract, raw_u8))
    assert ours.ids == theirs.ids and len(ours) == len(theirs)
    for i in range(len(ours)):
        _assert_items_equal(ours[i], theirs[i])
    x, m = ours[0]
    assert x.shape == (SIZE, SIZE, 1) and m.shape == (SIZE, SIZE)
    assert x.dtype == (np.uint8 if raw_u8 else np.float32)
    assert m.dtype == np.int32
    want = {0, 1} if contract == "legacy" else {0, 255}
    assert set(np.unique(m)) <= want


def test_dataset_errors(voc):
    with pytest.raises(FileNotFoundError, match="split file"):
        TV.VOCSegDataset(voc, SIZE, "test")
    with pytest.raises(ValueError, match="mask_contract"):
        TV.VOCSegDataset(voc, SIZE, mask_contract="binary")


def _batches(loader, epochs):
    return [b for _ in range(epochs) for b in loader]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["n_valid"] == w["n_valid"]
        for k in ("image", "mask"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("workers", [0, 2])
def test_batch_loader_matches_jax(voc, drop_last, workers):
    """7 training samples in batches of 3: two epochs of the shuffle
    order, the tail of 1 padded (or dropped)."""
    kw = dict(shuffle=True, seed=5, ignore_index=255, drop_last=drop_last,
              num_workers=workers)
    ours = TV.BatchLoader(TV.VOCSegDataset(voc, SIZE, "train"), 3, **kw)
    theirs = JV.BatchLoader(JV.VOCSegDataset(voc, SIZE, "train"), 3, **kw)
    got, want = _batches(ours, 2), _batches(theirs, 2)
    _assert_batches_equal(got, want)
    assert len(ours) == len(theirs) == (2 if drop_last else 3)
    assert len(got) == 2 * len(ours)
    # the two epochs are shuffled differently
    assert not np.array_equal(got[0]["image"], got[len(ours)]["image"])
    if not drop_last:
        tail = got[2]
        assert tail["n_valid"] == 1
        assert not tail["image"][1:].any()
        assert (tail["mask"][1:] == 255).all()
    ours.set_epoch(1)
    theirs.set_epoch(1)
    _assert_batches_equal(list(ours), list(theirs))


def test_native_dataset_matches_jax(voc):
    for contract in ("legacy", "index"):
        for raw_u8 in (False, True):
            kw = _kw(contract, raw_u8)
            ours = TN.NativeVOCSegDataset(voc, SIZE, "train", **kw)
            theirs = JN.NativeVOCSegDataset(voc, SIZE, "train", **kw)
            plain = TV.VOCSegDataset(voc, SIZE, "train", **kw)
            for i in range(len(ours)):
                got = ours[i]
                _assert_items_equal(got, theirs[i])
                ref = plain[i]
                np.testing.assert_array_equal(got[1], ref[1])
                if raw_u8:
                    np.testing.assert_array_equal(got[0], ref[0])
                else:
                    np.testing.assert_allclose(got[0], ref[0], rtol=0,
                                               atol=1e-6)


def test_native_host_kernels_match_jax():
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (5, 9, 7), dtype=np.uint8)
    np.testing.assert_array_equal(TN.normalize_batch_host(u8, 0.3, 0.2, 3),
                                  JN.normalize_batch_host(u8, 0.3, 0.2, 3))
    assert TN.normalize_batch_host(u8[:0]).shape == (0, 9, 7)
    acc = rng.normal(size=(20, 18, 2)).astype(np.float32)
    den = rng.uniform(1, 2, (20, 18, 1)).astype(np.float32)
    tile = rng.normal(size=(8, 8, 2)).astype(np.float32)
    win = rng.uniform(0, 1, (8, 8)).astype(np.float32)
    ours = (acc.copy(), den.copy())
    theirs = (acc.copy(), den.copy())
    TN.stitch_accumulate_host(*ours, tile, win, 12, 3)
    JN.stitch_accumulate_host(*theirs, tile, win, 12, 3)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="fit"):
        TN.stitch_accumulate_host(acc, den, tile, win, 13, 3)


def test_native_library_is_the_ports_own_build():
    path = TN.lib()._name
    build = os.path.join(os.path.dirname(TN.__file__), "..", "_build")
    assert os.path.samefile(os.path.dirname(os.path.dirname(path)), build)
    assert TN.SOURCE.parent.name == "csrc"
    assert TN.SOURCE.parent.parent.name == "insarseg_torch"


def test_native_build_failure_raises(tmp_path, monkeypatch, voc):
    bad = tmp_path / "tileops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "SOURCE", bad)
    monkeypatch.setattr(TN, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(TN, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TN.NativeVOCSegDataset(voc, SIZE, "train")
    # no half-built directory is left behind
    assert not any((tmp_path / "build").iterdir())


def test_prefetch_loader(voc):
    loader = TV.BatchLoader(TV.VOCSegDataset(voc, SIZE, "train"), 2,
                            shuffle=True, seed=1)
    pre = TN.PrefetchLoader(loader, depth=1)
    assert len(pre) == len(loader)
    pre.set_epoch(0)
    got = list(pre)
    loader.set_epoch(0)
    _assert_batches_equal(got, list(loader))

    def failing():
        yield {"n_valid": 1}
        raise OSError("disk gone")

    class Failing:
        def __iter__(self):
            return failing()

    it = iter(TN.PrefetchLoader(Failing()))
    assert next(it) == {"n_valid": 1}
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    it = iter(TN.PrefetchLoader(loader, depth=1))
    next(it)
    it.close()  # an early close ends the worker thread
