"""The arithmetic of the SE kernels K2 squeeze (``csrc/se_i8.cu``) and
K5b (``csrc/block_i8.cu``), emulated exactly on the CPU against their
plain versions, and the squeeze's grid (``kernels/se_i8.py::
squeeze_plan``). The kernels run only on a card; there they are held to
the plain versions (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

- K2 squeeze: each thread sums the codes of 16 channels in biased 16-bit
  lanes of u32 words (code + 128, even and odd bytes apart), flushed into
  int32 sums every FLUSH pixels. The numpy model below does the same in
  u32 arithmetic that wraps as the card's does, with the kernel's
  constant; codes +127 over more than FLUSH pixels fill a lane, so a
  missed flush shows.
- K5b: codes become floats by a byte permute under 2^23, y = q * g + idn
  in f32, y clamped to [0, RN(127 * s)], the quotient by
  ``requant_i8.cuh::div_rn`` (Markstein's correction from r = RN(1 / s)),
  and rint by adding 1.5 * 2^23. Emulated in exact rational arithmetic, it
  must give the plain version's codes on quotients at and beside the
  half-integer ties, for int8 and f32 identities, and where y is 0,
  subnormal, above the clamp or infinite.
"""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from insarseg_torch.kernels import se_residual_i8_plain, se_squeeze_i8_plain
from insarseg_torch.kernels.se_i8 import (
    _MAX_SPLITS,
    _SQUEEZE_THREADS,
    _SQUEEZE_UNROLL,
    squeeze_plan,
)
from tests.test_torch_conv_tiling import _rn32

CSRC = Path(__file__).resolve().parent.parent / "insarseg_torch" / "csrc"


def _flush_period() -> int:
    m = re.search(r"constexpr int FLUSH = (\d+);",
                  (CSRC / "se_i8.cu").read_text())
    return int(m.group(1))


def _lanes_sum(codes: np.ndarray, flush: int) -> np.ndarray:
    """One thread of the squeeze: (N, 16) int8 codes of 16 channels over N
    pixels -> the 16 int32 sums, as the kernel's add_lanes / flush_lanes
    compute them (u32 words, two 16-bit lanes each, wrapping)."""
    words = np.ascontiguousarray(codes).view(np.uint32)  # (N, 4)
    acc = np.zeros(8, np.uint32)
    tot = np.zeros(16, np.int64)
    for n, row in enumerate(words, start=1):
        with np.errstate(over="ignore"):  # u32 adds wrap, as on the card
            acc[0::2] += (row ^ np.uint32(0x80808080)) & np.uint32(0x00FF00FF)
            acc[1::2] += ((row >> np.uint32(8)) ^ np.uint32(0x00808080)) \
                & np.uint32(0x00FF00FF)
        if n % flush == 0 or n == len(words):
            for j in range(4):
                tot[4 * j] += int(acc[2 * j] & 0xFFFF)
                tot[4 * j + 2] += int(acc[2 * j] >> 16)
                tot[4 * j + 1] += int(acc[2 * j + 1] & 0xFFFF)
                tot[4 * j + 3] += int(acc[2 * j + 1] >> 16)
            acc[:] = 0
    return tot - 128 * len(words)


@pytest.mark.parametrize("kind", ["+127", "-128", "random", "alternating"])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 700])
def test_squeeze_lanes_equal_the_integer_sum(kind, n):
    rng = np.random.default_rng(n)
    if kind == "+127":
        codes = np.full((n, 16), 127, np.int8)
    elif kind == "-128":
        codes = np.full((n, 16), -128, np.int8)
    elif kind == "random":
        codes = rng.integers(-128, 128, (n, 16)).astype(np.int8)
    else:
        codes = np.where(np.arange(16) % 2, 127, -128).astype(np.int8) \
            * np.ones((n, 1), np.int8)
    flush = _flush_period()
    assert flush * 255 < 2 ** 16  # a lane holds FLUSH biased bytes
    want = codes.astype(np.int64).sum(0)
    assert np.array_equal(_lanes_sum(codes, flush), want)
    if kind == "+127" and n * 255 >= 2 ** 16:
        # a lane that took 258 or more bytes of 255 wrapped: without its
        # flush the sums are wrong
        assert not np.array_equal(_lanes_sum(codes, 2 * flush), want)


def _grid_sum(q: np.ndarray) -> np.ndarray:
    """The squeeze's grid and thread mapping (se_squeeze_i8_kernel), each
    thread's pixels summed exactly: every (pixel, channel) must be read
    once."""
    b, h, w, c = q.shape
    hw = h * w
    cg, splits, per = squeeze_plan(b, hw, c)
    nv = cg // 16
    ppi = _SQUEEZE_THREADS // nv
    x = q.reshape(b, hw, c).astype(np.int64)
    out = np.zeros((b, c), np.int64)
    seen = np.zeros((b, hw, c), np.int64)
    for bi in range(b):
        for g in range(c // cg):
            for s in range(splits):
                p0, p1 = s * per, min(hw, s * per + per)
                for lane_p in range(ppi):
                    pix = np.arange(p0 + lane_p, p1, ppi)
                    for lane_v in range(nv):
                        c0 = g * cg + lane_v * 16
                        out[bi, c0:c0 + 16] += x[bi, pix, c0:c0 + 16].sum(0)
                        seen[bi, pix, c0:c0 + 16] += 1
    assert (seen == 1).all()
    return out


@pytest.mark.parametrize("b,h,w,c", [
    (1, 1, 1, 16), (2, 3, 5, 48), (9, 7, 9, 64), (1, 5, 7, 320),
    (2, 16, 16, 2048), (1, 2, 3, 4096), (3, 40, 37, 128),
    (1, 64, 48, 128),   # batch 1: 32-channel groups, 64 splits
    (8, 16, 16, 1024), (2, 33, 31, 512), (4, 9, 70, 256), (8, 1, 1, 4096),
    (1, 30, 30, 16), (5, 2, 2, 2048)])
def test_squeeze_grid_reads_each_code_once(b, h, w, c):
    q = np.random.default_rng(c + h).integers(-128, 128, (b, h, w, c)) \
        .astype(np.int8)
    want = se_squeeze_i8_plain(torch.from_numpy(q)).numpy()
    assert np.array_equal(_grid_sum(q), want)


@pytest.mark.parametrize("b,hw,c", [(8, 256 * 512, 128), (8, 128 * 128, 256),
                                    (8, 64 * 64, 512), (8, 64 * 64, 2048),
                                    (8, 32 * 32, 1024), (1, 256 * 512, 128),
                                    (9, 1, 4096), (2, 35, 336),
                                    (1, 64 * 64, 2048), (8, 512 * 512, 64)])
def test_squeeze_plan_bounds(b, hw, c):
    cg, splits, per = squeeze_plan(b, hw, c)
    assert cg % 16 == 0 and c % cg == 0 and cg <= _SQUEEZE_THREADS
    assert 1 <= splits <= _MAX_SPLITS
    assert (splits - 1) * per < hw <= splits * per  # no block left empty
    batch = _SQUEEZE_THREADS // (cg // 16) * _SQUEEZE_UNROLL
    assert per % batch == 0  # whole batches of loads a thread
    if c % 256 == 0:
        assert cg == 256  # whole 256-byte row segments a pixel


# --- K5b ------------------------------------------------------------------

def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _codes_f32(codes: np.ndarray) -> np.ndarray:
    """codes_f32: [byte of code + 128, 0, 0, 0x4B] is 2^23 + 128 + code."""
    u = (codes.astype(np.int64) + 128).astype(np.uint32)
    return (u | np.uint32(0x4B000000)).view(np.float32) - _f32(8388736.0)


def _div_rn(y: np.ndarray, s: np.float32) -> np.ndarray:
    """requant_i8.cuh::div_rn, exactly: q0 = RN(y r), the FMA's remainder
    RN(y - q0 s) and RN(q0 + rem r), each rounded once from its exact
    rational value."""
    r = np.float32(1.0 / np.float64(s))  # RN(1 / s): innocuous via f64
    q0 = y * r
    out = []
    for a, q in zip(y, q0):
        rem = _rn32(Fraction(float(a)) - Fraction(float(q))
                    * Fraction(float(s)))
        out.append(_rn32(Fraction(float(q)) + Fraction(float(rem))
                         * Fraction(float(r))))
    return _f32(out)


def _k5b_model(q, g, idn, s) -> np.ndarray:
    """The kernel's code(): y = RN(RN(q g) + idn), clamped to
    [0, RN(127 s)] (fmaxf / fminf), div_rn, + 1.5 * 2^23, low byte."""
    y = _codes_f32(q) * g + idn
    y = np.fmin(np.fmax(y, _f32(0)), _f32(127) * s)
    t = _div_rn(y, s) + _f32(12582912.0)
    return (t.view(np.uint32) & np.uint32(0xFF)).astype(np.uint8) \
        .view(np.int8)


def test_codes_become_exact_floats():
    codes = np.arange(-128, 128).astype(np.int8)
    assert np.array_equal(_codes_f32(codes), codes.astype(np.float32))


def _plain(q, g, idn, in_s, s) -> np.ndarray:
    """se_residual_i8_plain on one pixel row of n channels per element."""
    n = q.size
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return se_residual_i8_plain(
        t(q.reshape(1, 1, 1, n)), t(g.reshape(1, n)),
        t(idn.reshape(1, 1, 1, n)), in_s, float(s)).numpy().ravel()


SCALES = [np.float32(v) for v in (0.03, 0.0173, 1 / 3, 0.7, 2.5e-4, 6.0,
                                  1e-12 / 127, 0.5)]


@pytest.mark.parametrize("s", SCALES)
def test_k5b_f32_identity_at_and_beside_ties(s):
    """y = RN(q g) + idn with idn chosen so that y lands on RN((k + 1/2) s)
    for k = 0..127, and one ulp either side; also y = 0, y < 0, subnormal
    y, y above the clamp and y infinite."""
    rng = np.random.default_rng(int(s * 1e6) % 1000)
    k = np.arange(128)
    ties = _f32((k + 0.5) * np.float64(s))
    targets = np.concatenate([ties, np.nextafter(ties, _f32(np.inf)),
                              np.nextafter(ties, _f32(-np.inf))])
    q = rng.integers(-127, 128, targets.size).astype(np.int8)
    g = _f32(rng.uniform(0, 0.05, targets.size) * s * 40)
    idn = targets - _codes_f32(q) * g  # f32: y lands on or near the target
    extra_q = np.int8([0, 5, -7, 0, 3, 0, 0, 0])
    extra_g = _f32([0, 0, s, 0, 1e30, 0, 0, 0])
    extra_i = _f32([0.0, -1.0, 0.0, 1e-40, 0.0, np.inf, 3e38, -np.inf])
    q = np.concatenate([q, extra_q])
    g = np.concatenate([g, extra_g])
    idn = np.concatenate([idn, extra_i])
    got = _k5b_model(q, g, idn, s)
    assert np.array_equal(got, _plain(q, g, idn, None, s))
    assert len(np.unique(got)) > 100  # the codes span the range


@pytest.mark.parametrize("s", [np.float32(0.5), np.float32(0.03),
                               np.float32(1 / 3)])
def test_k5b_int8_identity_at_and_beside_ties(s):
    """An int8 identity at in_s: with s a power of two, g = s / 4 and
    in_s = s / 2 every y / s is q / 4 + qi / 2 exactly, so about a quarter
    of the quotients are ties; other scales take random g and in_s."""
    rng = np.random.default_rng(7)
    qa, qi = np.meshgrid(np.arange(-127, 128), np.arange(-127, 128, 3))
    qa, qi = qa.ravel().astype(np.int8), qi.ravel().astype(np.int8)
    if s == np.float32(0.5):
        g, in_s = np.full(qa.size, s / 4, np.float32), float(s / 2)
    else:
        sel = rng.choice(qa.size, 3000, replace=False)
        qa, qi = qa[sel], qi[sel]
        g = _f32(rng.uniform(0, 2, qa.size) * s)
        in_s = float(_f32(rng.uniform(0.2, 2) * s))
    idn = _codes_f32(qi) * _f32(in_s)
    got = _k5b_model(qa, g, idn, s)
    assert np.array_equal(got, _plain(qa, g, qi, in_s, s))
    if s == np.float32(0.5):
        quot = (qa.astype(np.float64) / 4 + qi.astype(np.float64) / 2)
        assert np.sum(quot % 1 == 0.5) > 1000  # ties, both parities


def test_c_signatures_match_the_sources():
    """The ctypes argument types of every kernel entry point
    (``kernels/_lib.py``) match its C declaration in ``csrc``: a pointer
    or the stream is a void pointer, an int an int, a long long a long
    long, a float a float, a double a double. ctypes passes a wrong list
    silently wrong."""
    import ctypes

    from insarseg_torch.kernels._lib import _SIGNATURES

    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float, "double": ctypes.c_double}
    decls = {}
    for src in CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            types = []
            for p in params.split(","):
                p = " ".join(p.split()[:-1]).replace("const ", "")
                types.append(ctypes.c_void_p if p.endswith("*")
                             else kinds[p])
            decls[name] = tuple(types)
    assert set(_SIGNATURES) <= set(decls)
    for name, args in _SIGNATURES.items():
        assert tuple(args) == decls[name], name



def test_k5b_source_divides_by_no_division():
    """K5b's quotient is requant_i8.cuh's div_rn: its source has no
    __fdiv_rn (nor a '/' on floats: the only quotients left are integer
    grid sizes on the host)."""
    code = re.sub(r"//[^\n]*", "", (CSRC / "block_i8.cu").read_text())
    assert "__fdiv_rn" not in code and "div_rn(" in code
    assert '#include "requant_i8.cuh"' in code
    shared = re.sub(r"//[^\n]*", "", (CSRC / "igemm_i8.cuh").read_text())
    assert '#include "requant_i8.cuh"' in shared
    assert "__fmaf_rn" not in shared  # one copy of the division, shared
