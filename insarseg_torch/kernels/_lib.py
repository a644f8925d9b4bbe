"""Build, load and launch bookkeeping for the hand-written CUDA kernels.

The sources in ``insarseg_torch/csrc/*.cu`` are compiled with nvcc for
``sm_90a`` — one nvcc process per source, all started together — and
linked into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use into ``insarseg_torch/_build/<key>``,
where ``<key>`` hashes the sources and the flags, so an edited source
rebuilds and an unchanged one loads at once. The compiler's register and
shared-memory report (``-Xptxas -v``) is kept in ``build.log`` beside the
library.

``LAUNCHES`` counts the launches of each kernel; a wrapper adds one where
it launches its kernel and nowhere else.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
SOURCES = ("int8_conv3x3.cu", "se_i8.cu", "maxpool2x2_i8.cu", "conv_i8.cu",
           "block_i8.cu", "sa_i8.cu", "up_i8.cu", "stem_i8.cu",
           "bn_act.cu", "se_train.cu", "sa_train.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libinsarseg_kernels.so"

LAUNCHES: Dict[str, int] = {
    "int8_conv3x3_epilogue": 0,
    "se_squeeze_i8": 0,
    "se_excite_i8": 0,
    "maxpool2x2_i8": 0,
    "maxpool_exit_s2d_i8": 0,
    "sa_stats_i8": 0,
    "sa_gate_i8": 0,
    "int8_conv_epilogue": 0,
    "se_residual_i8": 0,
    "up_concat_i8": 0,
    "stem_pool_i8": 0,
    "bn_stats": 0,
    "bn_apply_relu": 0,
    "bn_relu_grad_stats": 0,
    "bn_relu_grad_apply": 0,
    "se_squeeze": 0,
    "se_excite": 0,
    "se_grad_stats": 0,
    "se_grad_apply": 0,
    "sa_pool": 0,
    "sa_apply": 0,
    "sa_grad_stats": 0,
    "sa_grad_apply": 0,
}

_vp, _i, _ll, _f, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    "insarseg_conv3x3_i8": (_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _f,
                            _i, _i, _vp),
    "insarseg_se_squeeze_i8": (_vp, _vp, _vp, _vp) + (_i,) * 6 + (_vp,),
    "insarseg_se_excite_i8": (_vp, _vp, _vp, _ll, _ll, _i, _i, _vp),
    "insarseg_maxpool2x2_i8": (_vp, _vp, _i, _i, _i, _i, _vp),
    "insarseg_maxpool_exit_s2d_i8": (_vp, _vp, _i, _i, _i, _i, _vp),
    "insarseg_sa_stats_i8": (_vp, _vp, _ll, _i, _f, _vp),
    "insarseg_sa_gate_i8": (_vp, _vp, _vp, _ll, _i, _vp),
    "insarseg_conv_i8": (_vp, _vp, _vp, _vp, _vp, _vp) + (_i,) * 12
    + (_f, _f, _i, _i, _vp),
    "insarseg_se_residual_i8": (_vp, _vp, _vp, _vp, _ll, _ll, _i, _i, _f, _f,
                                _vp),
    "insarseg_up_concat_i8": (_vp,) * 5 + (_i,) * 7 + (_f, _vp),
    "insarseg_stem_pool_i8": (_vp, _vp, _i, _i, _i, _i, _i, _f, _vp),
    "insarseg_bn_stats": (_vp,) * 5 + (_ll, _ll, _i, _i, _ll) + (_i,) * 4
    + (_vp,),
    "insarseg_bn_apply_relu": (_vp,) * 9 + (_ll, _ll, _i, _i) + (_d,) * 4
    + (_i,) * 4 + (_vp,),
    "insarseg_bn_relu_grad_stats": (_vp,) * 10 + (_ll, _ll, _i, _i, _ll, _i,
                                                  _d) + (_i,) * 4 + (_vp,),
    "insarseg_bn_relu_grad_apply": (_vp,) * 10 + (_ll, _ll, _i, _i, _d)
    + (_i,) * 4 + (_vp,),
    "insarseg_se_squeeze": (_vp,) * 6 + (_ll, _ll, _i, _i, _ll) + (_i,) * 4
    + (_vp,),
    "insarseg_se_excite": (_vp,) * 4 + (_ll, _ll, _i, _i, _ll) + (_i,) * 4
    + (_vp,),
    "insarseg_se_grad_stats": (_vp,) * 6 + (_ll, _ll, _i, _i, _ll)
    + (_i,) * 4 + (_vp,),
    "insarseg_se_grad_apply": (_vp,) * 9 + (_ll, _ll, _i, _i, _ll)
    + (_i,) * 4 + (_vp,),
    "insarseg_sa_pool": (_vp,) * 3 + (_ll, _ll) + (_i,) * 5 + (_vp,),
    "insarseg_sa_apply": (_vp,) * 3 + (_ll, _ll) + (_i,) * 5 + (_vp,),
    "insarseg_sa_grad_stats": (_vp,) * 3 + (_ll, _ll) + (_i,) * 5 + (_vp,),
    "insarseg_sa_grad_apply": (_vp,) * 7 + (_ll, _ll) + (_i,) * 5 + (_vp,),
    "insarseg_bn_kernel_info": (_i, _vp),
    "insarseg_bn_kernel_launches": (_vp,),
}

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.glob("*.cu*")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = out_dir / (Path(src).stem + ".o")
        log = open(out_dir / (Path(src).stem + ".log"), "w")
        procs.append((src, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, log, p in procs:
        if p.wait() != 0:
            failed.append(src)
        log.close()
    with open(out_dir / "build.log", "w") as out:
        for src in SOURCES:
            out.write(f"== {src}\n")
            out.write((out_dir / (Path(src).stem + ".log")).read_text())
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n"
            + (out_dir / "build.log").read_text()[-8000:])
    objs = [str(out_dir / (Path(s).stem + ".o")) for s in SOURCES]
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(out_dir / LIB_NAME), *objs],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    final = BUILD_ROOT / build_key()
    cached = (final / LIB_NAME).is_file()
    if not cached:
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
        try:
            _compile(tmp)
            try:
                os.replace(tmp, final)
            except OSError:  # another process finished the same build first
                if not (final / LIB_NAME).is_file():
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    lib = ctypes.CDLL(str(final / LIB_NAME))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.insarseg_error_string.argtypes = [ctypes.c_int]
    lib.insarseg_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, cached=cached,
                      dir=str(final), log=str(final / "build.log"))
    _lib = lib
    return lib


def launch(kernel: str, fn_name: str, *args) -> None:
    """Call one C entry point, raise on a CUDA error, count the launch."""
    lib = load_library()
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        msg = lib.insarseg_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[kernel] += 1


def device_guard(device: torch.device):
    """The context of a launch on ``device``: none when it is the current
    device already (``torch.cuda.device`` costs microseconds a call)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current stream on ``t``'s device (without making
    a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


# the codes of a float tensor's dtype in the train kernels (csrc/bn_act.cu,
# csrc/se_train.cu, csrc/sa_train.cu: F32 / BF16 / F64), and the dtype of
# their per-channel vectors (acc) for each
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
ACC = {torch.float32: torch.float32, torch.bfloat16: torch.float32,
       torch.float64: torch.float64}


def workspace(cache: Dict[Tuple[int, int], Tuple[torch.Tensor,
                                                torch.Tensor]],
              t: torch.Tensor, stream: int, n_sums: int, n_counters: int,
              min_sums: int, min_counters: int) -> Tuple[int, int]:
    """Pointers to a reduction's f64 partial sums and int32 counters on
    (t's device, stream), cached in ``cache``, grown to at least the
    sizes asked and made at least ``min_sums`` / ``min_counters`` (the
    counters zeroed: each launch's last blocks reset theirs, so they are
    zero between launches). One pair a (device, stream) stays in place
    for a later CUDA graph to capture."""
    key = (t.device.index, stream)
    sums, counters = cache.get(key, (None, None))
    if sums is None or sums.numel() < n_sums:
        sums = t.new_empty(max(n_sums, min_sums), dtype=torch.float64)
    if counters is None or counters.numel() < n_counters:
        counters = t.new_zeros(max(n_counters, min_counters),
                               dtype=torch.int32)
    cache[key] = sums, counters
    return sums.data_ptr(), counters.data_ptr()


def is_plain(name: str, t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its plain version (a CPU or meta
    tensor) rather than its kernel (a CUDA tensor); any other device
    raises."""
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def layout_of(t: torch.Tensor) -> int:
    """0 for NCHW memory, 1 for channels-last; anything else raises (a
    tensor in both, as at C = 1 or a 1x1 map, is taken as NCHW)."""
    if t.is_contiguous():
        return 0
    if t.is_contiguous(memory_format=torch.channels_last):
        return 1
    raise ValueError(f"a kernel's tensor must be NCHW or channels-last, got "
                     f"strides {tuple(t.stride())}")


def like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` in x's memory layout (a copy only when it differs)."""
    fmt = torch.channels_last if layout_of(x) else torch.contiguous_format
    return t.contiguous(memory_format=fmt)


def sizes(t: torch.Tensor):
    """(N, H * W, C) of an (N, C, H, W) tensor."""
    n, c, h, w = t.shape
    return n, h * w, c


def check_operand(name: str, label: str, v: Optional[torch.Tensor],
                  x: torch.Tensor) -> None:
    """A residual site's operand (the identity, the saved output): x's
    shape and dtype on x's card (any layout: the wrapper copies it into
    x's)."""
    if v is None:
        raise ValueError(f"{name}: the residual mode needs {label}")
    if v.shape != x.shape or v.dtype != x.dtype or v.device != x.device:
        raise ValueError(f"{name}: {label} is {tuple(v.shape)} {v.dtype} on "
                         f"{v.device}, x {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               device: torch.device) -> None:
    """The kernels take contiguous, 16-byte-aligned tensors on one card."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
