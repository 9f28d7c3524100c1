"""Build and bind the hand-written CUDA kernels: nvcc -> shared library -> ctypes.

Each source ``csrc/<name>.cu`` compiles on first use into its own shared
library with a plain C interface, under ``build/kernels/`` at the root of the
checkout.  The file name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged checkout reuses its build.  ``build()`` starts one
``nvcc`` per source, all together, and keeps each one's ``-Xptxas -v`` report
(registers, shared memory, spills) in ``PTXAS_LOG``.

Nothing here runs at import: the CPU tests import every module, and this
machine-independent part only touches ``nvcc`` when a kernel is launched on a
CUDA tensor or ``build()`` is called.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["BUILD_S", "MAX_SMEM_BYTES", "MAX_THREADS", "PTXAS_LOG", "build", "build_dir",
           "launch", "query", "suffix"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("ggr_update", "ggr_panel", "ggr_panel_factor", "ggr_apply")
_HEADERS = ("ggr_common.cuh", "ggr_scan.cuh", "ggr_warp.cuh")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# An H100 thread block may use at most 227 KB of dynamic shared memory.
MAX_SMEM_BYTES = 232448
MAX_THREADS = 1024

PTXAS_LOG: dict[str, str] = {}  # source name -> nvcc/ptxas report of its build
BUILD_S: dict[str, float] = {}  # source name -> seconds its nvcc ran (all start together)
# (tile dtype, accumulation dtype) -> the C functions' suffix, the same in
# every source: the uniform instances, the two named mixed policies (bf16 /
# f16 tiles, f32 sums) and the wide pairs (f32 / bf16 / f16 tiles, f64 sums)
_SUFFIX = {(torch.float32, torch.float32): "f32",
           (torch.float64, torch.float64): "f64",
           (torch.bfloat16, torch.float32): "bf16_f32",
           (torch.float16, torch.float32): "f16_f32",
           (torch.float32, torch.float64): "f32_f64",
           (torch.bfloat16, torch.float64): "bf16_f64",
           (torch.float16, torch.float64): "f16_f64"}
_LIBS: dict[str, ctypes.CDLL] = {}
_INT_MAX = 2**31 - 1


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout (listed in .gitignore)."""
    return _CSRC.parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in (f"{name}.cu", *_HEADERS):
        h.update((_CSRC / f).read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=_SOURCES) -> dict[str, str]:
    """Compile every named source not built yet, one ``nvcc`` each, in parallel.

    Returns ``{name: ptxas report}``; a source that was already built reports
    ``"(cached build)"``.  Each build's seconds go into ``BUILD_S``.  Raises
    ``RuntimeError`` with the compiler's output when any build fails.
    """
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = _lib_path(name)
        if path.exists():
            PTXAS_LOG.setdefault(name, "(cached build)")
            continue
        nvcc = nvcc or _nvcc()
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)

    def wait(name):
        out = procs[name][0].communicate()[0]
        BUILD_S[name] = time.perf_counter() - t0
        return out

    with ThreadPoolExecutor(max(1, len(procs))) as pool:
        outs = dict(zip(procs, pool.map(wait, procs)))
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out = PTXAS_LOG[name] = outs[name]
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: PTXAS_LOG[name] for name in names}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def suffix(tile, accum=None) -> str:
    """The suffix of the C functions for ``tile`` dtype tiles accumulating
    at ``accum`` (a torch dtype or its name; None: the tile dtype itself):
    ``"f32"``, ``"f64"``, ``"bf16_f32"``, ``"f16_f32"``, ``"f32_f64"``,
    ``"bf16_f64"``, ``"f16_f64"``.  Raises ``NotImplementedError`` naming
    both dtypes for any other pair."""
    acc = tile if accum is None else (
        getattr(torch, accum) if isinstance(accum, str) else accum)
    try:
        return _SUFFIX[(tile, acc)]
    except KeyError:
        t, a = (str(d).removeprefix("torch.") for d in (tile, acc))
        raise NotImplementedError(
            f"no CUDA kernel for {t} tiles with {a} accumulation "
            "(the kernels take float32 / float64 tiles at their own width, "
            "bfloat16 / float16 tiles with float32 accumulation and float32 / "
            "bfloat16 / float16 tiles with float64 accumulation; the plain "
            "versions run every pair on CPU tensors)") from None


def launch(source: str, fn_prefix: str, tensors, *dims: int, accum=None) -> None:
    """Launch ``<fn_prefix>_<suffix>`` of ``source`` on the current stream.

    The C function takes one pointer per tensor of ``tensors`` (CUDA tensors
    whose first holds the tiles: its dtype and ``accum`` pick the suffix,
    see ``suffix``), then the integer arguments ``dims``, the
    device index and the stream.  Raises ``ValueError`` for an integer that does not fit a C
    ``int`` and ``RuntimeError`` when the C function reports a CUDA error (a
    refused launch never runs, and a later synchronize would not report it).
    """
    if any(not -_INT_MAX <= d <= _INT_MAX for d in dims):
        raise ValueError(f"{fn_prefix}: an argument of {dims} exceeds a C int")
    x = tensors[0]
    sfx = suffix(x.dtype, accum)
    lib = _lib(source)
    fn = getattr(lib, f"{fn_prefix}_{sfx}")
    fn.argtypes = ([ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(dims)
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(*(t.data_ptr() for t in tensors), *dims, x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn_prefix}_{sfx} launch failed: "
                           f"{_error(lib, source, err)}")


def _error(lib: ctypes.CDLL, source: str, err: int) -> str:
    errstr = getattr(lib, f"{source}_error_string")
    errstr.argtypes = [ctypes.c_int]
    errstr.restype = ctypes.c_char_p
    return f"CUDA error {err} ({errstr(err).decode()})"


def query(source: str, fn_prefix: str, x: torch.Tensor, *dims: int,
          accum=None) -> int:
    """Call ``<fn_prefix>_<suffix>(*dims, device)`` of ``source`` for the
    dtype of ``x`` at ``accum`` (see ``suffix``) and x's device: a host-side
    query that returns a count >= 0, or -(CUDA error), which raises
    ``RuntimeError``."""
    sfx = suffix(x.dtype, accum)
    lib = _lib(source)
    fn = getattr(lib, f"{fn_prefix}_{sfx}")
    fn.argtypes = [ctypes.c_int] * (len(dims) + 1)
    fn.restype = ctypes.c_int
    out = fn(*dims, x.device.index)
    if out < 0:
        raise RuntimeError(f"{fn_prefix}_{sfx} failed: {_error(lib, source, -out)}")
    return out
